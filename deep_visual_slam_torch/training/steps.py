"""VO train, stereo train and eval steps (port of ``training/steps.py``).

The networks run under ``torch.autocast`` in the compute dtype (bf16 in
``configs/vo.yaml``); images, the warp and the loss stay fp32, as in the JAX
package. Every reprojection map goes through kernel K1
(``ops/photometric_cuda.py``) on the card: per mono train step 10 forward
launches and 8 backward launches (the two identity maps carry no gradient),
per stereo step 5 and 4, per eval step 10 forward launches.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.models.resnet import frozen_running_stats
from deep_visual_slam_torch.training import vo_learner
from deep_visual_slam_torch.training.augment import batch_snippet_jitter
from deep_visual_slam_torch.training.state import TrainState

# Image planes that may arrive as uint8 (snippet triplet + stereo pair).
_IMAGE_KEYS = ("source_left", "target_image", "source_right", "source_image")


def _scale_uint8_images(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """uint8 image planes -> fp32 / 255 on the device; float planes pass."""
    out = dict(batch)
    for k in _IMAGE_KEYS:
        v = out.get(k)
        if v is not None and v.dtype == torch.uint8:
            out[k] = v.float() / 255.0
    return out


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch (tensors or numpy arrays, any strides) copied to
    ``device``, contiguous, uint8 images scaled to fp32."""
    return _scale_uint8_images({
        k: torch.as_tensor(v, device=device).contiguous() for k, v in batch.items()
    })


def _network(
    model: torch.nn.Module,
    device: torch.device,
    compute_dtype: torch.dtype,
    remat: bool = False,
) -> Callable:
    """``model`` under autocast in ``compute_dtype``. With ``remat`` the
    forward is checkpointed: backward recomputes it, with the BatchNorm
    running statistics left alone so that they move once per step, as
    under ``jax.checkpoint``."""

    def forward(x: torch.Tensor) -> Any:
        with torch.autocast(
            device.type, compute_dtype, enabled=compute_dtype != torch.float32
        ):
            return model(x)

    if not remat:
        return forward

    def recompute_contexts():
        return contextlib.nullcontext(), frozen_running_stats(model)

    return lambda x: checkpoint(
        forward, x, use_reentrant=False, context_fn=recompute_contexts
    )


def make_vo_train_step(
    depth_model: torch.nn.Module,
    pose_model: torch.nn.Module,
    cfg: vo_learner.VOLossConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
    device_augment: bool = False,
    accum_steps: int = 1,
    device=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``train_step(state, batch, generator=None, noise=None) ->
    losses``: one optimizer update of ``state`` (a :class:`TrainState` over
    these two models), with the JAX step's losses and ``grad_norm``, the
    global norm of the gradient before clipping.

    The models move to ``device`` (``None`` -> CUDA) in train mode; the batch
    is copied there per call. ``remat`` checkpoints the DepthNet forward.
    ``device_augment`` color-jitters the snippet first, with factors drawn
    from ``generator``. ``accum_steps`` splits the batch into microbatches
    of B/accum_steps on the leading axis: their gradients are averaged, the
    BatchNorm statistics move once per microbatch in order, and one update
    is applied. The auto-mask tie-break noise is drawn from ``generator``
    unless ``noise`` hands in one standard normal [B, H, W, 2] per scale for
    the whole batch (microbatch i takes its rows).
    """
    device = resolve_device(device)
    depth_model.to(device).train()
    pose_model.to(device).train()
    depth_net = _network(depth_model, device, compute_dtype, remat)
    pose_net = _network(pose_model, device, compute_dtype)

    def train_step(
        state: TrainState,
        batch: Dict[str, Any],
        generator: torch.Generator | None = None,
        noise: Sequence[torch.Tensor] | None = None,
    ) -> Dict[str, torch.Tensor]:
        batch = _to_device(batch, device)
        if device_augment:
            batch = batch_snippet_jitter(batch, generator)
        B = batch["target_image"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} does not split into {accum_steps} microbatches")
        b = B // accum_steps
        state.optimizer.zero_grad(set_to_none=True)
        losses: Dict[str, torch.Tensor] = {}
        for i in range(accum_steps):
            rows = slice(i * b, (i + 1) * b)
            _, micro = vo_learner.process_batch(
                depth_net, pose_net, {k: v[rows] for k, v in batch.items()}, cfg,
                generator, None if noise is None else [n[rows] for n in noise],
            )
            (micro["loss"] / accum_steps).backward()
            for k, v in micro.items():
                losses[k] = losses.get(k, 0.0) + v.detach() / accum_steps
        losses["grad_norm"] = state.apply_gradients()
        return losses

    return train_step


def make_stereo_train_step(
    depth_model: torch.nn.Module,
    cfg: vo_learner.VOLossConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``train_step(state, batch, generator=None, noise=None) ->
    losses`` for a stereo pair at its known baseline
    (:func:`vo_learner.process_stereo_batch`), on the same
    :class:`TrainState` as the mono step.

    The update runs over both networks, PoseNet's gradient being zero, and
    then PoseNet's parameters and Adam moments are put back: zero gradients
    alone would still move them along the old momentum. The update count
    advances for all parameters, PoseNet's included, as the JAX package's
    global Adam and schedule counts do, so later bias corrections agree.
    """
    device = resolve_device(device)
    depth_model.to(device).train()
    depth_net = _network(depth_model, device, compute_dtype)

    def train_step(
        state: TrainState,
        batch: Dict[str, Any],
        generator: torch.Generator | None = None,
        noise: Sequence[torch.Tensor] | None = None,
    ) -> Dict[str, torch.Tensor]:
        batch = _to_device(batch, device)
        state.optimizer.zero_grad(set_to_none=True)
        _, losses = vo_learner.process_stereo_batch(
            depth_net, batch, cfg, generator, noise
        )
        losses["loss"].backward()
        pose = list(state.pose_model.parameters())
        kept = [
            (p.detach().clone(),
             {k: v.clone() for k, v in state.optimizer.state[p].items() if k != "step"})
            for p in pose
        ]
        state.apply_gradients()
        with torch.no_grad():
            for p, (value, moments) in zip(pose, kept):
                p.copy_(value)
                for k, v in moments.items():
                    state.optimizer.state[p][k].copy_(v)
        return {k: v.detach() for k, v in losses.items()}

    return train_step


def make_vo_eval_step(
    depth_model: torch.nn.Module,
    pose_model: torch.nn.Module,
    cfg: vo_learner.VOLossConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
) -> Callable[..., Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """Returns ``eval_step(batch, generator=None, noise=None) -> (keep,
    losses)``, the JAX step's outputs, with frozen BatchNorm and no gradient.

    The models move to ``device`` (``None`` -> CUDA) in eval mode; the
    batch (tensors or numpy arrays, images fp32 or uint8, any strides) is
    copied there, contiguous, per call. ``generator``/``noise`` feed the auto-mask tie-break noise
    (:func:`vo_learner.compute_losses`).
    """
    device = resolve_device(device)
    depth_model.to(device).eval()
    pose_model.to(device).eval()
    depth_net = _network(depth_model, device, compute_dtype)
    pose_net = _network(pose_model, device, compute_dtype)

    def eval_step(
        batch: Dict[str, Any],
        generator: torch.Generator | None = None,
        noise: Sequence[torch.Tensor] | None = None,
    ):
        with torch.inference_mode():
            outputs, losses = vo_learner.process_batch(
                depth_net, pose_net, _to_device(batch, device), cfg, generator, noise
            )
        keep = {
            "disp_0": outputs[("disp", 0)],
            "depth_0": outputs[("depth", 0)],
            "cam_T_cam_left": outputs[("cam_T_cam", 0, -1)],
            "cam_T_cam_right": outputs[("cam_T_cam", 0, 1)],
            "color_left_0": outputs[("color", -1, 0)],
            "color_right_0": outputs[("color", 1, 0)],
        }
        return keep, losses

    return eval_step
