"""VO train, stereo train and eval steps, and the supervised-depth train
and eval steps (port of ``training/steps.py``).

The networks run under ``torch.autocast`` in the compute dtype (bf16 in
``configs/vo.yaml``); images, the warp and the loss stay fp32, as in the JAX
package. Every reprojection map goes through kernel K1
(``ops/photometric_cuda.py``) on the card: per mono train step 10 forward
launches and 8 backward launches (the two identity maps carry no gradient),
per stereo step 5 and 4, per eval step 10 forward launches. The depth steps
(SILog and smoothness) launch none.

Data parallelism: given a :class:`~deep_visual_slam_torch.parallel.Mesh`
(a process group, one rank per card), each step takes the rank's rows of
the global batch and computes what one process computes on the global
batch, as the JAX mesh step does: the trained networks run under DDP with
their BatchNorm statistics taken over all ranks (``sync_batch_norm``);
the random draws of the jitter and the auto-mask noise are made for the
global batch, from generators in the same state on every rank, and each
rank takes its rows; SILog sums its terms over the ranks before the square
root; the returned losses are the ranks' means.

While tracing is on (``utils/logging.py``), the train steps record the
spans ``step`` (the whole call), ``step.input`` (the batch to the device,
the jitter, the noise), the networks' and the losses' spans of
``vo_learner`` and ``depth_learner``, ``loss.bwd`` and ``net.bwd`` (the
backward pass, split where the first gradient reaches a network's output)
and ``optimizer`` (the update).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.models.resnet import frozen_running_stats, sync_batch_norm
from deep_visual_slam_torch.parallel.collectives import pmean, psum
from deep_visual_slam_torch.parallel.mesh import Mesh
from deep_visual_slam_torch.training import depth_learner, vo_learner
from deep_visual_slam_torch.training.augment import batch_snippet_jitter, draw_jitter_factors
from deep_visual_slam_torch.training.state import TrainState
from deep_visual_slam_torch.utils import logging as tracing

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


class _Network(torch.nn.Module):
    """``model`` under autocast in ``compute_dtype``. With ``remat`` the
    forward is checkpointed: backward recomputes it, with the BatchNorm
    running statistics left alone so that they move once per step, as
    under ``jax.checkpoint``. (A module, so that DDP wraps the checkpoint
    and the recomputation does not rerun DDP's forward.)"""

    def __init__(self, model, device: torch.device, compute_dtype: torch.dtype, remat: bool):
        super().__init__()
        self.model = model
        self.device_type = device.type
        self.compute_dtype = compute_dtype
        self.remat = remat

    def _run(self, x: torch.Tensor) -> Any:
        with torch.autocast(
            self.device_type, self.compute_dtype,
            enabled=self.compute_dtype != torch.float32,
        ):
            return self.model(x)

    def forward(self, x: torch.Tensor) -> Any:
        if not self.remat:
            out = self._run(x)
        else:
            out = checkpoint(
                self._run, x, use_reentrant=False,
                context_fn=lambda: (contextlib.nullcontext(), frozen_running_stats(self.model)),
            )
        tracing.watch_gradients(out.values() if isinstance(out, dict) else out)
        return out


def _backward(loss: torch.Tensor) -> None:
    """``loss.backward()`` in the spans ``loss.bwd`` and ``net.bwd``, split
    where the first gradient reaches a network's output."""
    with tracing.split_span("loss.bwd", "net.bwd"):
        loss.backward()


def _network(
    model: torch.nn.Module,
    device: torch.device,
    compute_dtype: torch.dtype,
    remat: bool = False,
    mesh: Mesh | None = None,
) -> Callable:
    """The network a train step calls: :class:`_Network`, and under a mesh
    that wrapped in DDP with ``model``'s BatchNorm synced over the ranks.
    Buffers are not broadcast: the synced statistics are equal on every
    rank."""
    net = _Network(model, device, compute_dtype, remat)
    if mesh is None:
        return net
    sync_batch_norm(model)
    return DistributedDataParallel(
        net, device_ids=[mesh.device.index] if mesh.device.type == "cuda" else None,
        broadcast_buffers=False,
    )


def _rank_mean(losses: Dict[str, torch.Tensor], mesh: Mesh | None) -> Dict[str, torch.Tensor]:
    """The losses (detached), averaged over the ranks in one all-reduce."""
    losses = {k: v.detach() for k, v in losses.items()}
    if mesh is None:
        return losses
    keys = list(losses)
    mean = pmean(torch.stack([losses[k].float() for k in keys]))
    return dict(zip(keys, mean.unbind()))


def _global_noise(
    mesh: Mesh | None, cfg: vo_learner.VOLossConfig, shape, generator, device
) -> List[torch.Tensor] | None:
    """Under a mesh, the auto-mask noise of the global batch (``shape`` is
    the rank's [b, H, W, C]) drawn per scale as one process draws it, and
    this rank's rows of it; None otherwise (the loss draws its own)."""
    if mesh is None or not cfg.auto_mask:
        return None
    b = shape[0]
    rows = mesh.rows(b * mesh.world)
    return [
        torch.randn((b * mesh.world, *shape[1:]), generator=generator, device=device)[rows]
        for _ in range(cfg.num_scales)
    ]


def make_vo_train_step(
    depth_model: torch.nn.Module,
    pose_model: torch.nn.Module,
    cfg: vo_learner.VOLossConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
    device_augment: bool = False,
    accum_steps: int = 1,
    device=None,
    mesh: Mesh | None = None,
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
    the whole batch (microbatch i takes its rows). Under ``mesh`` the batch
    (and ``noise``) are the rank's rows of the global batch.
    """
    device = resolve_device(device)
    depth_model.to(device).train()
    pose_model.to(device).train()
    depth_net = _network(depth_model, device, compute_dtype, remat, mesh)
    pose_net = _network(pose_model, device, compute_dtype, mesh=mesh)

    def train_step(
        state: TrainState,
        batch: Dict[str, Any],
        generator: torch.Generator | None = None,
        noise: Sequence[torch.Tensor] | None = None,
    ) -> Dict[str, torch.Tensor]:
        with tracing.span("step"):
            with tracing.span("step.input"):
                batch = _to_device(batch, device)
                B = batch["target_image"].shape[0]
                if device_augment:
                    factors = None
                    if mesh is not None:
                        rows = mesh.rows(B * mesh.world)
                        factors = [f[rows] for f in
                                   draw_jitter_factors(B * mesh.world, generator, device)]
                    batch = batch_snippet_jitter(batch, generator, factors)
                if noise is None:
                    noise = _global_noise(mesh, cfg, (B, *batch["target_image"].shape[1:3], 2),
                                          generator, device)
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
                _backward(micro["loss"] / accum_steps)
                for k, v in micro.items():
                    losses[k] = losses.get(k, 0.0) + v.detach() / accum_steps
            with tracing.span("optimizer"):
                losses["grad_norm"] = state.apply_gradients()
            return _rank_mean(losses, mesh)

    return train_step


def make_stereo_train_step(
    depth_model: torch.nn.Module,
    cfg: vo_learner.VOLossConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    mesh: Mesh | None = None,
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
    Under ``mesh`` only DepthNet runs under DDP: PoseNet takes no part.
    """
    device = resolve_device(device)
    depth_model.to(device).train()
    depth_net = _network(depth_model, device, compute_dtype, mesh=mesh)

    def train_step(
        state: TrainState,
        batch: Dict[str, Any],
        generator: torch.Generator | None = None,
        noise: Sequence[torch.Tensor] | None = None,
    ) -> Dict[str, torch.Tensor]:
        batch = _to_device(batch, device)
        if noise is None:
            noise = _global_noise(mesh, cfg, (*batch["target_image"].shape[:3], 1),
                                  generator, device)
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
        return _rank_mean(losses, mesh)

    return train_step


def make_vo_eval_step(
    depth_model: torch.nn.Module,
    pose_model: torch.nn.Module,
    cfg: vo_learner.VOLossConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    mesh: Mesh | None = None,
) -> Callable[..., Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]]:
    """Returns ``eval_step(batch, generator=None, noise=None) -> (keep,
    losses)``, the JAX step's outputs, with frozen BatchNorm and no gradient.
    Under ``mesh``, ``keep`` holds the rank's rows and the losses are the
    global batch's.

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
        batch = _to_device(batch, device)
        if noise is None:
            noise = _global_noise(mesh, cfg, (*batch["target_image"].shape[:3], 2),
                                  generator, device)
        with torch.inference_mode():
            outputs, losses = vo_learner.process_batch(
                depth_net, pose_net, batch, cfg, generator, noise
            )
        keep = {
            "disp_0": outputs[("disp", 0)],
            "depth_0": outputs[("depth", 0)],
            "cam_T_cam_left": outputs[("cam_T_cam", 0, -1)],
            "cam_T_cam_right": outputs[("cam_T_cam", 0, 1)],
            "color_left_0": outputs[("color", -1, 0)],
            "color_right_0": outputs[("color", 1, 0)],
        }
        return keep, _rank_mean(losses, mesh)

    return eval_step


def make_depth_train_step(
    depth_model: torch.nn.Module,
    cfg: depth_learner.DepthLossConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    mesh: Mesh | None = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``train_step(state, batch) -> losses`` (``loss``, ``silog``,
    ``smooth``): one optimizer update of ``state`` (a :class:`TrainState`
    over ``depth_model`` alone) on a batch of ``image``, ``depth`` and
    ``valid_mask``. The model moves to ``device`` (``None`` -> CUDA) in
    train mode (batch statistics, the running statistics moved by flax's
    rule); the batch is copied there per call. Autocast covers the network
    only; the loss is fp32. Under ``mesh`` SILog is the global batch's: its
    sums go through a differentiable all-reduce, whose backward sums the
    ranks' gradients, which DDP's average over the ranks then undoes."""
    device = resolve_device(device)
    depth_model.to(device).train()
    depth_net = _network(depth_model, device, compute_dtype, mesh=mesh)
    reduce = psum if mesh is not None else None

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        with tracing.span("step"):
            with tracing.span("step.input"):
                batch = _to_device(batch, device)
            state.optimizer.zero_grad(set_to_none=True)
            total, losses, _ = depth_learner.forward_step(depth_net, batch, cfg, reduce)
            _backward(total)
            with tracing.span("optimizer"):
                state.apply_gradients()
            return _rank_mean(losses, mesh)

    return train_step


def make_depth_eval_step(
    depth_model: torch.nn.Module,
    cfg: depth_learner.DepthLossConfig,
    compute_dtype: torch.dtype = torch.bfloat16,
    device=None,
    mesh: Mesh | None = None,
) -> Callable[..., Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Returns ``eval_step(batch) -> (losses, depth)``: the losses and the
    predicted depth at scale 0 ([B, H, W, 1] fp32) with frozen BatchNorm
    and no gradient. The model moves to ``device`` (``None`` -> CUDA) in
    eval mode. Under ``mesh`` the losses are the global batch's and the
    depth the rank's rows."""
    device = resolve_device(device)
    depth_model.to(device).eval()
    depth_net = _network(depth_model, device, compute_dtype)
    reduce = psum if mesh is not None else None

    def eval_step(batch: Dict[str, Any]):
        with torch.inference_mode():
            _, losses, preds = depth_learner.forward_step(
                depth_net, _to_device(batch, device), cfg, reduce
            )
        return _rank_mean(losses, mesh), preds[0]

    return eval_step
