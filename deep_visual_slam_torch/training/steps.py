"""VO evaluation step (port of ``training/steps.py:make_vo_eval_step``).

The networks run under ``torch.autocast`` in the compute dtype (bf16 in
``configs/vo.yaml``); images, the warp and the loss stay fp32, as in the JAX
package. Every reprojection map goes through kernel K1
(``ops/photometric_cuda.py``) on the card: 10 launches per step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.training import vo_learner

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
    autocast = compute_dtype != torch.float32

    def run(model: torch.nn.Module) -> Callable:
        def apply(x: torch.Tensor) -> Any:
            with torch.autocast(device.type, compute_dtype, enabled=autocast):
                return model(x)

        return apply

    def eval_step(
        batch: Dict[str, Any],
        generator: torch.Generator | None = None,
        noise: Sequence[torch.Tensor] | None = None,
    ):
        with torch.inference_mode():
            batch = _scale_uint8_images({
                k: torch.as_tensor(v, device=device).contiguous()
                for k, v in batch.items()
            })
            outputs, losses = vo_learner.process_batch(
                run(depth_model), run(pose_model), batch, cfg, generator, noise
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
