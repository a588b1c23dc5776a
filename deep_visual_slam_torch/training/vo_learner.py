"""Self-supervised VO loss core, Monodepth2-style (port of
``training/vo_learner.py``).

Plain functions over NHWC batches. ``depth_net(image[B, H, W, 3])`` returns
``{("disp", s): [B, H/2^s, W/2^s, 1]}`` and ``pose_net(pair[B, H, W, 6])``
returns ``(axisangle, translation)`` of shape [B, 1, 1, 3]; the eval step
(``training/steps.py``) adapts the NCHW modules to these callables.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from deep_visual_slam_torch.ops import (
    backproject,
    disp_to_depth,
    grid_sample,
    project,
    reprojection_loss,
    resize_bilinear,
    transformation_from_parameters,
)
from deep_visual_slam_torch.ops.photometric import normalized_smooth_loss


@dataclass(frozen=True)
class VOLossConfig:
    """Hyperparameters, defaults = reference ``vo/config.yaml:33-48``."""

    num_scales: int = 4
    min_depth: float = 0.1
    max_depth: float = 10.0
    ssim_ratio: float = 0.85
    smoothness_ratio: float = 1e-3
    auto_mask: bool = True
    # D3VO Eq.5: the DepthNet ("unc", 0) sigma head divides the
    # min-reprojection residual and pays a +log(sigma) regularizer.
    uncertainty: bool = False

    @classmethod
    def from_config(cls, config: dict) -> "VOLossConfig":
        t = config["Train"]
        return cls(
            num_scales=t.get("num_scale", 4),
            min_depth=t["min_depth"],
            max_depth=t["max_depth"],
            ssim_ratio=t["ssim_ratio"],
            smoothness_ratio=t["smoothness_ratio"],
            auto_mask=t.get("auto_mask", True),
            uncertainty=t.get("predict_uncertainty", False),
        )


def predict_poses(
    pose_net: Callable, batch: Dict[str, torch.Tensor]
) -> Dict[Any, torch.Tensor]:
    """PoseNet on the (left, target) and (target, right) pairs, both in one
    batched forward; left->target is predicted forward then inverted."""
    left = batch["source_left"]
    target = batch["target_image"]
    right = batch["source_right"]
    B = target.shape[0]

    pairs = torch.cat(
        [torch.cat([left, target], dim=-1), torch.cat([target, right], dim=-1)],
        dim=0,
    )  # [2B, H, W, 6]
    axisangle, translation = pose_net(pairs)
    aa = axisangle[:, 0, 0, :]
    t = translation[:, 0, 0, :]
    return {
        ("axisangle", 0, -1): axisangle[:B],
        ("translation", 0, -1): translation[:B],
        ("axisangle", 0, 1): axisangle[B:],
        ("translation", 0, 1): translation[B:],
        ("cam_T_cam", 0, -1): transformation_from_parameters(
            aa[:B], t[:B], invert=True
        ),
        ("cam_T_cam", 0, 1): transformation_from_parameters(
            aa[B:], t[B:], invert=False
        ),
    }


def generate_images_pred(
    batch: Dict[str, torch.Tensor],
    outputs: Dict[Any, torch.Tensor],
    cfg: VOLossConfig,
) -> None:
    """Per scale: upsample the disparity to full resolution, backproject,
    move by each source pose, project and bilinearly warp the source."""
    target = batch["target_image"]
    _, H, W, _ = target.shape
    K = batch["K"]
    inv_K = batch["inv_K"]

    for scale in range(cfg.num_scales):
        disp_up = resize_bilinear(outputs[("disp", scale)], H, W)
        outputs[("disp_up", scale)] = disp_up
        _, depth = disp_to_depth(disp_up, cfg.min_depth, cfg.max_depth)
        outputs[("depth", scale)] = depth

        cam_points = backproject(depth, inv_K)
        for frame_id, source in (
            (-1, batch["source_left"]), (1, batch["source_right"])
        ):
            grid = project(cam_points, K, outputs[("cam_T_cam", 0, frame_id)])
            outputs[("sample", frame_id, scale)] = grid
            outputs[("color", frame_id, scale)] = grid_sample(
                source, grid, align_corners=True, padding_mode="border"
            )


def compute_losses(
    batch: Dict[str, torch.Tensor],
    outputs: Dict[Any, torch.Tensor],
    cfg: VOLossConfig,
    generator: torch.Generator | None = None,
    noise: Sequence[torch.Tensor] | None = None,
) -> Dict[str, torch.Tensor]:
    """Min-reprojection auto-masked loss + smoothness over all scales.

    The auto-mask tie-break adds ``1e-5 * noise[scale]`` to the identity
    maps, ``noise[scale]`` a standard normal [B, H, W, 2]: drawn from
    ``generator`` unless ``noise`` hands in one tensor per scale.
    """
    target = batch["target_image"]
    losses: Dict[str, torch.Tensor] = {}
    total_loss = 0.0

    # Identity reprojection maps are scale-independent: compute once.
    identity = torch.cat(
        [
            reprojection_loss(batch["source_left"], target, cfg.ssim_ratio),
            reprojection_loss(batch["source_right"], target, cfg.ssim_ratio),
        ],
        dim=-1,
    )  # [B, H, W, 2]

    for scale in range(cfg.num_scales):
        reproj = torch.cat(
            [
                reprojection_loss(
                    outputs[("color", -1, scale)], target, cfg.ssim_ratio
                ),
                reprojection_loss(
                    outputs[("color", 1, scale)], target, cfg.ssim_ratio
                ),
            ],
            dim=-1,
        )  # [B, H, W, 2]

        if cfg.auto_mask:
            if noise is None:
                draw = torch.randn(
                    identity.shape, generator=generator, device=identity.device
                )
            else:
                draw = noise[scale].to(identity.device)
            combined = torch.cat([identity + draw * 1e-5, reproj], dim=-1)
            to_optimise, idxs = torch.min(combined, dim=-1, keepdim=True)
            outputs[f"identity_selection/{scale}"] = (
                idxs >= identity.shape[-1]
            ).float()
        else:
            to_optimise = torch.min(reproj, dim=-1, keepdim=True).values

        if cfg.uncertainty:
            # D3VO Eq.5 on the auto-masked min-reprojection term; +0.01
            # floors the sigmoid sigma so the quotient stays bounded.
            sigma = outputs[("unc", 0)] + 0.01
            loss = torch.mean(to_optimise / sigma) + torch.mean(torch.log(sigma))
        else:
            loss = torch.mean(to_optimise)
        smooth = normalized_smooth_loss(outputs[("disp_up", scale)], target)
        loss = loss + cfg.smoothness_ratio * smooth / (2**scale)

        total_loss = total_loss + loss
        losses[f"loss/{scale}"] = loss

    losses["loss"] = total_loss / cfg.num_scales
    return losses


def process_batch(
    depth_net: Callable,
    pose_net: Callable,
    batch: Dict[str, torch.Tensor],
    cfg: VOLossConfig,
    generator: torch.Generator | None = None,
    noise: Sequence[torch.Tensor] | None = None,
) -> Tuple[Dict[Any, torch.Tensor], Dict[str, torch.Tensor]]:
    """Full VO forward + loss (reference ``vo/learner_new.py:76-105``)."""
    outputs = dict(depth_net(batch["target_image"]))
    outputs.update(predict_poses(pose_net, batch))
    generate_images_pred(batch, outputs, cfg)
    losses = compute_losses(batch, outputs, cfg, generator, noise)
    return outputs, losses
