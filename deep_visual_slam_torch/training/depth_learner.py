"""Supervised metric-depth loss: SILog plus edge-aware smoothness (port of
``training/depth_learner.py``).

Per scale, the predicted depth is upsampled to the label's resolution
(bilinear, half-pixel centres), then SILog (variance focus 0.85) over the
valid pixels and the smoothness of the mean-normalized depth are weighted
by the scale's alpha (1, 0.5, 0.25, 0.125); the total is ``silog_weight *
silog + smooth_weight * smooth``. All of it in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from deep_visual_slam_torch.ops.depth import disp_to_depth, silog_loss
from deep_visual_slam_torch.ops.photometric import smooth_loss
from deep_visual_slam_torch.ops.warp import resize_bilinear


@dataclass(frozen=True)
class DepthLossConfig:
    num_scales: int = 4
    min_depth: float = 0.1
    max_depth: float = 10.0
    alphas: Tuple[float, ...] = (1.0, 0.5, 0.25, 0.125)
    smooth_weight: float = 0.1
    silog_weight: float = 1.0
    variance_focus: float = 0.85

    @classmethod
    def from_config(cls, config: dict) -> "DepthLossConfig":
        t = config["Train"]
        return cls(
            min_depth=t["min_depth"],
            max_depth=t["max_depth"],
            smooth_weight=t.get("smooth_weight", 0.1),
            silog_weight=t.get("silog_weight", 1.0),
        )


def _normalized_smooth(depth: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Smoothness of ``depth / max(mean(depth), 1e-7)`` (the mean per image).
    Not the VO loss's normalization (``ops/photometric.py``), which clamps
    the mean at 1e-3 and adds 1e-7."""
    mean = torch.clamp(depth.mean(dim=(1, 2), keepdim=True), min=1e-7)
    return smooth_loss(depth / mean, img)


def multi_scale_loss(
    pred_depths: List[torch.Tensor],
    gt_depth: torch.Tensor,
    rgb: torch.Tensor,
    valid_mask: torch.Tensor,
    cfg: DepthLossConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(total, silog, smooth)``, each weighted over the scales."""
    H, W = gt_depth.shape[1:3]
    total_smooth = 0.0
    total_silog = 0.0
    for pred, alpha in zip(pred_depths, cfg.alphas):
        pred_up = resize_bilinear(pred, H, W)
        total_smooth = total_smooth + alpha * _normalized_smooth(pred_up, rgb)
        total_silog = total_silog + alpha * silog_loss(
            pred_up, gt_depth, valid_mask, cfg.variance_focus
        )
    total = cfg.silog_weight * total_silog + cfg.smooth_weight * total_smooth
    return total, total_silog, total_smooth


def forward_step(
    depth_net: Callable[[torch.Tensor], Dict],
    sample: Dict[str, torch.Tensor],
    cfg: DepthLossConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """Forward and loss of ``sample`` (``image`` [B, H, W, 3], ``depth`` and
    ``valid_mask`` [B, H, W, 1] or [B, H, W]) through ``depth_net`` (the
    network, in the mode and dtype the caller chose). Returns ``(total,
    {"loss", "silog", "smooth"}, depth per scale)``."""
    rgb = sample["image"]
    gt = sample["depth"]
    valid = sample["valid_mask"]
    if gt.dim() == 3:
        gt = gt[..., None]
    if valid.dim() == 3:
        valid = valid[..., None]

    outputs = depth_net(rgb)
    pred_depths = [
        disp_to_depth(outputs[("disp", s)].float(), cfg.min_depth, cfg.max_depth)[1]
        for s in range(cfg.num_scales)
    ]
    total, silog, smooth = multi_scale_loss(pred_depths, gt, rgb, valid, cfg)
    return total, {"loss": total, "silog": silog, "smooth": smooth}, pred_depths
