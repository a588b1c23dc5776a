"""Disparity/depth conversions, depth error metrics and the SILog loss
(port of ``ops/depth.py``).

The masked forms keep static shapes: invalid pixels are neutralized by a
weighted mean instead of being gathered out, and everything is fp32
whatever dtype the network ran in.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def disp_to_depth(
    disp: torch.Tensor, min_depth: float, max_depth: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid disparity in [0, 1] -> (scaled_disp, depth in [min, max])."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    depth = 1.0 / scaled_disp
    return scaled_disp, depth


def depth_to_disp(depth: torch.Tensor, min_depth: float, max_depth: float) -> torch.Tensor:
    """Inverse of :func:`disp_to_depth` (depth back to sigmoid units)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = 1.0 / depth
    return (scaled_disp - min_disp) / (max_disp - min_disp)


def _errors(gt, pred, mean) -> Dict[str, torch.Tensor]:
    thresh = torch.maximum(gt / pred, pred / gt)
    log_d = torch.log(gt) - torch.log(pred)
    return {
        "abs_rel": mean(torch.abs(gt - pred) / gt),
        "sq_rel": mean((gt - pred) ** 2 / gt),
        "rmse": torch.sqrt(mean((gt - pred) ** 2)),
        "rmse_log": torch.sqrt(mean(log_d**2)),
        "a1": mean((thresh < 1.25).float()),
        "a2": mean((thresh < 1.25**2).float()),
        "a3": mean((thresh < 1.25**3).float()),
    }


def compute_depth_errors(gt: torch.Tensor, pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The seven standard depth metrics (abs_rel, sq_rel, rmse, rmse_log,
    a1, a2, a3) over already-masked values."""
    return _errors(gt.float(), pred.float(), torch.mean)


def masked_depth_errors(
    gt: torch.Tensor, pred: torch.Tensor, valid: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """:func:`compute_depth_errors` over the pixels where ``valid``, as a
    weighted mean over the whole tensor (invalid pixels read 1 and weigh
    0)."""
    valid = valid.bool()
    w = valid.float()
    n = torch.clamp(w.sum(), min=1.0)
    gt_safe = torch.where(valid, gt.float(), 1.0)
    pred_safe = torch.where(valid, pred.float(), 1.0)
    return _errors(gt_safe, pred_safe, lambda x: torch.sum(x * w) / n)


def silog_loss(
    prediction: torch.Tensor,
    target: torch.Tensor,
    valid_mask: torch.Tensor,
    variance_focus: float = 0.85,
) -> torch.Tensor:
    """Scale-invariant log loss over the valid pixels:
    ``sqrt(max(mean(d^2) - variance_focus * mean(d)^2, 1e-6))`` with
    ``d = log(max(pred, 1e-6)) - log(max(gt, 1e-6))``."""
    eps = 1e-6
    pred = torch.clamp(prediction.float(), min=eps)
    tgt = torch.clamp(target.float(), min=eps)
    valid_mask = valid_mask.bool()
    n = torch.clamp(valid_mask.float().sum(), min=1.0)
    d = torch.where(valid_mask, torch.log(pred) - torch.log(tgt), 0.0)
    d2_mean = torch.sum(d * d) / n
    d_mean = torch.sum(d) / n
    silog = d2_mean - variance_focus * d_mean * d_mean
    return torch.sqrt(torch.clamp(silog, min=eps))
