"""Streaming depth metrics (port of ``eval/metrics.py``).

Running means of abs_diff, abs_rel, sq_rel, rmse, rmse_log, abs_log and
delta^1..3 over batches, with a ``[min_depth, max_depth]`` validity clamp.
Each batch's sums are taken in fp32 over the valid pixels (static shapes:
invalid pixels weigh 0) and added to float64 accumulators on the batch's
device, so ``update`` never waits for the device; ``result`` reads them
back once.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_KEYS = ("count", "abs_diff", "abs_rel", "sq_rel", "se", "se_log", "abs_log", "d1", "d2", "d3")


def _batch_sums(pred: torch.Tensor, gt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The sums of one batch, in ``_KEYS`` order, as one fp32 vector."""
    w = valid.float()
    gt_s = torch.where(valid, gt, 1.0)
    pred_s = torch.where(valid, pred, 1.0)
    thresh = torch.maximum(gt_s / pred_s, pred_s / gt_s)
    log_diff = torch.log(gt_s) - torch.log(pred_s)
    terms = (
        torch.abs(gt_s - pred_s),
        torch.abs(gt_s - pred_s) / gt_s,
        (gt_s - pred_s) ** 2 / gt_s,
        (gt_s - pred_s) ** 2,
        log_diff**2,
        torch.abs(log_diff),
        (thresh < 1.25).float(),
        (thresh < 1.25**2).float(),
        (thresh < 1.25**3).float(),
    )
    return torch.stack([torch.clamp(w.sum(), min=1.0)] + [torch.sum(x * w) for x in terms])


class DepthMetrics:
    """Accumulate depth metrics across batches; ``result()`` finalizes."""

    def __init__(self, min_depth: float = 0.1, max_depth: float = 10.0):
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.reset()

    def reset(self) -> None:
        self._sums: Optional[torch.Tensor] = None

    def update(self, pred, gt, valid_mask=None) -> None:
        """Add a batch: ``pred`` and ``gt`` depth of one shape (tensors or
        arrays; ``pred`` moves to ``gt``'s device). A pixel counts where
        ``min_depth < gt < max_depth`` (and ``valid_mask``); ``pred`` is
        clipped to ``[min_depth, max_depth]``."""
        gt = torch.as_tensor(gt).float()
        pred = torch.as_tensor(pred).to(gt.device).float()
        valid = (gt > self.min_depth) & (gt < self.max_depth)
        if valid_mask is not None:
            valid = valid & torch.as_tensor(valid_mask).to(gt.device).bool()
        pred = torch.clamp(pred, self.min_depth, self.max_depth)
        sums = _batch_sums(pred, gt, valid).double()
        self._sums = sums if self._sums is None else self._sums + sums

    def result(self) -> Dict[str, float]:
        s = dict(zip(_KEYS, (0.0,) * len(_KEYS) if self._sums is None
                     else self._sums.tolist()))
        n = max(s["count"], 1.0)
        return {
            "abs_diff": s["abs_diff"] / n,
            "abs_rel": s["abs_rel"] / n,
            "sq_rel": s["sq_rel"] / n,
            "rmse": (s["se"] / n) ** 0.5,
            "rmse_log": (s["se_log"] / n) ** 0.5,
            "abs_log": s["abs_log"] / n,
            "delta1": s["d1"] / n,
            "delta2": s["d2"] / n,
            "delta3": s["d3"] / n,
        }
