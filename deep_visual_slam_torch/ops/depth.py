"""Disparity/depth conversion (port of ``ops/depth.py``)."""

from __future__ import annotations

from typing import Tuple

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
