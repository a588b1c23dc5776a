"""Bilinear sampling and resizing in NHWC (port of ``ops/warp.py``).

The JAX package computes these in XLA, outside any Pallas kernel, so the
port uses PyTorch's own operators.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    align_corners: bool = True,
    padding_mode: str = "border",
) -> torch.Tensor:
    """Bilinear sampling of image [B, H, W, C] at grid [B, Ho, Wo, 2]
    ((x, y) in [-1, 1]) -> [B, Ho, Wo, C]; ``padding_mode`` "border" clamps,
    "zeros" reads 0 out of range."""
    out = F.grid_sample(
        image.permute(0, 3, 1, 2),
        grid.to(image.dtype),
        mode="bilinear",
        padding_mode=padding_mode,
        align_corners=align_corners,
    )
    return out.permute(0, 2, 3, 1).contiguous()


def resize_bilinear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False)."""
    B, H, W, C = image.shape
    if H == height and W == width:
        return image
    out = F.interpolate(
        image.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
        align_corners=False,
    )
    return out.permute(0, 2, 3, 1).contiguous()


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample, NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def resize_bilinear_align_corners(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize with corner-aligned sampling (align_corners=True), NHWC:
    what RAFT's ``upflow8`` uses. The same size returns ``image`` itself."""
    B, H, W, C = image.shape
    if H == height and W == width:
        return image
    out = F.interpolate(
        image.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
        align_corners=True,
    )
    return out.permute(0, 2, 3, 1).contiguous()
