"""RAFT correlation: the all-pairs pyramid and its windowed lookup (port of
``ops/pallas/correlation.py``), NHWC.

Two forms, as in the JAX package:

- dense: the all-pairs volume ``<f1, f2> / sqrt(D)`` of every pixel pair,
  average-pooled into levels, then sampled bilinearly in a window around
  each pixel's target (the reference's ``CorrBlock``). The volume is one
  matrix product, which the JAX package leaves to XLA: here ``torch.matmul``,
  and the lookup is ``grid_sample``.
- lazy (``memory_efficient=True``): fmap1 and the pooled fmap2 levels only;
  each lookup computes the window's correlations on demand (the reference's
  ``alt_cuda_corr``). Correlation is linear in fmap2, so both forms give the
  same values up to rounding. On CUDA tensors the lazy lookup is kernel K2
  (``csrc/correlation.cu`` via :mod:`.correlation_cuda`); the plain version
  below serves CPU tensors only.
"""

from __future__ import annotations

import math
from typing import List

import torch

from deep_visual_slam_torch.ops import correlation_cuda
from deep_visual_slam_torch.ops.warp import grid_sample


def _avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, NHWC; an odd trailing row or column is
    dropped (``avg_pool2d``'s floor: 60x80 -> 30x40 -> 15x20 -> 7x10)."""
    B, H, W, C = x.shape
    x = x[:, : (H // 2) * 2, : (W // 2) * 2, :]
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def build_corr_pyramid(
    fmap1: torch.Tensor,
    fmap2: torch.Tensor,
    num_levels: int = 4,
    memory_efficient: bool = False,
):
    """What the lookup needs, from fmaps [B, H, W, D].

    dense: ``("dense", (B, H1, W1), levels)``, the all-pairs volume's levels
    [B*H1*W1, H2/2^i, W2/2^i, 1], scaled by 1/sqrt(D).
    lazy: ``("lazy", fmap1, f2_levels)``, fmap2 and its pooled levels.
    """
    if memory_efficient:
        f2_levels = [fmap2]
        for _ in range(num_levels - 1):
            f2_levels.append(_avg_pool_2x(f2_levels[-1]))
        return ("lazy", fmap1, f2_levels)

    B, H1, W1, D = fmap1.shape
    H2, W2 = fmap2.shape[1:3]
    corr = torch.matmul(
        fmap1.reshape(B, H1 * W1, D), fmap2.reshape(B, H2 * W2, D).transpose(1, 2)
    ) / math.sqrt(D)
    levels = [corr.reshape(B * H1 * W1, H2, W2, 1)]
    for _ in range(num_levels - 1):
        levels.append(_avg_pool_2x(levels[-1]))
    return ("dense", (B, H1, W1), levels)


def _window_deltas(radius: int, device=None) -> torch.Tensor:
    """[(2r+1)^2, 2] (dx, dy) offsets in the reference's channel order.

    RAFT adds ``stack(meshgrid(dy, dx), -1)`` to an (x, y) centroid, so the
    first window axis offsets x: flat channel ``i*win + j`` samples offset
    ``(dx=d_i, dy=d_j)`` (x-major). Converted checkpoints' 1x1 motion-encoder
    weights line up channel for channel only in this order.
    """
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    dx, dy = torch.meshgrid(d, d, indexing="ij")  # dx varies along axis 0
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], dim=-1)


def _normalize_coords(coords: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pixels -> [-1, 1] with align_corners=True. On a level 1 pixel wide
    (or high) every tap lands on index 0 of that axis: ``grid_sample``
    scales the normalized coordinate back by ``w - 1 = 0``."""
    x = 2.0 * coords[..., 0] / max(w - 1, 1) - 1.0
    y = 2.0 * coords[..., 1] / max(h - 1, 1) - 1.0
    return torch.stack([x, y], dim=-1)


def _lookup_dense(shape, levels: List[torch.Tensor], coords: torch.Tensor, radius: int):
    B, H1, W1 = shape
    win = 2 * radius + 1
    deltas = _window_deltas(radius, coords.device).reshape(1, win, win, 2)
    out = []
    for i, corr in enumerate(levels):
        hl, wl = corr.shape[1:3]
        centroid = coords.reshape(B * H1 * W1, 1, 1, 2) / (2**i)
        grid = _normalize_coords(centroid + deltas, hl, wl)
        sampled = grid_sample(corr, grid, align_corners=True, padding_mode="zeros")
        out.append(sampled.reshape(B, H1, W1, win * win))
    return torch.cat(out, dim=-1)


def lookup_lazy_plain(
    fmap1: torch.Tensor, f2_levels: List[torch.Tensor], coords: torch.Tensor, radius: int
) -> torch.Tensor:
    """On-demand windowed correlation, the plain version of K2: for each
    level i and offset d, ``<f1, bilinear(f2_i, coords/2^i + d)> / sqrt(D)``
    with zero padding -> [B, H1, W1, levels * (2r+1)^2]."""
    D = fmap1.shape[-1]
    scale = 1.0 / math.sqrt(D)
    deltas = _window_deltas(radius, coords.device)
    out = []
    for i, f2 in enumerate(f2_levels):
        hl, wl = f2.shape[1:3]
        centroid = coords / (2**i)
        taps = []
        for delta in deltas:
            grid = _normalize_coords(centroid + delta, hl, wl)
            warped = grid_sample(f2, grid, align_corners=True, padding_mode="zeros")
            taps.append(torch.sum(fmap1 * warped, dim=-1) * scale)
        out.append(torch.stack(taps, dim=-1))
    return torch.cat(out, dim=-1)


def _lookup_lazy(fmap1, f2_levels, coords, radius) -> torch.Tensor:
    """Kernel K2 on CUDA tensors, the plain version on CPU tensors."""
    if all(t.device.type == "cpu" for t in (fmap1, coords, *f2_levels)):
        return lookup_lazy_plain(fmap1, f2_levels, coords, radius)
    return correlation_cuda.windowed_correlation(fmap1, f2_levels, coords, radius)


def corr_pyramid_lookup(pyramid, coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Window lookup over all levels of ``pyramid`` (from
    :func:`build_corr_pyramid`) at ``coords`` [B, H1, W1, 2] (level-0
    pixels, (x, y)) -> [B, H1, W1, num_levels * (2*radius+1)^2]."""
    if pyramid[0] == "dense":
        return _lookup_dense(pyramid[1], pyramid[2], coords, radius)
    return _lookup_lazy(pyramid[1], pyramid[2], coords, radius)
