"""Sparse feature tracking on the device: pyramidal Lucas-Kanade and
Shi-Tomasi corners (port of ``ops/klt.py``).

Everything is fixed-shape: P point slots, L pyramid levels, a (2w+1)^2
patch. Gathers are 4-texel bilinear taps over [P, K] index tensors. The
functions are plain PyTorch: eager on the card, one small kernel an
operation.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

# Luma weights (ITU-R BT.601), the convention of cv2.cvtColor RGB2GRAY.
_LUMA = (0.299, 0.587, 0.114)


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] float RGB -> [..., H, W] float gray, as three
    multiply-adds in fp32 (no matmul, so no TF32 path can touch it)."""
    r, g, b = image[..., 0], image[..., 1], image[..., 2]
    return r * _LUMA[0] + g * _LUMA[1] + b * _LUMA[2]


def _smooth121(gray: torch.Tensor) -> torch.Tensor:
    """Separable [1, 2, 1]/4 low-pass with replicated edges, before the
    pyramid's 2x subsampling."""

    def ax(x, dim):
        n = x.shape[dim]
        pad = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim=dim)
        a = pad.narrow(dim, 0, n)
        b = pad.narrow(dim, 1, n)
        c = pad.narrow(dim, 2, n)
        return 0.25 * a + 0.5 * b + 0.25 * c

    return ax(ax(gray, -2), -1)


def build_pyramid(gray: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Gray [H, W] -> ``levels`` images, level l of H/2^l x W/2^l (floor),
    each by smoothing and 2x subsampling the one above."""
    pyr = [gray]
    for _ in range(levels - 1):
        pyr.append(_smooth121(pyr[-1])[::2, ::2].contiguous())
    return pyr


def _bilinear_gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample [H, W] at float (x, y) of any matching shape, clamped to the
    border: a 4-texel flat gather."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    # NaN coordinates read texel 0 with NaN weights (indices in bounds).
    x0 = torch.clamp(torch.floor(torch.nan_to_num(x)), 0, W - 2)
    y0 = torch.clamp(torch.floor(torch.nan_to_num(y)), 0, H - 2)
    wx = x - x0
    wy = y - y0
    flat = img.reshape(-1)
    base = y0.long() * W + x0.long()
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + W]
    v11 = flat[base + W + 1]
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def _patch_offsets(win: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flattened (2w+1)^2 patch offsets as ([K], [K]) float tensors, x
    fastest."""
    r = torch.arange(-win, win + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(r, r, indexing="ij")
    return ox.reshape(-1), oy.reshape(-1)


def _track_level(
    prev: torch.Tensor,
    cur: torch.Tensor,
    pts: torch.Tensor,  # [P, 2] point positions at this level, in prev
    d: torch.Tensor,  # [P, 2] current flow estimate at this level
    win: int,
    iters: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pyramid level of inverse-compositional LK. Returns (flow, mean
    |residual|, structure-tensor determinant)."""
    ox, oy = _patch_offsets(win, pts.device)
    px = pts[:, 0:1] + ox[None]  # [P, K]
    py = pts[:, 1:2] + oy[None]

    # Template and its gradients from prev: constant over the iterations.
    T = _bilinear_gather(prev, px, py)
    Ix = 0.5 * (_bilinear_gather(prev, px + 1, py) - _bilinear_gather(prev, px - 1, py))
    Iy = 0.5 * (_bilinear_gather(prev, px, py + 1) - _bilinear_gather(prev, px, py - 1))

    Gxx = torch.sum(Ix * Ix, dim=1)
    Gxy = torch.sum(Ix * Iy, dim=1)
    Gyy = torch.sum(Iy * Iy, dim=1)
    det = Gxx * Gyy - Gxy * Gxy
    inv_det = 1.0 / torch.clamp(det, min=1e-8)

    for _ in range(iters):
        e = T - _bilinear_gather(cur, px + d[:, 0:1], py + d[:, 1:2])  # [P, K]
        bx = torch.sum(Ix * e, dim=1)
        by = torch.sum(Iy * e, dim=1)
        dx = (Gyy * bx - Gxy * by) * inv_det
        dy = (Gxx * by - Gxy * bx) * inv_det
        d = d + torch.stack([dx, dy], dim=1)

    e = T - _bilinear_gather(cur, px + d[:, 0:1], py + d[:, 1:2])
    err = torch.mean(torch.abs(e), dim=1)
    return d, err, det


def track_points(
    pyr_prev: Sequence[torch.Tensor],
    pyr_cur: Sequence[torch.Tensor],
    pts: torch.Tensor,  # [P, 2] (x, y) in the level-0 image
    valid: torch.Tensor,  # [P] bool
    win: int = 4,
    iters: int = 8,
    max_err: float = 0.08,
    min_det: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track points from ``pyr_prev`` to ``pyr_cur``, coarse to fine.

    Returns (new_pts [P, 2], new_valid [P], err [P]). A track survives when
    its final mean photometric residual is below ``max_err`` (images in
    [0, 1]), its template's determinant exceeds ``min_det`` and it lands
    inside the image with a ``win`` + 1 margin; a lost track keeps its old
    position.
    """
    L = len(pyr_prev)
    H, W = pyr_prev[0].shape
    d = torch.zeros_like(pts)
    err = det = None
    for lvl in range(L - 1, -1, -1):
        scale = 2.0**lvl
        d, err, det = _track_level(pyr_prev[lvl], pyr_cur[lvl], pts / scale, d, win, iters)
        if lvl > 0:
            d = d * 2.0
    new_pts = pts + d
    margin = float(win + 1)
    in_bounds = (
        (new_pts[:, 0] >= margin)
        & (new_pts[:, 0] <= W - 1 - margin)
        & (new_pts[:, 1] >= margin)
        & (new_pts[:, 1] <= H - 1 - margin)
    )
    ok = (
        valid
        & in_bounds
        & (err < max_err)
        & (det > min_det)
        & torch.all(torch.isfinite(new_pts), dim=1)
    )
    new_pts = torch.where(ok[:, None], new_pts, pts)
    return new_pts, ok, err


def _box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 box sum with zero padding ("SAME"), taps added in
    row-major order."""
    H, W = x.shape
    pad = F.pad(x, (r, r, r, r))
    out = None
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            tap = pad[dy : dy + H, dx : dx + W]
            out = tap if out is None else out + tap
    return out


def _max_pool(x: torch.Tensor, r: int) -> torch.Tensor:
    """(2r+1)^2 maximum with -inf padding ("SAME")."""
    k = 2 * r + 1
    return F.max_pool2d(x[None, None], k, stride=1, padding=r)[0, 0]


def shi_tomasi_corners(
    gray: torch.Tensor,
    num_corners: int,
    nms_radius: int = 7,
    border: int = 8,
    min_quality: float = 1e-4,
    occupied_uv: Optional[torch.Tensor] = None,  # [P, 2] existing points
    occupied_mask: Optional[torch.Tensor] = None,  # [P] which rows count
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-``num_corners`` Shi-Tomasi (min-eigenvalue) corners with NMS.

    Returns (pts [N, 2] float (x, y), score [N]); rows with score <= 0 are
    padding. Corners within ``nms_radius`` of an occupied point are
    suppressed. Equal scores come lowest flat index first, as
    ``jax.lax.top_k`` orders them (a stable descending sort: ``torch.topk``
    promises no order among ties on CUDA).
    """
    H, W = gray.shape
    Ix = 0.5 * (torch.roll(gray, -1, dims=1) - torch.roll(gray, 1, dims=1))
    Iy = 0.5 * (torch.roll(gray, -1, dims=0) - torch.roll(gray, 1, dims=0))
    Ixx = _box_sum(Ix * Ix, 1)
    Ixy = _box_sum(Ix * Iy, 1)
    Iyy = _box_sum(Iy * Iy, 1)
    tr = Ixx + Iyy
    dif = Ixx - Iyy
    score = 0.5 * (tr - torch.sqrt(dif * dif + 4.0 * Ixy * Ixy))

    yy = torch.arange(H, device=gray.device)[:, None]
    xx = torch.arange(W, device=gray.device)[None, :]
    ok = (xx >= border) & (xx < W - border) & (yy >= border) & (yy < H - border)
    score = torch.where(ok, score, 0.0)
    if occupied_uv is not None:
        ox = torch.clamp(torch.round(occupied_uv[:, 0]), 0, W - 1).long()
        oy = torch.clamp(torch.round(occupied_uv[:, 1]), 0, H - 1).long()
        val = (
            occupied_mask.float()
            if occupied_mask is not None
            else torch.ones(occupied_uv.shape[0], device=gray.device)
        )
        occ = torch.zeros(H * W, device=gray.device)
        occ = occ.scatter_reduce(0, oy * W + ox, val, reduce="amax")
        occ = _max_pool(occ.reshape(H, W), nms_radius)
        score = torch.where(occ > 0, 0.0, score)

    # NMS: keep the maxima of the (2r+1)^2 neighbourhood.
    is_max = score >= _max_pool(score, nms_radius)
    score = torch.where(is_max, score, 0.0)
    score = torch.where(score > min_quality, score, 0.0)

    top, idx = torch.sort(score.reshape(-1), descending=True, stable=True)
    top, idx = top[:num_corners], idx[:num_corners]
    pts = torch.stack([(idx % W).float(), torch.div(idx, W, rounding_mode="floor").float()], dim=1)
    return pts, top
