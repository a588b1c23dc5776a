"""Kernel K2: RAFT's on-demand windowed correlation lookup on the card.

:func:`windowed_correlation` launches the hand-written CUDA kernel
(``csrc/correlation.cu``), which computes the JAX package's
``ops/pallas/correlation.py:_lookup_lazy`` (XLA there; the reference's
``alt_cuda_corr``) for every level in one launch. For D = 128 or 256 with
16-byte aligned rows the kernel takes 8x8 tiles of query pixels a block and
computes a tile's dots as one product with the union box of its windows,
staged in shared memory, where that box holds at most ``MAX_BOX[radius]``
pixels; :func:`tile_plan` computes that choice on the host, as the kernel's
prologue makes it. Its plain PyTorch version
is :func:`deep_visual_slam_torch.ops.correlation.lookup_lazy_plain`, which
serves CPU tensors; this wrapper takes CUDA tensors only and raises on what
the kernel does not take, on a failed build or launch. It is forward only:
no caller differentiates through the lookup (RAFT detaches ``coords`` every
iteration and FlowPoseNet runs RAFT without a gradient), so it raises when
an input requires a gradient in grad mode (its backward is queued in
``ROADMAP.md`` §2).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from deep_visual_slam_torch.utils import cuda_build

MAX_LEVELS = 8
MAX_CHANNELS = 256
RADII = (3, 4)  # SmallRAFT's window radius and RAFT's: the kernel's instantiations
# The tiled form (csrc/correlation.cu: kTile, Box<R>::kMaxU): query tiles of
# TILE x TILE pixels; a tile's union box is staged when it holds at most
# MAX_BOX[radius] pixels, else the tile runs the per-pixel form.
TILE = 8
MAX_BOX = {3: 256, 4: 324}


@functools.cache
def _entry():
    fn = cuda_build.load("correlation.cu").corr_lookup_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(fmap1: torch.Tensor, f2_levels: List[torch.Tensor], coords: torch.Tensor,
           radius: int) -> None:
    tensors = [("fmap1", fmap1), ("coords", coords)] + [
        (f"f2_levels[{i}]", t) for i, t in enumerate(f2_levels)]
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != fmap1.device:
            raise ValueError(f"{name} on {t.device}, fmap1 on {fmap1.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (NHWC)")
    if fmap1.dim() != 4:
        raise ValueError(f"fmap1 must be [B, H1, W1, D], got {tuple(fmap1.shape)}")
    B, H1, W1, D = fmap1.shape
    if coords.shape != (B, H1, W1, 2):
        raise ValueError(f"coords {tuple(coords.shape)} is not {(B, H1, W1, 2)}")
    if not 1 <= len(f2_levels) <= MAX_LEVELS:
        raise ValueError(f"1 to {MAX_LEVELS} levels, got {len(f2_levels)}")
    for i, t in enumerate(f2_levels):
        if t.dim() != 4 or t.shape[0] != B or t.shape[3] != D or min(t.shape) < 1:
            raise ValueError(f"f2_levels[{i}] {tuple(t.shape)} is not [{B}, h, w, {D}]")
    if radius not in RADII:
        raise ValueError(f"radius must be one of {RADII}, got {radius}")
    if not 1 <= D <= MAX_CHANNELS or min(B, H1, W1) < 1 or B * H1 * W1 >= 2**31:
        raise ValueError(f"unsupported fmap1 shape {tuple(fmap1.shape)}")


def windowed_correlation(
    fmap1: torch.Tensor, f2_levels: List[torch.Tensor], coords: torch.Tensor, radius: int
) -> torch.Tensor:
    """[B, H1, W1, D] fmap1, the pooled fmap2 levels [B, h_l, w_l, D] and
    ``coords`` [B, H1, W1, 2] (level-0 pixels, (x, y)), fp32 contiguous on
    one card -> [B, H1, W1, len(f2_levels) * (2*radius+1)^2] fp32, in one
    launch on the current stream, counted in ``windowed_correlation.launches``."""
    _check(fmap1, f2_levels, coords, radius)
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (fmap1, coords, *f2_levels)
    ):
        raise RuntimeError(
            "kernel K2 (the windowed correlation lookup) is forward only: its "
            "backward is queued in ROADMAP.md §2. Run the lookup under "
            "torch.no_grad() or detach its inputs."
        )
    B, H1, W1, D = fmap1.shape
    L = len(f2_levels)
    out = torch.empty((B, H1, W1, L * (2 * radius + 1) ** 2), device=fmap1.device,
                      dtype=torch.float32)
    ptrs = (ctypes.c_longlong * L)(*[t.data_ptr() for t in f2_levels])
    hw = (ctypes.c_int * (2 * L))(*[n for t in f2_levels for n in t.shape[1:3]])
    with torch.cuda.device(fmap1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(
            fmap1.data_ptr(), coords.data_ptr(), out.data_ptr(),
            ctypes.addressof(ptrs), ctypes.addressof(hw), L, B, H1, W1, D, radius,
            1.0 / math.sqrt(D), stream,
        )
    if err != 0:
        raise RuntimeError(f"corr_lookup_forward kernel launch failed: CUDA error {err}")
    windowed_correlation.launches += 1
    return out


windowed_correlation.launches = 0


def tile_plan(
    coords: torch.Tensor, level_shapes: Sequence[Tuple[int, int]], radius: int
) -> List[Dict[str, torch.Tensor]]:
    """The tiled form's choice for ``coords`` [B, H1, W1, 2] (level-0
    pixels, (x, y)) on levels of ``level_shapes`` [(h_l, w_l), ...], as the
    kernel's prologue makes it: per level, the union box of each tile's
    window grids (``width``, ``height`` [B, tiles_y, tiles_x] int64; a
    1-pixel axis is 1 wide) and whether the tile stages it (``staged``)."""
    B, H1, W1, _ = coords.shape
    ty, tx = -(-H1 // TILE), -(-W1 // TILE)
    pad = (0, tx * TILE - W1, 0, ty * TILE - H1)
    side = 2 * radius + 2
    plan = []
    for l, (hl, wl) in enumerate(level_shapes):
        extent = []
        for axis, n in ((0, wl), (1, hl)):
            if n == 1:
                extent.append(torch.ones((B, ty, tx), dtype=torch.int64, device=coords.device))
                continue
            fl = torch.floor(coords[..., axis].float() / 2**l)
            # fminf(fmaxf(fl, -1e6), 1e6): NaN goes to -1e6.
            origin = torch.nan_to_num(fl, nan=-1e6).clamp(-1e6, 1e6) - radius
            lo = F.pad(origin, pad, value=math.inf).view(B, ty, TILE, tx, TILE).amin((2, 4))
            hi = F.pad(origin, pad, value=-math.inf).view(B, ty, TILE, tx, TILE).amax((2, 4))
            extent.append((hi - lo).to(torch.int64) + side)
        width, height = extent
        cap = MAX_BOX[radius]
        staged = (width <= cap) & (height <= cap) & (width * height <= cap)
        plan.append({"width": width, "height": height, "staged": staged})
    return plan
