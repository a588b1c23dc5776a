"""Kernel K2: RAFT's on-demand windowed correlation lookup on the card.

:func:`windowed_correlation` launches the hand-written CUDA kernel
(``csrc/correlation.cu``), which computes the JAX package's
``ops/pallas/correlation.py:_lookup_lazy`` (XLA there; the reference's
``alt_cuda_corr``) for every level in one launch. Its plain PyTorch version
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
from typing import List

import torch

from deep_visual_slam_torch.utils import cuda_build

MAX_LEVELS = 8
MAX_CHANNELS = 256
RADII = (3, 4)  # SmallRAFT's window radius and RAFT's: the kernel's instantiations


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
