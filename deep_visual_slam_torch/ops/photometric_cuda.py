"""Kernel K1: the fused SSIM + L1 reprojection-loss map, and its plain version.

``reprojection_loss`` launches the hand-written CUDA kernel
(``csrc/reprojection.cu``, which replaces the Pallas kernel
``deep_visual_slam_tpu/ops/pallas/photometric_pallas.py:_kernel5``) on CUDA
tensors, and takes the plain PyTorch version, ``reprojection_loss_plain``,
only for CPU tensors. Nothing falls back: a CUDA input the kernel does not
take, a failed build or a failed launch raises.

Forward only. Inputs that require grad raise on CUDA; the backward kernel
belongs to the training slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deep_visual_slam_torch.utils import cuda_build

_C1 = 0.01**2
_C2 = 0.03**2


def _reflect_index(n: int, device) -> torch.Tensor:
    """Indices of a 1-pixel reflect pad: [1, 0, 1, ..., n-2, n-1, n-2]."""
    idx = torch.arange(-1, n + 1, device=device).abs()
    return torch.where(idx > n - 1, 2 * (n - 1) - idx, idx)


def _avg_pool3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 VALID mean over NHWC H, W as a sum of 9 shifted slices,
    taps in row-major order (the kernel sums them in the same order)."""
    H, W = x.shape[1], x.shape[2]
    s = None
    for i in range(3):
        for j in range(3):
            piece = x[:, i : i + H - 2, j : j + W - 2, :]
            s = piece if s is None else s + piece
    return s / 9.0


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-pixel SSIM loss map ``clamp((1 - SSIM(x, y)) / 2, 0, 1)``.

    x, y: [B, H, W, C]; reflect padding keeps the output [B, H, W, C].
    """
    ih = _reflect_index(x.shape[1], x.device)
    iw = _reflect_index(x.shape[2], x.device)
    x = x.index_select(1, ih).index_select(2, iw)
    y = y.index_select(1, ih).index_select(2, iw)

    mu_x = _avg_pool3x3(x)
    mu_y = _avg_pool3x3(y)
    sigma_x = _avg_pool3x3(x * x) - mu_x * mu_x
    sigma_y = _avg_pool3x3(y * y) - mu_y * mu_y
    sigma_xy = _avg_pool3x3(x * y) - mu_x * mu_y

    ssim_n = (2.0 * mu_x * mu_y + _C1) * (2.0 * sigma_xy + _C2)
    ssim_d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return torch.clamp((1.0 - ssim_n / ssim_d) * 0.5, 0.0, 1.0)


def reprojection_loss_plain(
    pred: torch.Tensor, target: torch.Tensor, ssim_ratio: float = 0.85
) -> torch.Tensor:
    """[B, H, W, C] x 2 -> [B, H, W, 1]:
    ``ssim_ratio * mean_c(SSIM) + (1 - ssim_ratio) * mean_c(|target - pred|)``."""
    l1 = torch.mean(torch.abs(target - pred), dim=-1, keepdim=True)
    ssim_l = torch.mean(ssim(pred, target), dim=-1, keepdim=True)
    return ssim_ratio * ssim_l + (1.0 - ssim_ratio) * l1


@functools.cache
def _forward():
    """The kernel's C entry point, built and loaded at first use."""
    fn = cuda_build.load("reprojection.cu").reprojection_loss_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(pred: torch.Tensor, target: torch.Tensor) -> None:
    for name, t in (("pred", pred), ("target", target)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (NHWC)")
        if t.requires_grad:
            raise NotImplementedError(
                "reprojection_loss has no backward kernel yet; "
                f"{name} requires grad"
            )
    if pred.device != target.device:
        raise ValueError(f"inputs on {pred.device} and {target.device}")
    if pred.shape != target.shape or pred.dim() != 4:
        raise ValueError(
            f"expected equal [B, H, W, C] shapes, got {tuple(pred.shape)} "
            f"and {tuple(target.shape)}"
        )
    B, H, W, C = pred.shape
    if H < 2 or W < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {H}x{W}")
    if not 1 <= B <= 65535 or C < 1:
        raise ValueError(f"unsupported batch {B} or channel count {C}")


def reprojection_loss(
    pred: torch.Tensor, target: torch.Tensor, ssim_ratio: float = 0.85
) -> torch.Tensor:
    """Reprojection-loss map [B, H, W, C] x 2 -> [B, H, W, 1] fp32.

    CPU tensors take :func:`reprojection_loss_plain`; CUDA tensors launch
    the kernel on the current stream and count the launch in
    ``reprojection_loss.launches``.
    """
    if pred.device.type == "cpu" and target.device.type == "cpu":
        return reprojection_loss_plain(pred, target, ssim_ratio)
    _check(pred, target)
    B, H, W, C = pred.shape
    out = torch.empty((B, H, W, 1), device=pred.device, dtype=torch.float32)
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _forward()(
            pred.data_ptr(), target.data_ptr(), out.data_ptr(), B, H, W, C,
            ssim_ratio, 1.0 - ssim_ratio, stream,
        )
    if err != 0:
        raise RuntimeError(f"reprojection_loss kernel launch failed: CUDA error {err}")
    reprojection_loss.launches += 1
    return out


reprojection_loss.launches = 0
