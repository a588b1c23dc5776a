"""Kernel K1: the fused SSIM + L1 reprojection-loss map, and its plain version.

``reprojection_loss`` runs the hand-written CUDA kernels
(``csrc/reprojection.cu``, which replace the Pallas kernel
``deep_visual_slam_tpu/ops/pallas/photometric_pallas.py:_kernel5`` and its
``custom_vjp`` backward ``_bwd``) on CUDA tensors through a
``torch.autograd.Function``: the forward kernel, and the backward kernel for
the gradient of each input that requires one. The plain PyTorch version,
``reprojection_loss_plain``, under ordinary autograd, serves CPU tensors
only. Nothing falls back: a CUDA input the kernel does not take, a failed
build or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deep_visual_slam_torch.utils import cuda_build

_C1 = 0.01**2
_C2 = 0.03**2
# The kernels keep a tile of every channel in shared memory.
MAX_CHANNELS = 16


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


_ARGTYPES = {  # the C entry points of csrc/reprojection.cu
    "reprojection_loss_forward": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
    "reprojection_loss_backward": [ctypes.c_void_p] * 3
    + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
}


@functools.cache
def _entry(name: str):
    """A C entry point of the kernels, built and loaded at first use."""
    fn = getattr(cuda_build.load("reprojection.cu"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Calls entry point ``name`` on the current stream of ``device``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check(pred: torch.Tensor, target: torch.Tensor) -> None:
    for name, t in (("pred", pred), ("target", target)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (NHWC)")
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
    if not 1 <= B <= 65535 or not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"unsupported batch {B} or channel count {C}")


def _grad_view(g: torch.Tensor, pred: torch.Tensor) -> tuple[torch.Tensor, int]:
    """dL/dout as the backward kernel takes it: fp32 [B, H, W, 1] on pred's
    device, and the stride between its pixels. The VO loss concatenates the
    maps on the last axis, so each map's gradient arrives as a stride-2
    slice: a view whose pixel stride is uniform over B*H*W (0 for an
    expanded gradient) is passed as it is; any other is copied contiguous."""
    if g.device != pred.device:
        raise ValueError(f"gradient on {g.device}, inputs on {pred.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"gradient must be float32, got {g.dtype}")
    if g.shape != pred.shape[:3] + (1,):
        raise ValueError(
            f"gradient shape {tuple(g.shape)} is not {tuple(pred.shape[:3]) + (1,)}"
        )
    B, H, W = g.shape[:3]
    s = g.stride(2)
    if (B == 1 or g.stride(0) == s * H * W) and (H == 1 or g.stride(1) == s * W):
        return g, s
    return g.contiguous(), 1


def _forward_kernel(
    pred: torch.Tensor, target: torch.Tensor, ssim_ratio: float
) -> torch.Tensor:
    B, H, W, C = pred.shape
    out = torch.empty((B, H, W, 1), device=pred.device, dtype=torch.float32)
    _launch(
        "reprojection_loss_forward", pred.device,
        pred.data_ptr(), target.data_ptr(), out.data_ptr(), B, H, W, C,
        ssim_ratio, 1.0 - ssim_ratio,
    )
    reprojection_loss.launches += 1
    return out


def reprojection_loss_backward(
    pred: torch.Tensor,
    target: torch.Tensor,
    g: torch.Tensor,
    ssim_ratio: float = 0.85,
) -> torch.Tensor:
    """dL/dpred of :func:`reprojection_loss` by the backward kernel, given
    ``g`` = dL/dout [B, H, W, 1] (any strides), in one launch; called with
    pred and target swapped it gives dL/dtarget. CUDA tensors only; the
    launch is counted in ``reprojection_loss.backward_launches``."""
    _check(pred, target)
    g, g_stride = _grad_view(g, pred)
    B, H, W, C = pred.shape
    grad = torch.empty_like(pred)
    _launch(
        "reprojection_loss_backward", pred.device,
        pred.data_ptr(), target.data_ptr(), g.data_ptr(), g_stride,
        grad.data_ptr(), B, H, W, C, ssim_ratio, 1.0 - ssim_ratio,
    )
    reprojection_loss.backward_launches += 1
    return grad


class _ReprojectionLoss(torch.autograd.Function):
    """K1's forward kernel, with its backward kernel as the gradient."""

    @staticmethod
    def forward(ctx, pred, target, ssim_ratio):
        ctx.save_for_backward(pred, target)
        ctx.ssim_ratio = ssim_ratio
        return _forward_kernel(pred, target, ssim_ratio)

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        grad_pred = grad_target = None
        if ctx.needs_input_grad[0]:
            grad_pred = reprojection_loss_backward(pred, target, g, ctx.ssim_ratio)
        if ctx.needs_input_grad[1]:
            grad_target = reprojection_loss_backward(target, pred, g, ctx.ssim_ratio)
        return grad_pred, grad_target, None


def reprojection_loss(
    pred: torch.Tensor, target: torch.Tensor, ssim_ratio: float = 0.85
) -> torch.Tensor:
    """Reprojection-loss map [B, H, W, C] x 2 -> [B, H, W, 1] fp32.

    CPU tensors take :func:`reprojection_loss_plain` under ordinary
    autograd. CUDA tensors go through the kernels on the current stream:
    the forward launch is counted in ``reprojection_loss.launches``, each
    backward launch (one per input that requires grad) in
    ``reprojection_loss.backward_launches``.
    """
    if pred.device.type == "cpu" and target.device.type == "cpu":
        return reprojection_loss_plain(pred, target, ssim_ratio)
    _check(pred, target)
    return _ReprojectionLoss.apply(pred, target, ssim_ratio)


reprojection_loss.launches = 0
reprojection_loss.backward_launches = 0
