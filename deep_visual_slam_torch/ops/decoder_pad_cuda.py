"""Kernel K3: the reflect-padded inputs of DepthNet's decoder convs, and
their plain version.

``decoder_pad(y, skip, elu=..., up=...)`` computes

    P = reflect_pad_1(cat(up2(elu(y)), skip))     [B, C1 + C2, H + 2, W + 2]

with the ELU, the nearest 2x upsample and the skip each optional. The
decoder takes two forms of it: pad_elu (no upsample, no skip) on each
``upconv_i_1`` output and, with the ELU off, on the encoder's last feature;
pad_up_cat (ELU, upsample and, but at the last level, the skip) for the
input of each ``upconv_i_1``. One P is written for all the convs that read
it.

CUDA tensors go through the hand-written kernels (``csrc/decoder_pad.cu``;
they replace no Pallas kernel, XLA fuses the pad on the TPU) by a
``torch.autograd.Function``: one forward launch, and one backward launch
that gathers dy and dskip from dP and reads the ELU's derivative back from P,
which is all it saves. That derivative, elu(y) + 1 where y <= 0, is read
from P as rounded to the working type: in bf16 it errs by up to 2^-9 in
absolute terms (half an ulp near -1), where PyTorch's ELU backward, exp(y)
in fp32 from the saved input, errs by 2^-9 of itself. So for y below about
-2 the kernel's dy is relatively the coarser, though its absolute error
stays within what rounding dy to bf16 gives where y > 0.

The plain PyTorch version, ``decoder_pad_plain``, is the composition the
kernels replace (``F.elu``, ``F.interpolate``, ``torch.cat``, ``F.pad``)
under ordinary autograd. It serves CPU tensors,
and tensors of either device while ``torch.export`` or ``torch.compile``
traces, because a ctypes launch cannot run on the fake tensors of a trace.
Nothing falls back: a CUDA input the kernels do not take, a failed build or
a failed launch raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from deep_visual_slam_torch.utils import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernels' bf16 flag

_STRIDES = [ctypes.c_longlong] * 4
_ARGTYPES = {  # the C entry points of csrc/decoder_pad.cu
    "decoder_pad_forward": [ctypes.c_int, ctypes.c_void_p, *_STRIDES,
                            ctypes.c_void_p, *_STRIDES, ctypes.c_void_p]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "decoder_pad_backward": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_void_p, *_STRIDES, ctypes.c_void_p, *_STRIDES]
    + [ctypes.c_int] * 7 + [ctypes.c_void_p],
}


def decoder_pad_plain(
    y: torch.Tensor, skip: torch.Tensor | None = None, *, elu: bool = True,
    up: bool = False,
) -> torch.Tensor:
    """[B, C1, h, w] (+ skip [B, C2, H, W]) -> [B, C1 + C2, H + 2, W + 2]:
    ``F.pad(cat(up2(elu(y)), skip), (1, 1, 1, 1), mode="reflect")``."""
    x = F.elu(y) if elu else y
    if up:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    if skip is not None:
        x = torch.cat([x, skip], dim=1)
    return F.pad(x, (1, 1, 1, 1), mode="reflect")


@functools.cache
def _entry(name: str):
    """A C entry point of the kernels, built and loaded at first use."""
    fn = getattr(cuda_build.load("decoder_pad.cu"), name)
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


def _check(y: torch.Tensor, skip: torch.Tensor | None, up: bool) -> None:
    if y.dim() != 4:
        raise ValueError(f"y must be [B, C, h, w], got {tuple(y.shape)}")
    B, _, h, w = y.shape
    H, W = h << up, w << up
    for name, t in (("y", y), ("skip", skip)):
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if skip is not None:
        if skip.device != y.device or skip.dtype != y.dtype:
            raise ValueError(f"skip is {skip.dtype} on {skip.device}, y "
                             f"{y.dtype} on {y.device}")
        if skip.dim() != 4 or skip.shape[0] != B or skip.shape[2:] != (H, W):
            raise ValueError(f"skip must be [{B}, C2, {H}, {W}], got {tuple(skip.shape)}")
    if H < 2 or W < 2:
        raise ValueError(f"reflect padding needs H, W >= 2, got {H}x{W}")
    if not 1 <= B <= 65535 or (H + 2) * (W + 2) >= 2**31:
        raise ValueError(f"unsupported batch {B} or size {H}x{W}")


def _strides(t: torch.Tensor | None) -> tuple:
    return (0, 0, 0, 0) if t is None else t.stride()


def _layout(t: torch.Tensor) -> torch.memory_format:
    """The memory format of ``t``'s gradient: channels-last where ``t`` is."""
    if t.is_contiguous(memory_format=torch.channels_last) and not t.is_contiguous():
        return torch.channels_last
    return torch.contiguous_format


class _DecoderPad(torch.autograd.Function):
    """K3's forward kernel, with its backward kernel as the gradient."""

    @staticmethod
    def forward(ctx, y, skip, elu, up):
        B, C1, h, w = y.shape
        C2 = 0 if skip is None else skip.shape[1]
        H, W = h << up, w << up
        P = torch.empty((B, C1 + C2, H + 2, W + 2), device=y.device, dtype=y.dtype)
        _launch(
            "decoder_pad_forward", y.device, _DTYPES[y.dtype],
            y.data_ptr(), *y.stride(),
            0 if skip is None else skip.data_ptr(), *_strides(skip),
            P.data_ptr(), B, C1, C2, h, w, int(up), int(elu),
        )
        decoder_pad.launches += 1
        ctx.elu, ctx.up = elu, up
        ctx.y_meta = (y.shape, _layout(y))
        ctx.skip_meta = None if skip is None else (skip.shape, _layout(skip))
        if elu:
            ctx.save_for_backward(P)
        return P

    @staticmethod
    def backward(ctx, dP):
        (y_shape, y_layout), skip_meta = ctx.y_meta, ctx.skip_meta
        dy = torch.empty(y_shape, device=dP.device, dtype=dP.dtype, memory_format=y_layout)
        dskip = None if skip_meta is None else torch.empty(
            skip_meta[0], device=dP.device, dtype=dP.dtype, memory_format=skip_meta[1])
        P = ctx.saved_tensors[0] if ctx.elu else None
        decoder_pad_backward(dP, P, dy, dskip, elu=ctx.elu, up=ctx.up)
        return dy, dskip, None, None


def decoder_pad_backward(
    dP: torch.Tensor, P: torch.Tensor | None, dy: torch.Tensor,
    dskip: torch.Tensor | None, *, elu: bool, up: bool,
) -> None:
    """Writes dy and dskip (any strides) from dP, the gradient of
    :func:`decoder_pad`'s output, in one launch of the backward kernel; P
    is that output, which the ELU's derivative is read from (None without
    the ELU). CUDA tensors only; the launch is counted in
    ``decoder_pad.backward_launches``."""
    # Autograd hands dP in P's shape and dtype; the convs' backward writes
    # it NCHW contiguous, so the copy is taken only by other callers.
    dP = dP.contiguous()
    B, C1, h, w = dy.shape
    _launch(
        "decoder_pad_backward", dP.device, _DTYPES[dP.dtype],
        dP.data_ptr(), 0 if P is None else P.data_ptr(),
        dy.data_ptr(), *dy.stride(),
        0 if dskip is None else dskip.data_ptr(), *_strides(dskip),
        B, C1, 0 if dskip is None else dskip.shape[1], h, w, int(up), int(elu),
    )
    decoder_pad.backward_launches += 1


def decoder_pad(
    y: torch.Tensor, skip: torch.Tensor | None = None, *, elu: bool = True,
    up: bool = False,
) -> torch.Tensor:
    """The padded conv input [B, C1 + C2, H + 2, W + 2] (NCHW contiguous)
    from y [B, C1, h, w] and skip [B, C2, H, W] or None, with H, W = h, w
    doubled where ``up``; see :func:`decoder_pad_plain`.

    CPU tensors, and any while ``torch.export`` or ``torch.compile``
    traces, take :func:`decoder_pad_plain` under ordinary autograd. CUDA
    tensors (float32 or bfloat16, any strides) go through the kernels on
    the current stream: each forward launch is counted in
    ``decoder_pad.launches``, each backward launch in
    ``decoder_pad.backward_launches``.
    """
    if torch.compiler.is_compiling() or (
        y.device.type == "cpu" and (skip is None or skip.device.type == "cpu")
    ):
        return decoder_pad_plain(y, skip, elu=elu, up=up)
    _check(y, skip, up)
    return _DecoderPad.apply(y, skip, elu, up)


decoder_pad.launches = 0
decoder_pad.backward_launches = 0
