"""Plain forward passes of the Monodepth2 networks (Godard et al., ICCV 2019):
the ResNet-18 DepthNet (encoder plus the 16-256 channel decoder, sigmoid
disparity at four scales) and the 6-channel PoseNet.

Functional PyTorch over a dict of named parameters, NCHW inside, NHWC at the
edges. Parameter names follow the reference torch ``state_dict`` naming
(``encoder.encoder.layer1.0.conv1.weight``, ``decoder.10.conv.weight``,
``net.3.bias``). BatchNorm is in train mode: batch statistics over every row
it is given, biased variance, eps 1e-5. The forward passes take a
:class:`Precision`: every convolution goes through its ``conv`` and every
intermediate tensor through its ``q``, so that the same forward runs in
fp32, with every network tensor in emulated fp8 (:class:`FP8`, the control), or
on meta tensors to count operations (:class:`FlopCounter`). Its ``matmul``
and ``conv_transpose`` serve other networks' references in the same way;
these two networks use neither.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]

BN_EPS = 1e-5
STAGE_BLOCKS = (2, 2, 2, 2)
STAGE_WIDTHS = (64, 128, 256, 512)
ENC_CHANNELS = (64, 64, 128, 256, 512)
DEC_CHANNELS = (16, 32, 64, 128, 256)
NUM_SCALES = 4


class Precision:
    """fp32 throughout: the reference (TF32 off, which the caller sets)."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def conv(self, x, w, b=None, stride=1, padding=0):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding))

    def conv_transpose(self, x, w, b=None, stride=1, padding=0):
        return self.q(F.conv_transpose2d(self.q(x), self.q(w), b, stride, padding))

    def matmul(self, a, b):
        """``a @ b``: a linear layer's product (its bias added after) or one
        of attention's two products."""
        return self.q(torch.matmul(self.q(a), self.q(b)))


def _round_fp8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one per-tensor scale that maps its
    largest magnitude to ``top``, and back to its own dtype."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _FP8(torch.autograd.Function):
    """Forward rounds to e4m3, backward rounds the incoming gradient to
    e5m2: the usual fp8 training recipe."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


class FP8(Precision):
    """The networks one precision below the configuration's bf16: where the
    program's autocast leaves a network tensor in bf16 (every weight and
    activation a convolution, BatchNorm, activation or sum makes), this one
    is rounded to fp8 e4m3, its gradient to e5m2; the convolutions
    accumulate and BatchNorm takes its statistics in fp32, as the program's
    do, and the outputs leave in fp32."""

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _FP8.apply(t)


class FlopCounter(Precision):
    """Counts 2 operations per multiply-add of every convolution, transposed
    convolution and matrix product from the shapes (on meta tensors,
    nothing is computed)."""

    def __init__(self):
        self.flops = 0

    def conv(self, x, w, b=None, stride=1, padding=0):
        y = F.conv2d(x, w, b, stride, padding)
        n, c_out, h, wd = y.shape
        self.flops += 2 * n * c_out * h * wd * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def conv_transpose(self, x, w, b=None, stride=1, padding=0):
        """Every input pixel times the whole [C_in, C_out, k, k] kernel,
        cropped outputs included."""
        y = F.conv_transpose2d(x, w, b, stride, padding)
        self.flops += 2 * x.shape[0] * x.shape[2] * x.shape[3] * w.numel()
        return y

    def matmul(self, a, b):
        y = torch.matmul(a, b)
        self.flops += 2 * y.numel() * a.shape[-1]
        return y


FP32 = Precision()


# --- parameter lists -------------------------------------------------------

def _bn_spec(name: str, ch: int):
    return [(f"{name}.weight", (ch,), "ones"), (f"{name}.bias", (ch,), "zeros")]


def _encoder_spec(prefix: str, in_ch: int):
    spec = [(f"{prefix}conv1.weight", (64, in_ch, 7, 7), "weight")] + _bn_spec(f"{prefix}bn1", 64)
    inp = 64
    for stage, (width, blocks) in enumerate(zip(STAGE_WIDTHS, STAGE_BLOCKS)):
        for i in range(blocks):
            stride = 2 if stage > 0 and i == 0 else 1
            p = f"{prefix}layer{stage + 1}.{i}."
            spec += [(p + "conv1.weight", (width, inp, 3, 3), "weight")]
            spec += _bn_spec(p + "bn1", width)
            spec += [(p + "conv2.weight", (width, width, 3, 3), "weight")]
            spec += _bn_spec(p + "bn2", width)
            if stride != 1 or inp != width:
                spec += [(p + "downsample.0.weight", (width, inp, 1, 1), "weight")]
                spec += _bn_spec(p + "downsample.1", width)
            inp = width
    return spec


def _conv_spec(name: str, out: int, inp: int, k: int):
    return [(f"{name}.weight", (out, inp, k, k), "weight"), (f"{name}.bias", (out,), "bias")]


def depthnet_spec() -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every DepthNet parameter, in module order."""
    spec = _encoder_spec("encoder.encoder.", 3)
    k = 0
    for i in range(4, -1, -1):
        inp = ENC_CHANNELS[-1] if i == 4 else DEC_CHANNELS[i + 1]
        spec += _conv_spec(f"decoder.{k}.conv.conv", DEC_CHANNELS[i], inp, 3)
        inp = DEC_CHANNELS[i] + (ENC_CHANNELS[i - 1] if i > 0 else 0)
        spec += _conv_spec(f"decoder.{k + 1}.conv.conv", DEC_CHANNELS[i], inp, 3)
        k += 2
    for s in range(NUM_SCALES):
        spec += _conv_spec(f"decoder.{10 + s}.conv", 1, DEC_CHANNELS[s], 3)
    return spec


def posenet_spec() -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every PoseNet (two stacked frames) parameter."""
    spec = _encoder_spec("encoder.encoder.", 6)
    spec += _conv_spec("net.0", 256, ENC_CHANNELS[-1], 1)
    spec += _conv_spec("net.1", 256, 256, 3)
    spec += _conv_spec("net.2", 256, 256, 3)
    spec += _conv_spec("net.3", 6, 256, 1)
    return spec


# --- forward passes --------------------------------------------------------

def _stage(fn, *xs):
    """``fn(*xs)``, recomputed in the backward instead of kept: the
    reference runs the whole batch of a four-card cell on one card."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return checkpoint(fn, *xs, use_reentrant=False)
    return fn(*xs)


def _bn(x: torch.Tensor, P: Params, name: str, pr: Precision) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    w = P[f"{name}.weight"].view(1, -1, 1, 1)
    b = P[f"{name}.bias"].view(1, -1, 1, 1)
    return pr.q((x - mean) / torch.sqrt(var + BN_EPS) * w + b)


def encoder(P: Params, prefix: str, x: torch.Tensor, pr: Precision) -> List[torch.Tensor]:
    """The five feature maps of ResNet-18 over NCHW ``x`` (normalised by
    (x - 0.45) / 0.225 first)."""
    def stem(x):
        x = pr.conv((x - 0.45) / 0.225, P[f"{prefix}conv1.weight"], None, 2, 3)
        return torch.relu(_bn(x, P, f"{prefix}bn1", pr))

    def layer(stage, x):
        for i in range(STAGE_BLOCKS[stage]):
            stride = 2 if stage > 0 and i == 0 else 1
            p = f"{prefix}layer{stage + 1}.{i}."
            y = torch.relu(_bn(pr.conv(x, P[p + "conv1.weight"], None, stride, 1), P,
                               p + "bn1", pr))
            y = _bn(pr.conv(y, P[p + "conv2.weight"], None, 1, 1), P, p + "bn2", pr)
            if p + "downsample.0.weight" in P:
                x = _bn(pr.conv(x, P[p + "downsample.0.weight"], None, stride, 0), P,
                        p + "downsample.1", pr)
            x = pr.q(torch.relu(y + x))
        return x

    feats = [_stage(stem, x)]
    x = F.max_pool2d(feats[0], 3, 2, 1)
    for stage in range(len(STAGE_BLOCKS)):
        x = _stage(lambda t, s=stage: layer(s, t), x)
        feats.append(x)
    return feats


def _reflect_conv(x, P, name, pr):
    return pr.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"), P[f"{name}.weight"],
                   P[f"{name}.bias"])


def depthnet(P: Params, image: torch.Tensor, pr: Precision = FP32) -> List[torch.Tensor]:
    """``image`` [B, H, W, 3] -> sigmoid disparity [B, H/2^s, W/2^s, 1] for
    s = 0..3, fp32."""
    feats = encoder(P, "encoder.encoder.", image.permute(0, 3, 1, 2), pr)

    def up(k, x, *skip):
        x = pr.q(F.elu(_reflect_conv(x, P, f"decoder.{2 * k}.conv.conv", pr)))
        x = torch.cat([F.interpolate(x, scale_factor=2, mode="nearest"), *skip], dim=1)
        return pr.q(F.elu(_reflect_conv(x, P, f"decoder.{2 * k + 1}.conv.conv", pr)))

    x = feats[-1]
    disp = {}
    for k, i in enumerate(range(4, -1, -1)):
        skip = (feats[i - 1],) if i > 0 else ()
        x = _stage(lambda *t, k=k: up(k, *t), x, *skip)
        if i < NUM_SCALES:
            disp[i] = torch.sigmoid(_reflect_conv(x, P, f"decoder.{10 + i}.conv", pr))
    return [disp[s].permute(0, 2, 3, 1) for s in range(NUM_SCALES)]


def posenet(P: Params, pairs: torch.Tensor, pr: Precision = FP32):
    """``pairs`` [N, H, W, 6] -> (axis-angle [N, 3], translation [N, 3]),
    both scaled by 0.01."""
    x = encoder(P, "encoder.encoder.", pairs.permute(0, 3, 1, 2), pr)[-1]
    x = torch.relu(pr.conv(x, P["net.0.weight"], P["net.0.bias"]))
    x = torch.relu(pr.conv(x, P["net.1.weight"], P["net.1.bias"], 1, 1))
    x = torch.relu(pr.conv(x, P["net.2.weight"], P["net.2.bias"], 1, 1))
    x = pr.conv(x, P["net.3.weight"], P["net.3.bias"])
    out = 0.01 * x.mean(dim=(2, 3))
    return out[:, :3], out[:, 3:]


def forward_flops(spec, forward, shape) -> int:
    """Operations of one forward of ``forward`` over an input of ``shape``
    (NHWC), counted on meta tensors."""
    counter = FlopCounter()
    with torch.device("meta"):
        P = {name: torch.empty(s) for name, s, _ in spec}
        forward(P, torch.empty(shape), counter)
    return counter.flops
