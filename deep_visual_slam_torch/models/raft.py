"""RAFT and SmallRAFT optical flow (port of ``models/raft.py``), NCHW inside.

Parameter names are the reference torch RAFT's (``fnet.conv1``,
``fnet.layer1.0.conv1``, ``cnet.norm1``, ``update_block.encoder.convc1``,
``update_block.gru.convz``/``convz1``, ``update_block.flow_head.conv1``,
``update_block.mask.0``, ...), so a reference checkpoint loads as it is and
the JAX package's ``utils/torch_weights.py:convert_raft`` reads the port's
``state_dict``:

- feature and context encoders at 1/8 resolution (``fnet`` instance-normed,
  ``cnet`` without norm in Small, batch-normed in Basic), run once over
  both frames stacked on the batch;
- a 4-level correlation pyramid with a radius-r window lookup
  (:mod:`deep_visual_slam_torch.ops.correlation`): the on-demand lookup,
  kernel K2, on the card, the dense all-pairs volume on the CPU, unless
  ``memory_efficient`` names a route;
- ``iters`` GRU refinements, each detaching ``coords1``, and the flow
  upsampled x8: bilinear corner-aligned (Small) or the learned convex
  combination (Basic).

The public forward keeps the JAX package's NHWC layout: images [B, H, W, 3]
in [0, 1] in, the list of per-iteration flows [B, H, W, 2] out (the last is
the output).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_visual_slam_torch.models.depthnet import init_conv
from deep_visual_slam_torch.models.resnet import BatchNorm2d
from deep_visual_slam_torch.ops.correlation import build_corr_pyramid, corr_pyramid_lookup
from deep_visual_slam_torch.ops.warp import resize_bilinear_align_corners


def _norm(kind: str, channels: int) -> nn.Module:
    """The reference extractor's ``norm_fn``: ``instance`` (no affine
    parameters), ``group`` (channels // 8 groups), ``batch`` (the port's
    flax-rule :class:`BatchNorm2d`) or ``none``; eps 1e-5 throughout."""
    if kind == "instance":
        return nn.InstanceNorm2d(channels, eps=1e-5)
    if kind == "group":
        return nn.GroupNorm(max(channels // 8, 1), channels, eps=1e-5)
    if kind == "batch":
        return BatchNorm2d(channels)
    if kind == "none":
        return nn.Sequential()
    raise ValueError(f"unknown norm_fn {kind!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs; a strided or widening block projects its shortcut
    through ``downsample`` (a 1x1 conv and ``norm3``)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = _norm(norm_fn, planes)
        self.norm2 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm3 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride), self.norm3
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 at a quarter width, a relu after each
    norm (the last too); the shortcut projects through ``norm4``."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group", stride: int = 1):
        super().__init__()
        q = planes // 4
        self.conv1 = nn.Conv2d(in_planes, q, 1)
        self.conv2 = nn.Conv2d(q, q, 3, stride, 1)
        self.conv3 = nn.Conv2d(q, planes, 1)
        self.norm1 = _norm(norm_fn, q)
        self.norm2 = _norm(norm_fn, q)
        self.norm3 = _norm(norm_fn, planes)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.norm4 = _norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride), self.norm4
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = torch.relu(self.norm2(self.conv2(y)))
        y = torch.relu(self.norm3(self.conv3(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


class Encoder(nn.Module):
    """Feature/context encoder to 1/8 resolution: a 7x7 stride-2 stem, three
    stages of two blocks (the 2nd and 3rd strided), a 1x1 head.
    ``small``: 32-64-96 bottleneck stages (the reference's ``SmallEncoder``),
    else 64-96-128 residual stages (``BasicEncoder``)."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "instance", small: bool = False):
        super().__init__()
        stem, widths, block = (32, (32, 64, 96), BottleneckBlock) if small else (
            64, (64, 96, 128), ResidualBlock)
        self.conv1 = nn.Conv2d(3, stem, 7, 2, 3)
        self.norm1 = _norm(norm_fn, stem)
        inp = stem
        for i, w in enumerate(widths):
            stride = 1 if i == 0 else 2
            setattr(self, f"layer{i + 1}", nn.Sequential(
                block(inp, w, norm_fn, stride), block(w, w, norm_fn, 1)))
            inp = w
        self.conv2 = nn.Conv2d(inp, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.conv2(x)


class ConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 96, input_dim: int = 146):
        super().__init__()
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q


class SepConvGRU(nn.Module):
    """A horizontal (1x5: ``conv*1``) then a vertical (5x1: ``conv*2``) GRU pass."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden_dim + input_dim
        for i, k, p in ((1, (1, 5), (0, 2)), (2, (5, 1), (2, 0))):
            for g in "zrq":
                setattr(self, f"conv{g}{i}", nn.Conv2d(c, hidden_dim, k, padding=p))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for i in (1, 2):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.relu(self.conv1(x)))


class SmallMotionEncoder(nn.Module):
    """Correlation and flow features: 80 channels plus the flow (82)."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 96, 1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv = nn.Conv2d(128, 80, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc1(corr))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class BasicMotionEncoder(nn.Module):
    """Correlation and flow features: 126 channels plus the flow (128)."""

    def __init__(self, corr_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(256, 126, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        out = torch.relu(self.conv(torch.cat([cor, flo], dim=1)))
        return torch.cat([out, flow], dim=1)


class SmallUpdateBlock(nn.Module):
    def __init__(self, corr_planes: int, hidden_dim: int = 96, context_dim: int = 64):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_planes)
        self.gru = ConvGRU(hidden_dim, context_dim + 82)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        return net, None, self.flow_head(net)


class BasicUpdateBlock(nn.Module):
    """The update with the convex-upsampling mask head (``mask.0``/``mask.2``),
    its output scaled by 0.25."""

    def __init__(self, corr_planes: int, hidden_dim: int = 128, context_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden_dim, context_dim + 128)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(
            nn.Conv2d(hidden_dim, 256, 3, padding=1), nn.ReLU(), nn.Conv2d(256, 64 * 9, 1)
        )

    def forward(self, net, inp, corr, flow):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], dim=1))
        delta = self.flow_head(net)
        return net, 0.25 * self.mask(net), delta


def coords_grid(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """[B, H, W, 2] (x, y) pixel coordinate grid."""
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1).expand(batch, h, w, 2).contiguous()


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Learned x8 upsampling, NHWC: flow [B, H, W, 2] and mask
    [B, H, W, 576] -> [B, 8H, 8W, 2]. Output pixel (8y + u, 8x + v) is the
    softmax-weighted sum over k of the 3x3 neighbourhood of 8 x flow at
    (y, x), with weight channel ``k*64 + u*8 + v`` and neighbours k in
    (dy, dx) row-major order (zero outside the image)."""
    B, H, W, _ = flow.shape
    m = torch.softmax(mask.reshape(B, H, W, 9, 8, 8), dim=3)
    pad = F.pad(8.0 * flow, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack(
        [pad[:, dy : dy + H, dx : dx + W, :] for dy in range(3) for dx in range(3)], dim=3
    )  # [B, H, W, 9, 2]
    up = torch.einsum("bhwkuv,bhwkc->bhwuvc", m, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, H * 8, W * 8, 2)


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """x8 bilinear corner-aligned upsampling of flow [B, H, W, 2], the
    magnitudes x8."""
    B, H, W, _ = flow.shape
    return 8.0 * resize_bilinear_align_corners(flow, H * 8, W * 8)


def _init_weights(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """torch's default initialization of every conv from ``generator``, then
    the reference extractor's kaiming-normal (fan_out, relu) for the
    encoders' conv weights."""
    for name, m in module.named_modules():
        if isinstance(m, nn.Conv2d):
            init_conv(m, generator)
            if name.startswith(("fnet.", "cnet.")):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu",
                                        generator=generator)


class RAFT(nn.Module):
    """Recurrent all-pairs flow. ``small=True`` is the reference's
    ``SmallRAFT`` (hidden 96, context 64, radius 3, bilinear upsampling),
    else ``RAFT`` (128, 128, radius 4, convex upsampling).

    ``forward(image1, image2)`` with images [B, H, W, 3] in [0, 1] returns
    the list of ``iters`` upsampled flows [B, H, W, 2] fp32.

    ``memory_efficient``: ``True`` takes the on-demand lookup (kernel K2 on
    CUDA tensors, its plain version on the CPU), ``False`` the dense
    all-pairs volume (the JAX package's default). ``None`` chooses by the
    images' device: K2 on the card, where it is faster than the dense route
    and holds no volume, and the dense route on the CPU, where the plain
    on-demand lookup is the slow reference.
    """

    def __init__(
        self,
        small: bool = True,
        iters: int = 12,
        corr_levels: int = 4,
        memory_efficient: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.small = small
        self.iters = iters
        self.corr_levels = corr_levels
        self.memory_efficient = memory_efficient
        self.hidden_dim = 96 if small else 128
        self.context_dim = 64 if small else 128
        self.corr_radius = 3 if small else 4
        corr_planes = corr_levels * (2 * self.corr_radius + 1) ** 2
        self.fnet = Encoder(128 if small else 256, "instance", small)
        self.cnet = Encoder(self.hidden_dim + self.context_dim,
                            "none" if small else "batch", small)
        block = SmallUpdateBlock if small else BasicUpdateBlock
        self.update_block = block(corr_planes, self.hidden_dim, self.context_dim)
        _init_weights(self, generator)

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> List[torch.Tensor]:
        B = image1.shape[0]
        image1 = 2.0 * image1.permute(0, 3, 1, 2) - 1.0
        image2 = 2.0 * image2.permute(0, 3, 1, 2) - 1.0

        # One encoder pass over both frames; fmaps in fp32, NHWC.
        fmaps = self.fnet(torch.cat([image1, image2], dim=0)).float()
        fmaps = fmaps.permute(0, 2, 3, 1).contiguous()
        fmap1, fmap2 = fmaps[:B], fmaps[B:]
        lazy = fmap1.is_cuda if self.memory_efficient is None else self.memory_efficient
        pyramid = build_corr_pyramid(fmap1, fmap2, self.corr_levels, lazy)

        ctx = self.cnet(image1)
        net = torch.tanh(ctx[:, : self.hidden_dim])
        inp = torch.relu(ctx[:, self.hidden_dim:])

        _, H8, W8, _ = fmap1.shape
        coords0 = coords_grid(B, H8, W8, fmap1.device)
        coords1 = coords0.clone()
        flows = []
        for _ in range(self.iters):
            coords1 = coords1.detach()
            corr = corr_pyramid_lookup(pyramid, coords1, self.corr_radius)
            flow = coords1 - coords0
            net, up_mask, delta = self.update_block(
                net, inp, corr.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
            coords1 = coords1 + delta.float().permute(0, 2, 3, 1)
            if up_mask is None:
                flows.append(upflow8(coords1 - coords0))
            else:
                flows.append(upsample_flow_convex(
                    coords1 - coords0, up_mask.float().permute(0, 2, 3, 1)))
        return flows


def SmallRAFT(**kwargs) -> RAFT:
    return RAFT(small=True, **kwargs)


def BasicRAFT(**kwargs) -> RAFT:
    return RAFT(small=False, **kwargs)
