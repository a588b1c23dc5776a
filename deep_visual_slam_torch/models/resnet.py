"""ResNet encoder (port of ``models/resnet.py``), NCHW inside.

Parameter names follow the reference torch ``state_dict``
(``encoder.conv1.weight``, ``encoder.layer1.0.bn1.running_mean``, ...), so
the JAX package's ``utils/torch_weights.py`` converters read them directly.
The TPU's space-to-depth stem is not ported: the plain 7x7 stride-2 stem is
the same function.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List

import torch
import torch.nn as nn
import torch.nn.functional as F

STAGE_SIZES = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
# The feature channels of the five maps of ResNet-18/34; deeper nets (the
# bottleneck blocks) have four times as many past the stem.
BASE_CH_ENC = (64, 64, 128, 256, 512)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-statistics rule in train mode.

    flax's ``BatchNorm`` (momentum 0.9, which is torch's 0.1) moves
    ``running_var`` toward the *biased* batch variance; torch's moves it
    toward the unbiased one, n/(n-1) times larger. Train mode here
    normalises as torch does and updates ``running_var`` as flax does.
    While ``update_stats`` is False (the recomputation of a checkpointed
    forward, see :func:`frozen_running_stats`) it computes the same output
    and leaves the running statistics alone. Eval mode and the
    ``state_dict`` names are ``nn.BatchNorm2d``'s.
    """

    update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        # Given zeroed buffers, torch's batch_norm leaves momentum * mean and
        # momentum * var * n/(n-1) in them; (n-1)/n of the latter is
        # momentum times the biased variance.
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        out = F.batch_norm(
            x, mean, var, self.weight, self.bias, True, self.momentum, self.eps
        )
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(mean)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    var, alpha=(n - 1) / n
                )
                self.num_batches_tracked.add_(1)
        return out


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module) -> Iterator[None]:
    """Within the block, ``model``'s :class:`BatchNorm2d` layers leave their
    running statistics alone in train mode."""
    layers = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m in layers:
            m.update_stats = True


def _conv(inp: int, out: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(inp, out, kernel, stride, (kernel - 1) // 2, bias=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (ResNet-18/34)."""

    expansion = 1

    def __init__(self, inp: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inp, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or inp != features:
            self.downsample = nn.Sequential(
                _conv(inp, features, 1, stride), BatchNorm2d(features)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4) with a projection shortcut where the
    shape changes (ResNet-50/101/152, v1.5: the stride on the 3x3)."""

    expansion = 4

    def __init__(self, inp: int, features: int, stride: int = 1):
        super().__init__()
        out = features * self.expansion
        self.conv1 = _conv(inp, features, 1, 1)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, stride)
        self.bn2 = BatchNorm2d(features)
        self.conv3 = _conv(features, out, 1, 1)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or inp != out:
            self.downsample = nn.Sequential(_conv(inp, out, 1, stride), BatchNorm2d(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class _ResNet(nn.Module):
    """The torchvision-named trunk: conv1, bn1, maxpool, layer1..4."""

    def __init__(self, num_layers: int, in_channels: int):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        block = BasicBlock if num_layers <= 34 else BottleneckBlock
        inp = 64
        for stage, (width, n_blocks) in enumerate(
            zip((64, 128, 256, 512), STAGE_SIZES[num_layers])
        ):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(inp, width, stride))
                inp = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class ResNetEncoder(nn.Module):
    """Multi-scale ResNet feature encoder.

    ``forward(x[B, 3*num_input_images, H, W])`` normalizes by
    ``(x - 0.45) / 0.225`` and returns the 5 NCHW feature maps at H/2 ..
    H/32 with channels ``num_ch_enc``: :data:`BASE_CH_ENC`, four times
    past the stem above 34 layers. ``generator`` seeds the initialization
    (kaiming-normal fan-out convs, unit BatchNorm).
    """

    def __init__(
        self,
        num_layers: int = 18,
        num_input_images: int = 1,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if num_layers not in STAGE_SIZES:
            raise ValueError(f"{num_layers} is not a valid resnet depth")
        self.num_ch_enc = BASE_CH_ENC if num_layers <= 34 else (
            (64,) + tuple(4 * c for c in BASE_CH_ENC[1:])
        )
        self.encoder = _ResNet(num_layers, 3 * num_input_images)
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(
                    m.weight, mode="fan_out", nonlinearity="relu",
                    generator=generator,
                )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        e = self.encoder
        x = torch.relu(e.bn1(e.conv1((x - 0.45) / 0.225)))
        features = [x]
        x = e.maxpool(x)
        for layer in (e.layer1, e.layer2, e.layer3, e.layer4):
            x = layer(x)
            features.append(x)
        return features
