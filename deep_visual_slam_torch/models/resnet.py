"""ResNet encoder (port of ``models/resnet.py``), NCHW inside.

Parameter names follow the reference torch ``state_dict``
(``encoder.conv1.weight``, ``encoder.layer1.0.bn1.running_mean``, ...), so
the JAX package's ``utils/torch_weights.py`` converters read them directly.
The TPU's space-to-depth stem is not ported: the plain 7x7 stride-2 stem is
the same function.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

STAGE_SIZES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


def _conv(inp: int, out: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(inp, out, kernel, stride, (kernel - 1) // 2, bias=False)


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity shortcut (ResNet-18/34)."""

    def __init__(self, inp: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(inp, features, 3, stride)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = nn.BatchNorm2d(features)
        self.downsample = None
        if stride != 1 or inp != features:
            self.downsample = nn.Sequential(
                _conv(inp, features, 1, stride), nn.BatchNorm2d(features)
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class _ResNet(nn.Module):
    """The torchvision-named trunk: conv1, bn1, maxpool, layer1..4."""

    def __init__(self, num_layers: int, in_channels: int):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inp = 64
        for stage, (width, n_blocks) in enumerate(
            zip((64, 128, 256, 512), STAGE_SIZES[num_layers])
        ):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(BasicBlock(inp, width, stride))
                inp = width
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))


class ResNetEncoder(nn.Module):
    """Multi-scale ResNet feature encoder.

    ``forward(x[B, 3*num_input_images, H, W])`` normalizes by
    ``(x - 0.45) / 0.225`` and returns the 5 NCHW feature maps at H/2 ..
    H/32 with channels ``num_ch_enc``. ``generator`` seeds the
    initialization (kaiming-normal fan-out convs, unit BatchNorm).
    """

    num_ch_enc = (64, 64, 128, 256, 512)

    def __init__(
        self,
        num_layers: int = 18,
        num_input_images: int = 1,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if num_layers not in STAGE_SIZES:
            raise ValueError(
                f"ResNet-{num_layers} is not ported (BasicBlock depths "
                f"{sorted(STAGE_SIZES)} only)"
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
