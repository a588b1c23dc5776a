"""PoseNet: 6-DoF relative motion from a stacked image pair (port of
``models/posenet.py``).

Head names follow the reference torch ``state_dict``: ``net.0`` = 1x1
squeeze 512->256, ``net.1``/``net.2`` = 3x3 convs, ``net.3`` = 1x1 to 6.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from deep_visual_slam_torch.models.depthnet import init_conv
from deep_visual_slam_torch.models.resnet import ResNetEncoder


class PoseNet(nn.Module):
    """Axis-angle + translation regressor over ``num_input_images`` frames.

    ``forward(pair[B, H, W, 3*num_input_images])`` (NHWC) ->
    ``(axisangle[B, 1, 1, 3], translation[B, 1, 1, 3])`` fp32, both scaled
    by 0.01.
    """

    def __init__(
        self,
        num_layers: int = 18,
        num_input_images: int = 2,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.encoder = ResNetEncoder(
            num_layers, num_input_images, generator=generator
        )
        self.net = nn.ModuleList([
            nn.Conv2d(self.encoder.num_ch_enc[-1], 256, 1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 6, 1),
        ])
        for conv in self.net:
            init_conv(conv, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self.encoder(x.permute(0, 3, 1, 2))[-1]
        for conv in self.net[:3]:
            out = torch.relu(conv(out))
        out = self.net[3](out)
        out = 0.01 * out.float().mean(dim=(2, 3)).reshape(-1, 1, 1, 6)
        return out[..., :3], out[..., 3:]
