"""PoseNet: 6-DoF relative motion from a stacked image pair, and the
legacy two-encoder variant (port of ``models/posenet.py``).

Head names follow the reference torch ``state_dict``: ``net.0`` = 1x1
squeeze 512->256, ``net.1``/``net.2`` = 3x3 convs, ``net.3`` = 1x1 to 6
(to 6 per source frame in :class:`TwoEncoderPoseNet`).
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


class TwoEncoderPoseNet(nn.Module):
    """One shared-weight ResNet encoder run over each of ``num_input_images``
    frames (stacked on the batch), each frame's last feature map squeezed
    to 256 channels, the squeezed maps concatenated on channels, then the
    pose convs to ``6 * (num_input_images - 1)`` outputs.

    ``forward(x[B, H, W, 3*num_input_images])`` (NHWC) ->
    ``(axisangle[B, n-1, 1, 3], translation[B, n-1, 1, 3])`` fp32, scaled
    by 0.01.
    """

    def __init__(
        self,
        num_layers: int = 18,
        num_input_images: int = 2,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.num_input_images = num_input_images
        self.encoder = ResNetEncoder(num_layers, 1, generator=generator)
        n = num_input_images
        self.net = nn.ModuleList([
            nn.Conv2d(self.encoder.num_ch_enc[-1], 256, 1),
            nn.Conv2d(256 * n, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 6 * (n - 1), 1),
        ])
        for conv in self.net:
            init_conv(conv, generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, n = x.shape[0], self.num_input_images
        frames = torch.cat(torch.chunk(x, n, dim=-1), dim=0)
        feats = self.encoder(frames.permute(0, 3, 1, 2))[-1]
        squeezed = torch.relu(self.net[0](feats))
        out = torch.cat(torch.chunk(squeezed, n, dim=0), dim=1)
        for conv in self.net[1:3]:
            out = torch.relu(conv(out))
        out = self.net[3](out)
        out = 0.01 * out.float().mean(dim=(2, 3)).reshape(B, n - 1, 1, 6)
        return out[..., :3], out[..., 3:]
