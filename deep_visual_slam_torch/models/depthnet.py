"""Monodepth2-style depth network (port of ``models/depthnet.py``).

The plain decoder formulation only (the JAX package's ``phase_fused=False``);
the phase-fused final stage there is a TPU layout rewrite of the same
function. Parameter names follow the reference torch ``state_dict``: the
decoder is one ``nn.ModuleList`` in construction order, indices 0..9 =
``upconv_{i}_{j}`` for i = 4..0, 10..13 = ``dispconv_{0..3}`` and, with the
uncertainty head, 14 = ``uncconv_0``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from deep_visual_slam_torch.models.resnet import BASE_CH_ENC, ResNetEncoder
from deep_visual_slam_torch.ops.decoder_pad_cuda import decoder_pad

DEC_CHANNELS = (16, 32, 64, 128, 256)
SCALES = (0, 1, 2, 3)


def init_conv(conv: nn.Conv2d, generator: torch.Generator | None) -> None:
    """torch's default ``Conv2d`` initialization, drawn from ``generator``."""
    nn.init.kaiming_uniform_(conv.weight, a=math.sqrt(5), generator=generator)
    if conv.bias is not None:
        bound = 1.0 / math.sqrt(conv.weight[0].numel())
        nn.init.uniform_(conv.bias, -bound, bound, generator=generator)


class ReflectConv3x3(nn.Module):
    """Reflection-pad(1) + 3x3 conv (the reference's ``Conv3x3``).

    ``DepthDecoder`` calls ``self.conv`` on the padded inputs that
    ``decoder_pad`` writes once for all their convs; ``forward``, which pads
    its own input, is the reference the decoder is tested against."""

    def __init__(self, inp: int, out: int):
        super().__init__()
        self.conv = nn.Conv2d(inp, out, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (1, 1, 1, 1), mode="reflect"))


class ConvBlock(nn.Module):
    """ReflectConv3x3 + ELU; ``forward`` is a reference, as
    :class:`ReflectConv3x3`'s is."""

    def __init__(self, inp: int, out: int):
        super().__init__()
        self.conv = ReflectConv3x3(inp, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


class DepthDecoder(nn.ModuleList):
    """Skip-connected upconv decoder over the 5 encoder feature maps.

    ``forward(features)`` -> ``{("disp", s): [B, 1, H/2^s, W/2^s]}`` fp32
    sigmoid disparity for s in 0..3, plus ``("unc", 0)`` when
    ``predict_uncertainty`` (the D3VO sigma head).
    """

    def __init__(
        self,
        num_ch_enc=BASE_CH_ENC,
        predict_uncertainty: bool = False,
        generator: torch.Generator | None = None,
    ):
        convs: List[nn.Module] = []
        for i in range(4, -1, -1):
            inp = num_ch_enc[-1] if i == 4 else DEC_CHANNELS[i + 1]
            convs.append(ConvBlock(inp, DEC_CHANNELS[i]))
            inp = DEC_CHANNELS[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            convs.append(ConvBlock(inp, DEC_CHANNELS[i]))
        for s in SCALES:
            convs.append(ReflectConv3x3(DEC_CHANNELS[s], 1))
        if predict_uncertainty:
            convs.append(ReflectConv3x3(DEC_CHANNELS[0], 1))
        super().__init__(convs)
        self.predict_uncertainty = predict_uncertainty
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                init_conv(m, generator)

    def forward(
        self, features: List[torch.Tensor]
    ) -> Dict[Tuple[str, int], torch.Tensor]:
        # Each padded input is written once, for every conv that reads it:
        # x, the padded output of upconv_i_1, feeds dispconv_i, the next
        # level's upconv_{i-1}_0 and, at level 0, uncconv_0.
        outputs: Dict[Tuple[str, int], torch.Tensor] = {}
        x = decoder_pad(features[-1], elu=False)
        for k, i in enumerate(range(4, -1, -1)):
            y = self[2 * k].conv.conv(x)
            skip = features[i - 1] if i > 0 else None
            y = self[2 * k + 1].conv.conv(decoder_pad(y, skip, up=True))
            x = decoder_pad(y)
            if i in SCALES:
                outputs[("disp", i)] = torch.sigmoid(self[10 + i].conv(x).float())
        if self.predict_uncertainty:
            outputs[("unc", 0)] = torch.sigmoid(self[14].conv(x).float())
        return outputs


class DepthNet(nn.Module):
    """ResNet encoder + decoder producing 4-scale sigmoid disparity.

    ``forward(image[B, H, W, 3])`` -> ``{("disp", s): [B, H/2^s, W/2^s, 1]}``
    fp32, NHWC like the JAX package; NCHW (channels-last strides) inside.
    """

    def __init__(
        self,
        num_layers: int = 18,
        predict_uncertainty: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.encoder = ResNetEncoder(num_layers, 1, generator=generator)
        self.decoder = DepthDecoder(
            self.encoder.num_ch_enc, predict_uncertainty, generator=generator
        )

    def forward(self, x: torch.Tensor) -> Dict[Tuple[str, int], torch.Tensor]:
        out = self.decoder(self.encoder(x.permute(0, 3, 1, 2)))
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}
