"""Flow-based pose networks, the reference's experimental family (port of
``models/flow_posenet.py``), NCHW inside.

- :class:`FlowPoseNet`: a frozen SmallRAFT's flow -> three stride-2 convs
  -> global mean -> ``Linear(128, 6)`` -> 6-DoF scaled by 0.01.
- :class:`FlowUpdateModule`: correlation and flow encoders -> a ConvGRU with
  global-context gates (:class:`GlobalContextConvGRU`) -> a pose head.

The JAX package has no torch converter for these heads, so their names
here are the port's own: ``flow_net`` (RAFT in the reference naming),
``conv1``-``conv3`` and ``fc`` in FlowPoseNet; ``convc1``, ``convc2``,
``convf1``, ``convf2``, ``gru`` (``w``, ``convz``, ``convz_glo``, ``convr``,
``convr_glo``, ``convq``, ``convq_glo``), ``conv`` and ``fc`` in
FlowUpdateModule. ``utils/weights.py`` maps the JAX trees onto them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from deep_visual_slam_torch.models.depthnet import init_conv
from deep_visual_slam_torch.models.raft import RAFT


class GlobalContextConvGRU(nn.Module):
    """ConvGRU whose gates add a 1x1 conv of a global context vector: the
    mean over the image of ``sigmoid(w(net)) * net``."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 320):
        super().__init__()
        hp, c = hidden_dim, hidden_dim + input_dim
        self.w = nn.Conv2d(hp, hp, 1)
        self.convz = nn.Conv2d(c, hp, 3, padding=1)
        self.convz_glo = nn.Conv2d(hp, hp, 1)
        self.convr = nn.Conv2d(c, hp, 3, padding=1)
        self.convr_glo = nn.Conv2d(hp, hp, 1)
        self.convq = nn.Conv2d(c, hp, 3, padding=1)
        self.convq_glo = nn.Conv2d(hp, hp, 1)

    def forward(self, net: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
        net_inp = torch.cat([net, inp], dim=1)
        glo = torch.mean(torch.sigmoid(self.w(net)) * net, dim=(2, 3), keepdim=True)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1)) + self.convq_glo(glo))
        return (1 - z) * net + z * q


class FlowUpdateModule(nn.Module):
    """Correlation + flow -> GRU -> 6-DoF twist. NHWC at the boundary:
    ``forward(net, inp, corr, flow)`` with net [B, H, W, 128], inp
    [B, H, W, input_dim], corr [B, H, W, corr_planes], flow [B, H, W, 2]
    -> (net [B, H, W, 128], pose6 [B, 6] fp32)."""

    def __init__(self, corr_planes: int = 196, input_dim: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_planes, 128, 1)
        self.convc2 = nn.Conv2d(128, 128, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 64, 7, padding=3)
        self.convf2 = nn.Conv2d(64, 64, 3, padding=1)
        self.gru = GlobalContextConvGRU(128, input_dim + 128 + 64)
        self.conv = nn.Conv2d(128, 64, 3, padding=1)
        self.fc = nn.Linear(64, 6)
        for m in self.modules():  # torch's defaults (a Linear's are a conv's)
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                init_conv(m, generator)

    def forward(self, net, inp, corr, flow) -> Tuple[torch.Tensor, torch.Tensor]:
        net, inp, corr, flow = (t.permute(0, 3, 1, 2) for t in (net, inp, corr, flow))
        cor = torch.relu(self.convc2(torch.relu(self.convc1(corr))))
        flo = torch.relu(self.convf2(torch.relu(self.convf1(flow))))
        net = self.gru(net, torch.cat([inp, cor, flo], dim=1))
        h = torch.relu(self.conv(net)).mean(dim=(2, 3))
        return net.permute(0, 2, 3, 1), self.fc(h).float()


class FlowPoseNet(nn.Module):
    """SmallRAFT flow -> CNN -> FC -> (axis-angle, translation) x 0.01.

    ``forward(pair[B, H, W, 6])`` (NHWC, frames in [0, 1]) ->
    ``(axisangle[B, 1, 1, 3], translation[B, 1, 1, 3])`` fp32, like
    :class:`~deep_visual_slam_torch.models.posenet.PoseNet`. The flow network
    runs without a gradient (frozen weights, as the JAX package's
    ``stop_gradient``); SmallRAFT's norms keep no running statistics, so it
    computes the same in train and eval mode. Its correlation lookup is
    kernel K2 on the card and the dense volume on the CPU (``RAFT``'s
    ``memory_efficient=None``).
    """

    def __init__(self, iters: int = 12, pose_scale: float = 0.01,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pose_scale = pose_scale
        self.flow_net = RAFT(small=True, iters=iters, generator=generator)
        self.conv1 = nn.Conv2d(2, 32, 7, 2, 3)
        self.conv2 = nn.Conv2d(32, 64, 5, 2, 2)
        self.conv3 = nn.Conv2d(64, 128, 3, 2, 1)
        self.fc = nn.Linear(128, 6)
        for m in (self.conv1, self.conv2, self.conv3, self.fc):
            init_conv(m, generator)

    def forward(self, pair: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            flow = self.flow_net(pair[..., :3], pair[..., 3:])[-1]
        x = flow.permute(0, 3, 1, 2)
        x = torch.relu(self.conv3(torch.relu(self.conv2(torch.relu(self.conv1(x))))))
        pose6 = self.fc(x.mean(dim=(2, 3)))
        pose6 = self.pose_scale * pose6.float().reshape(-1, 1, 1, 6)
        return pose6[..., :3], pose6[..., 3:]
