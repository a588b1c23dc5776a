"""The VO inference step as one exported program (port of
``utils/export.py``; the JAX package serialises StableHLO, the port
``torch.export``).

The artifact takes raw uint8 frames and embeds the /255 scaling, the
DepthNet forward with ``disp_to_depth``, and the PoseNet forward over the
``[prev, frame]`` pair with the axis-angle -> 4x4 head, so a consumer feeds
frames and reads depth maps and pose matrices. Its weights are saved in the
``.pt2`` file; it runs on the device it was exported on, at the fixed
``(batch, H, W)`` it was exported at, with the networks in fp32 or, given
``compute_dtype=torch.bfloat16``, under autocast in bf16 (the autocast
region is part of the exported graph; depth, T and the disparity stay
fp32).
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.nn as nn

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.ops import disp_to_depth, transformation_from_parameters


class VOInference(nn.Module):
    """``forward(frame_u8, prev_frame_u8)`` ([B, H, W, 3] uint8 each) ->
    ``(depth[B, H, W], T[B, 4, 4], disp0[B, H, W, 1])`` fp32: the frame's
    depth at scale 0, the ``prev -> frame`` pose and the sigmoid
    disparity. The networks run under autocast in ``compute_dtype``."""

    def __init__(
        self,
        depth_model: nn.Module,
        pose_model: nn.Module,
        min_depth: float = 0.1,
        max_depth: float = 10.0,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.depth_model = depth_model
        self.pose_model = pose_model
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.compute_dtype = compute_dtype

    def forward(
        self, frame_u8: torch.Tensor, prev_frame_u8: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        frame = frame_u8.float() / 255.0
        prev = prev_frame_u8.float() / 255.0
        with torch.autocast(frame.device.type, self.compute_dtype,
                            enabled=self.compute_dtype != torch.float32):
            disp0 = self.depth_model(frame)[("disp", 0)]
            aa, t = self.pose_model(torch.cat([prev, frame], dim=-1))
        _, depth = disp_to_depth(disp0, self.min_depth, self.max_depth)
        T = transformation_from_parameters(aa[:, 0, 0], t[:, 0, 0])
        return depth[..., 0], T, disp0


def make_vo_inference_fn(
    depth_model: nn.Module,
    pose_model: nn.Module,
    min_depth: float = 0.1,
    max_depth: float = 10.0,
    compute_dtype: torch.dtype = torch.float32,
) -> VOInference:
    """The inference step over the two networks in eval mode (eager)."""
    return VOInference(depth_model, pose_model, min_depth, max_depth, compute_dtype).eval()


def export_vo_inference(
    depth_model: nn.Module,
    pose_model: nn.Module,
    path: str,
    image_shape: Tuple[int, int] = (480, 640),
    batch: int = 1,
    min_depth: float = 0.1,
    max_depth: float = 10.0,
    compute_dtype: torch.dtype = torch.float32,
    device=None,
) -> str:
    """Export the VO inference step at uint8 ``[batch, H, W, 3]`` on
    ``device`` (``None`` -> CUDA; the models move there, in eval mode) with
    the networks in ``compute_dtype``, and save it to ``path``
    (``torch.export.save``, a ``.pt2`` file)."""
    device = resolve_device(device)
    H, W = image_shape
    module = make_vo_inference_fn(
        depth_model.to(device), pose_model.to(device), min_depth, max_depth, compute_dtype
    )
    spec = torch.zeros(batch, H, W, 3, dtype=torch.uint8, device=device)
    with torch.no_grad():
        exported = torch.export.export(module, (spec, spec.clone()))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path)
    return path


def load_exported(path: str) -> nn.Module:
    """The saved program as a callable module,
    ``load_exported(path)(frame_u8, prev_frame_u8)``, its weights frozen (an
    inference artifact: the outputs carry no autograd graph)."""
    return torch.export.load(path).module().requires_grad_(False)
