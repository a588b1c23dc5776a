"""Pinhole camera ops in NHWC (port of ``ops/camera.py``)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from deep_visual_slam_torch import resolve_device


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """[H, W, 2] grid of (x, y) pixel coordinates (x = column index)."""
    device = resolve_device(device)
    xs = torch.arange(width, dtype=dtype, device=device)
    ys = torch.arange(height, dtype=dtype, device=device)
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([x, y], dim=-1)


def backproject(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Depth [B, H, W] or [B, H, W, 1] and inv_K [B, 4, 4] -> camera-frame
    points [B, H, W, 3] = ``depth * inv_K[:3, :3] @ [x, y, 1]``."""
    if depth.dim() == 4:
        depth = depth[..., 0]
    B, H, W = depth.shape
    grid = pixel_grid(H, W, device=depth.device)
    x, y = grid[..., 0], grid[..., 1]
    k = inv_K.float()

    def row(i):
        return (
            k[:, i, 0, None, None] * x
            + k[:, i, 1, None, None] * y
            + k[:, i, 2, None, None]
        )

    rays = torch.stack([row(0), row(1), row(2)], dim=-1)
    return depth.float()[..., None] * rays


def project(
    points: torch.Tensor,
    K: torch.Tensor,
    T: torch.Tensor,
    height: int | None = None,
    width: int | None = None,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Points [B, H, W, 3] through T [B, 4, 4] and K [B, 4, 4] -> sampling
    coordinates [B, H, W, 2] in [-1, 1], align_corners convention:
    divide by (W-1)/(H-1), then ``(c - 0.5) * 2``."""
    B, H, W, _ = points.shape
    height = H if height is None else height
    width = W if width is None else width
    P = (K.float() @ T.float())[:, :3, :]  # [B, 3, 4]
    pts = points.float()

    def row(i):
        return (
            P[:, i, 0, None, None] * pts[..., 0]
            + P[:, i, 1, None, None] * pts[..., 1]
            + P[:, i, 2, None, None] * pts[..., 2]
            + P[:, i, 3, None, None]
        )

    px, py, pz = row(0), row(1), row(2)
    inv_z = 1.0 / (pz + eps)
    u = px * inv_z
    v = py * inv_z
    u = (u / (width - 1) - 0.5) * 2.0
    v = (v / (height - 1) - 0.5) * 2.0
    return torch.stack([u, v], dim=-1)


def make_intrinsics(fx: float, fy: float, cx: float, cy: float, device=None) -> torch.Tensor:
    """4x4 homogeneous intrinsic matrix."""
    K = torch.eye(4, dtype=torch.float32, device=resolve_device(device))
    K[0, 0] = fx
    K[1, 1] = fy
    K[0, 2] = cx
    K[1, 2] = cy
    return K


def scale_intrinsics(K: torch.Tensor, scale_x: float, scale_y: float) -> torch.Tensor:
    """A 4x4 intrinsic [..., 4, 4] for an image resized by (scale_x,
    scale_y): the first row (fx, cx) times scale_x, the second (fy, cy)
    times scale_y."""
    K = K.float().clone()
    K[..., 0, :] *= scale_x
    K[..., 1, :] *= scale_y
    return K


def intrinsics_pyramid(
    K: torch.Tensor, num_scales: int
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-scale ``(K, inv_K)`` pairs, scale s halving the pixel rows s
    times."""
    out = []
    for s in range(num_scales):
        Ks = scale_intrinsics(K, 1.0 / (2**s), 1.0 / (2**s))
        out.append((Ks, torch.linalg.inv(Ks)))
    return out
