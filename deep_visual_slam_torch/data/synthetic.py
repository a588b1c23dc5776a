"""Synthetic VO snippets and stereo pairs with known depth, pose and
intrinsics (port of ``data/synthetic.py``).

A textured slanted plane is rendered into photometrically consistent
(left, target, right) frames with the port's own warp ops, so the VO loss
has a known optimum at the true pose. Textures and poses are drawn with
numpy from ``seed``, as in the JAX package; the rendering runs in torch on
the requested device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.ops import (
    backproject,
    grid_sample,
    invert_se3,
    project,
    transformation_from_parameters,
)


def _box_blur_1d(x: np.ndarray, axis: int, k: int) -> np.ndarray:
    """Zero-padded 'same' box filter along ``axis`` via cumulative sums."""
    h = k // 2
    x = np.moveaxis(x, axis, -1)
    pad = np.zeros(x.shape[:-1] + (x.shape[-1] + k,), np.float64)
    pad[..., h + 1 : h + 1 + x.shape[-1]] = x
    cs = np.cumsum(pad, axis=-1)
    out = (cs[..., k:] - cs[..., :-k]) / k
    return np.moveaxis(out.astype(np.float32), -1, axis)


def smooth_texture(
    rng: np.random.Generator, batch: int, height: int, width: int, sigma: int = 4
) -> np.ndarray:
    """Band-limited random RGB texture in [0, 1] (bilinear-friendly)."""
    base = rng.uniform(size=(batch, height, width, 3)).astype(np.float32)
    k = 2 * sigma + 1
    for axis in (1, 2):
        base = _box_blur_1d(base, axis, k)
    lo = base.min(axis=(1, 2, 3), keepdims=True)
    hi = base.max(axis=(1, 2, 3), keepdims=True)
    return (base - lo) / np.maximum(hi - lo, 1e-6)


def plane_depth(
    batch: int, height: int, width: int, z0: float = 2.0, slope: float = 0.3
) -> np.ndarray:
    """Slanted-plane depth map in meters: z = z0 + slope * (v/H - 0.5)."""
    v = np.linspace(-0.5, 0.5, height, dtype=np.float32)[None, :, None]
    return np.broadcast_to(z0 + slope * v, (batch, height, width)).copy()


def default_intrinsics(height: int, width: int) -> np.ndarray:
    """Redwood-style intrinsics rescaled to the target size (fx=fy=525 at
    640x480), as a 4x4 fp32 matrix."""
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = 525.0 * width / 640.0
    K[1, 1] = 525.0 * height / 480.0
    K[0, 2] = (width - 1) / 2.0
    K[1, 2] = (height - 1) / 2.0
    return K


def synthetic_vo_batch(
    seed: int,
    batch_size: int,
    height: int,
    width: int,
    max_translation: float = 0.05,
    max_rotation: float = 0.01,
    device=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Photometrically consistent (left, target, right) snippet batch.

    Returns ``(batch, truth)``: ``batch`` feeds the VO loss (keys
    source_left/target_image/source_right/K/inv_K), ``truth`` holds the
    generating poses ``T_left``/``T_right`` (target -> source) and the depth.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    target = torch.from_numpy(smooth_texture(rng, batch_size, height, width)).to(device)
    depth = torch.from_numpy(plane_depth(batch_size, height, width)).to(device)
    K = torch.from_numpy(default_intrinsics(height, width)).to(device)
    K = K.expand(batch_size, 4, 4).contiguous()
    inv_K = torch.linalg.inv(K)

    def rand_pose():
        aa = rng.uniform(-max_rotation, max_rotation, size=(batch_size, 3))
        t = rng.uniform(-max_translation, max_translation, size=(batch_size, 3))
        return transformation_from_parameters(
            torch.from_numpy(aa.astype(np.float32)).to(device),
            torch.from_numpy(t.astype(np.float32)).to(device),
        )

    # T maps target-frame points into the source camera; rendering the
    # source view samples the target image at the inverse warp.
    T_left = rand_pose()
    T_right = rand_pose()
    pts = backproject(depth, inv_K)

    def render(T):
        grid = project(pts, K, T)
        return grid_sample(target, grid, align_corners=True, padding_mode="border")

    batch = {
        "source_left": render(invert_se3(T_left)),
        "target_image": target,
        "source_right": render(invert_se3(T_right)),
        "K": K,
        "inv_K": inv_K,
    }
    truth = {"T_left": T_left, "T_right": T_right, "depth": depth}
    return batch, truth


def synthetic_stereo_batch(
    seed: int,
    batch_size: int,
    height: int,
    width: int,
    baseline: float = 0.1,
    device=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Rectified stereo pairs with an exactly known baseline pose.

    The batch of the JAX package's ``SyntheticStereoDataset`` items 0 ..
    batch_size-1 (sample i drawn from ``default_rng((seed, i))``). Returns
    ``(batch, truth)``: ``batch`` feeds the stereo loss (keys source_image /
    target_image / intrinsic / pose, ``pose`` mapping target-frame points
    into the source camera, which sits at +baseline along x), ``truth``
    holds the plane depth.
    """
    device = resolve_device(device)
    textures, depths = [], []
    for i in range(batch_size):
        rng = np.random.default_rng((seed, i))
        textures.append(smooth_texture(rng, 1, height, width))
        depths.append(plane_depth(1, height, width, z0=float(rng.uniform(1.5, 3.0))))
    target = torch.from_numpy(np.concatenate(textures)).to(device)
    depth = torch.from_numpy(np.concatenate(depths)).to(device)
    K = torch.from_numpy(default_intrinsics(height, width)).to(device)
    K = K.expand(batch_size, 4, 4).contiguous()
    T = torch.eye(4, device=device).repeat(batch_size, 1, 1)
    T[:, 0, 3] = -baseline
    grid = project(backproject(depth, torch.linalg.inv(K)), K, invert_se3(T))
    source = grid_sample(target, grid, align_corners=True, padding_mode="border")
    batch = {"source_image": source, "target_image": target, "intrinsic": K, "pose": T}
    return batch, {"depth": depth}
