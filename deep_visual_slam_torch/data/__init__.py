"""Synthetic fixtures."""

from deep_visual_slam_torch.data.synthetic import (
    default_intrinsics,
    plane_depth,
    smooth_texture,
    synthetic_stereo_batch,
    synthetic_vo_batch,
)

__all__ = [
    "default_intrinsics",
    "plane_depth",
    "smooth_texture",
    "synthetic_stereo_batch",
    "synthetic_vo_batch",
]
