"""Synthetic fixtures."""

from deep_visual_slam_torch.data.synthetic import (
    default_intrinsics,
    make_oracle_inits,
    plane_depth,
    smooth_texture,
    synthetic_multidepth_sequence,
    synthetic_slam_sequence,
    synthetic_stereo_batch,
    synthetic_vo_batch,
)

__all__ = [
    "default_intrinsics",
    "make_oracle_inits",
    "plane_depth",
    "smooth_texture",
    "synthetic_multidepth_sequence",
    "synthetic_slam_sequence",
    "synthetic_stereo_batch",
    "synthetic_vo_batch",
]
