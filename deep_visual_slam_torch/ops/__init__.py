"""Geometry and photometric ops on NHWC tensors."""

from deep_visual_slam_torch.ops.se3 import (
    rotation_from_axisangle,
    transformation_from_parameters,
    translation_matrix,
    invert_se3,
    axisangle_from_rotation,
    se3_exp,
    se3_inv,
    se3_log,
)
from deep_visual_slam_torch.ops.depth import disp_to_depth
from deep_visual_slam_torch.ops.camera import (
    pixel_grid,
    backproject,
    project,
    make_intrinsics,
)
from deep_visual_slam_torch.ops.warp import (
    grid_sample,
    resize_bilinear,
    upsample_nearest_2x,
)
from deep_visual_slam_torch.ops.photometric import (
    ssim,
    reprojection_loss,
    smooth_loss,
    normalized_smooth_loss,
)

__all__ = [
    "rotation_from_axisangle",
    "transformation_from_parameters",
    "translation_matrix",
    "invert_se3",
    "axisangle_from_rotation",
    "se3_exp",
    "se3_inv",
    "se3_log",
    "disp_to_depth",
    "pixel_grid",
    "backproject",
    "project",
    "make_intrinsics",
    "grid_sample",
    "resize_bilinear",
    "upsample_nearest_2x",
    "ssim",
    "reprojection_loss",
    "smooth_loss",
    "normalized_smooth_loss",
]
