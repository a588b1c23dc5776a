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
from deep_visual_slam_torch.ops.depth import (
    compute_depth_errors,
    depth_to_disp,
    disp_to_depth,
    masked_depth_errors,
    silog_loss,
)
from deep_visual_slam_torch.ops.camera import (
    pixel_grid,
    backproject,
    project,
    make_intrinsics,
    scale_intrinsics,
    intrinsics_pyramid,
)
from deep_visual_slam_torch.ops.warp import (
    grid_sample,
    resize_bilinear,
    resize_bilinear_align_corners,
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
    "compute_depth_errors",
    "depth_to_disp",
    "disp_to_depth",
    "masked_depth_errors",
    "silog_loss",
    "pixel_grid",
    "backproject",
    "project",
    "make_intrinsics",
    "scale_intrinsics",
    "intrinsics_pyramid",
    "grid_sample",
    "resize_bilinear",
    "resize_bilinear_align_corners",
    "upsample_nearest_2x",
    "ssim",
    "reprojection_loss",
    "smooth_loss",
    "normalized_smooth_loss",
]
