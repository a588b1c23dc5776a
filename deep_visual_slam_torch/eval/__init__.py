"""Trajectory evaluation."""

from deep_visual_slam_torch.eval.traj_eval import EvalTrajectory
from deep_visual_slam_torch.eval.trajectory import (
    accumulate_trajectory,
    ate_rmse,
    kitti_segment_errors,
    moving_average,
    pose_error,
    positions,
    relative_pose,
    rotation_angle_deg,
    rotation_matrix_to_euler,
    rpe,
    scale_correction_factor,
    speeds_from_poses,
    umeyama_alignment,
)

__all__ = [
    "EvalTrajectory",
    "accumulate_trajectory",
    "ate_rmse",
    "kitti_segment_errors",
    "moving_average",
    "pose_error",
    "positions",
    "relative_pose",
    "rotation_angle_deg",
    "rotation_matrix_to_euler",
    "rpe",
    "scale_correction_factor",
    "speeds_from_poses",
    "umeyama_alignment",
]
