"""Trajectory and depth evaluation."""

from deep_visual_slam_torch.eval.metrics import DepthMetrics
from deep_visual_slam_torch.eval.redwood_eval import RedwoodEvaluator, make_pose_fn
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
    "DepthMetrics",
    "EvalTrajectory",
    "RedwoodEvaluator",
    "make_pose_fn",
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
