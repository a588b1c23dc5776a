"""Trajectory evaluation."""

from deep_visual_slam_torch.eval.trajectory import ate_rmse, positions, umeyama_alignment

__all__ = ["ate_rmse", "positions", "umeyama_alignment"]
