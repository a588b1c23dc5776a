"""SLAM-loop inference."""

from deep_visual_slam_torch.slam.monovo import Networks

__all__ = ["Networks"]
