"""The SLAM loop: networks, KLT frontend, keyframe map, windowed and global BA."""

from deep_visual_slam_torch.slam.frontend import Frame, Point
from deep_visual_slam_torch.slam.klt_frontend import KLTFrontend
from deep_visual_slam_torch.slam.map import Map
from deep_visual_slam_torch.slam.monovo import MonoVO, Networks

__all__ = ["Frame", "KLTFrontend", "Map", "MonoVO", "Networks", "Point"]
