"""ROS2 message payloads in numpy, usable without rclpy (port of
``ros2/msg_utils.py``): the PointCloud2 byte layout with RGB packed into a
float field, and a rotation matrix's quaternion for the TF transform (the
reference's ``visualizer_node.py:114-195``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pack_rgb_float(colors: np.ndarray) -> np.ndarray:
    """[N, 3] float colours in [0, 1] (clipped) -> [N] float32 whose bits are
    the uint32 ``0x00RRGGBB``: PointCloud2's ``rgb`` field."""
    c = np.clip(colors, 0.0, 1.0)
    r = (c[:, 0] * 255).astype(np.uint32)
    g = (c[:, 1] * 255).astype(np.uint32)
    b = (c[:, 2] * 255).astype(np.uint32)
    return ((r << 16) | (g << 8) | b).view(np.float32)


def pointcloud2_data(points: np.ndarray, colors: np.ndarray) -> Tuple[bytes, int]:
    """xyz points and their colours as PointCloud2's payload: ``(data,
    point_step)``, four float32 fields a point (x, y, z, rgb)."""
    buf = np.empty((len(points), 4), np.float32)
    buf[:, :3] = points.astype(np.float32)
    buf[:, 3] = pack_rgb_float(colors)
    return buf.tobytes(), 16


def rotation_matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """[3, 3] rotation -> (x, y, z, w), by Shepperd's method: the branch of
    the largest of the trace and the diagonal keeps the square root away
    from zero."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w])
