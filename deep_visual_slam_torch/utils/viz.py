"""A scene of camera poses and coloured point clouds, rendered headless
(port of ``utils/viz.py``).

``add_pose`` and ``add_pointcloud`` collect the trajectory and the clouds
in numpy (the cloud moved into the world frame and, as in the reference's
display, flipped in y); ``render`` draws them with matplotlib's 3D axes,
optionally from a chase camera behind the newest pose and over a floor
grid, and keeps each rendered frame; ``save_movie`` writes the frames as an
mp4 with cv2. matplotlib and cv2 are imported by the methods that draw and
write.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


class Visualizer:
    def __init__(self, output_dir: str, flip_y: bool = True):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.poses: List[np.ndarray] = []
        self.points: List[np.ndarray] = []
        self.colors: List[np.ndarray] = []
        self.flip_y = flip_y
        self._frames: List[np.ndarray] = []

    def add_pose(self, world_T: np.ndarray) -> None:
        """Append a 4x4 camera-to-world pose to the trajectory."""
        self.poses.append(np.asarray(world_T, np.float64))

    def add_pointcloud(
        self,
        points_cam: np.ndarray,
        colors: np.ndarray,
        world_T: np.ndarray,
        stride: int = 8,
        max_depth: float = 10.0,
    ) -> None:
        """[H, W, 3] camera-frame points and [H, W, 3] colours in [0, 1],
        every ``stride``-th pixel with depth in (0, ``max_depth``), into the
        world by ``world_T``."""
        pts = np.asarray(points_cam)[::stride, ::stride].reshape(-1, 3)
        col = np.asarray(colors)[::stride, ::stride].reshape(-1, 3)
        keep = (pts[:, 2] > 0) & (pts[:, 2] < max_depth)
        pts, col = pts[keep], col[keep]
        R, t = world_T[:3, :3], world_T[:3, 3]
        pts_w = pts @ R.T + t
        if self.flip_y:
            pts_w = pts_w * np.array([1.0, -1.0, 1.0])
        self.points.append(pts_w)
        self.colors.append(np.clip(col, 0, 1))

    def render(
        self,
        out_path: Optional[str] = None,
        elev: float = -70,
        azim: float = -90,
        follow_cam: bool = False,
        follow_radius: float = 5.0,
        floor: bool = False,
    ) -> np.ndarray:
        """The scene as an [H, W, 3] uint8 image (also saved to
        ``out_path``): the clouds (at most 60,000 points, a seeded draw),
        the trajectory in red and the newest camera's frustum in green.
        ``follow_cam`` centres the axes on the newest pose and looks along
        its forward axis from behind and above; ``floor`` draws a grid under
        the clouds."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        if self.points:
            pts = np.concatenate(self.points)
            col = np.concatenate(self.colors)
            n = len(pts)
            if n > 60000:
                sel = np.random.default_rng(0).choice(n, 60000, replace=False)
                pts, col = pts[sel], col[sel]
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=col, s=0.5, alpha=0.6)
        if self.poses:
            traj = np.asarray([T[:3, 3] for T in self.poses])
            if self.flip_y:
                traj = traj * np.array([1.0, -1.0, 1.0])
            ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "r-", linewidth=2)
            self._draw_camera(ax, self.poses[-1])
        if floor and self.points:
            allp = np.concatenate(self.points)
            y0 = float(allp[:, 1].min()) - 0.05
            c0 = allp.mean(axis=0)
            r = max(3.0, follow_radius)
            ticks = np.arange(c0[0] - r, c0[0] + r + 1e-6, r / 4)
            zticks = np.arange(c0[2] - r, c0[2] + r + 1e-6, r / 4)
            for x in ticks:
                ax.plot([x, x], [y0, y0], [zticks[0], zticks[-1]], color="0.8", linewidth=0.5)
            for z in zticks:
                ax.plot([ticks[0], ticks[-1]], [y0, y0], [z, z], color="0.8", linewidth=0.5)
        if follow_cam and self.poses:
            T = self.poses[-1]
            center = T[:3, 3].copy()
            fwd = T[:3, :3][:, 2].copy()
            if self.flip_y:
                center[1] = -center[1]
                fwd[1] = -fwd[1]
            ax.set_xlim(center[0] - follow_radius, center[0] + follow_radius)
            ax.set_ylim(center[1] - follow_radius, center[1] + follow_radius)
            ax.set_zlim(center[2] - follow_radius, center[2] + follow_radius)
            # matplotlib's azimuth turns about z in the x-y plane.
            azim = float(np.degrees(np.arctan2(fwd[1], fwd[0]))) + 180.0
            elev = float(-np.degrees(np.arcsin(np.clip(fwd[2], -1.0, 1.0)))) + 20.0
        ax.view_init(elev=elev, azim=azim)
        ax.set_title("VO scene")
        if out_path is not None:
            fig.savefig(out_path, dpi=100)
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        plt.close(fig)
        self._frames.append(img)
        return img

    def _draw_camera(self, ax, world_T: np.ndarray, size: float = 0.2) -> None:
        """A frustum at the camera pose ``world_T``."""
        corners = np.array([[0, 0, 0], [1, 1, 2], [1, -1, 2], [-1, -1, 2], [-1, 1, 2]]) * size
        R, t = world_T[:3, :3], world_T[:3, 3]
        c = corners @ R.T + t
        if self.flip_y:
            c = c * np.array([1.0, -1.0, 1.0])
        for i in (1, 2, 3, 4):
            ax.plot(*zip(c[0], c[i]), "g-", linewidth=1)
        loop = [1, 2, 3, 4, 1]
        ax.plot(c[loop, 0], c[loop, 1], c[loop, 2], "g-", linewidth=1)

    def save_movie(self, out_path: Optional[str] = None, fps: int = 10) -> Optional[str]:
        """The rendered frames as an mp4v file (default
        ``<output_dir>/scene.mp4``); ``None`` when nothing was rendered."""
        if not self._frames:
            return None
        import cv2

        out_path = out_path or os.path.join(self.output_dir, "scene.mp4")
        h, w = self._frames[0].shape[:2]
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        for f in self._frames:
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        writer.release()
        return out_path
