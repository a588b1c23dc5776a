"""KLT SLAM frontend: a device-tracked table of point slots (port of
``slam/klt_frontend.py:KLTFrontend``).

Per frame, the networks (depth of the current frame, pose prev -> cur), the
current frame's pyramid and the pyramidal Lucas-Kanade update of the track
table run on the device; only the table (P x 2 positions, P flags) and the
4x4 pose come to the host, the depth map stays on the device unless the
caller fetches it. Shi-Tomasi detection refills dead slots at keyframes.
The keyframe score is the reference's ``0.6 f + 0.4 ft > 1`` over tracked
displacements, with the rotation flow removed through ``K R K^-1``.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.ops.klt import (
    build_pyramid,
    rgb_to_gray,
    shi_tomasi_corners,
    track_points,
)
from deep_visual_slam_torch.slam.frontend import Frame, Point


def _f01(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> [0, 1] fp32 (the LK thresholds live in [0, 1] units)."""
    if img.dtype == torch.uint8:
        return img.float() / 255.0
    return img


class KLTFrontend:
    """Fixed-size device track table and the per-frame net + track step.

    ``intrinsic``: the 4x4 (or 3x3) intrinsics for the keyframe score's
    rotation homography ``K R K^-1``. ``device`` must be the networks'
    device; None means CUDA.
    """

    def __init__(
        self,
        networks,
        image_shape: Tuple[int, int],
        intrinsic: np.ndarray,
        max_tracks: int = 256,
        levels: int = 4,
        win: int = 4,
        iters: int = 8,
        max_err: float = 0.08,
        nms_radius: int = 7,
        min_tracks: int = 24,
        device=None,
    ):
        self.device = resolve_device(device)
        if networks.device != self.device:
            raise ValueError(
                f"the networks run on {networks.device}, the frontend on {self.device}"
            )
        self.nn = networks
        self.P = max_tracks
        self.K3 = np.asarray(intrinsic, np.float64)[:3, :3]
        self.levels = levels
        self.win = win
        self.iters = iters
        self.max_err = max_err
        self.min_tracks = min_tracks
        self.nms_radius = nms_radius
        self.image_shape = tuple(image_shape)
        # Wall time of device corner detection (keyframes only).
        self.detect_s = 0.0
        # Host track table.
        self.uv = np.zeros((self.P, 2), np.float32)
        self.alive = np.zeros(self.P, bool)
        self.points: List[Optional[Point]] = [None] * self.P
        self.kf_uv = np.zeros((self.P, 2), np.float32)
        self.kf_alive = np.zeros(self.P, bool)
        # Device mirrors (uploaded at keyframes, chained between frames).
        self._uv_dev = torch.from_numpy(self.uv).to(self.device)
        self._alive_dev = torch.from_numpy(self.alive).to(self.device)
        self._pyr = None

    def _pyramid(self, img: torch.Tensor):
        """[1, H, W, 3] device image -> its gray pyramid."""
        return tuple(build_pyramid(rgb_to_gray(_f01(img)[0]), self.levels))

    # ------------------------------------------------------------- tracking
    @torch.inference_mode()
    def step(self, prev_img_dev: torch.Tensor, cur_img_dev: torch.Tensor):
        """Networks and LK on the device; returns (depth [1, H, W] on the
        device, unc [1, H, W] on the device or None, T_rel [4, 4] numpy) and
        updates the track table on both sides."""
        depth, unc, T = self.nn.step_async(prev_img_dev, cur_img_dev)
        pyr = self._pyramid(cur_img_dev)
        uv2, ok, _ = track_points(
            self._pyr, pyr, self._uv_dev, self._alive_dev,
            win=self.win, iters=self.iters, max_err=self.max_err,
        )
        self._pyr = pyr
        self._uv_dev = uv2
        self._alive_dev = ok
        self.uv = uv2.cpu().numpy().copy()
        self.alive = ok.cpu().numpy().copy()
        return depth, unc, T[0].cpu().numpy().astype(np.float64)

    @torch.inference_mode()
    def init_first(self, img_dev: torch.Tensor) -> None:
        """First frame: its pyramid; the table fills at its keyframe."""
        self._pyr = self._pyramid(img_dev)
        self._refresh_device_state()

    def _refresh_device_state(self) -> None:
        self._uv_dev = torch.from_numpy(self.uv).to(self.device)
        self._alive_dev = torch.from_numpy(self.alive).to(self.device)

    # ------------------------------------------------------------ keyframes
    def keyframe_score(self, pose_global: np.ndarray, last_kf_pose: np.ndarray):
        """Score ``0.6 f + 0.4 ft`` over the tracks alive since the last
        keyframe; None when fewer than ``min_tracks`` are (tracking starved:
        the caller forces a keyframe)."""
        sel = self.kf_alive & self.alive
        n = int(sel.sum())
        if n < self.min_tracks:
            return None
        p1 = self.kf_uv[sel]
        p2 = self.uv[sel]
        d = p1 - p2
        f = float(np.sqrt(np.mean(np.sum(d * d, axis=1))))

        R = last_kf_pose[:3, :3] @ np.linalg.inv(pose_global[:3, :3])
        Ht = self.K3 @ R @ np.linalg.inv(self.K3)
        p = (Ht @ np.concatenate([p2, np.ones((n, 1))], axis=1).T).T
        proj = p[:, :2] / np.maximum(np.abs(p[:, 2:3]), 1e-9) * np.sign(p[:, 2:3])
        dt = p1 - proj
        ft = float(np.sqrt(np.mean(np.sum(dt * dt, axis=1))))
        return 0.6 * f + 0.4 * ft

    def kps_int(self) -> np.ndarray:
        """All P slot positions as in-bounds int (x, y) for ``Frame.kps``
        (round half to even)."""
        H, W = self.image_shape
        x = np.clip(np.round(self.uv[:, 0]), 0, W - 1).astype(np.int32)
        y = np.clip(np.round(self.uv[:, 1]), 0, H - 1).astype(np.int32)
        return np.stack([x, y], axis=1)

    def register_keyframe(self, mp, frame: Frame) -> None:
        """Record the live tracks' observations in this keyframe, re-host
        tracks whose Point was marginalized, and fill dead slots with new
        corners (occupancy-suppressed by the live tracks), in slot order,
        best corner first."""
        for slot in range(self.P):
            if not self.alive[slot]:
                continue
            pt = self.points[slot]
            if pt is not None and pt.valid and frame not in pt.frames:
                pt.add_observation(frame, slot)
            elif pt is None or not pt.valid:
                pt = Point(mp)
                pt.add_observation(frame, slot)
                self.points[slot] = pt

        dead = np.flatnonzero(~self.alive)
        if len(dead):
            t0 = time.perf_counter()
            with torch.inference_mode():
                pts, score = shi_tomasi_corners(
                    self._pyr[0], self.P, nms_radius=self.nms_radius,
                    occupied_uv=self._uv_dev, occupied_mask=self._alive_dev,
                )
                pts, score = pts.cpu().numpy(), score.cpu().numpy()
            self.detect_s += time.perf_counter() - t0
            fresh = np.flatnonzero(score > 0)
            for slot, det_i in zip(dead, fresh):
                self.uv[slot] = pts[det_i]
                self.alive[slot] = True
                pt = Point(mp)
                pt.add_observation(frame, int(slot))
                self.points[slot] = pt
            self._refresh_device_state()

        # The frame's kps were taken before the refill.
        frame.kps = self.kps_int()
        self.kf_uv = self.uv.copy()
        self.kf_alive = self.alive.copy()
        # Slot -> Point-id snapshot for Map._gather_tracks_fast.
        frame.slot_pt_id = np.array(
            [
                self.points[s].id if self.alive[s] and self.points[s] is not None else -1
                for s in range(self.P)
            ],
            np.int64,
        )

    def drop_dead_points(self) -> None:
        """Free the slots whose Point was marginalized; they are re-hosted
        or refilled at the next keyframe."""
        for slot in range(self.P):
            pt = self.points[slot]
            if pt is not None and not pt.valid:
                self.points[slot] = None
