"""Trajectory metrics (port of ``eval/trajectory.py``): Umeyama alignment
and ATE, relative pose error, the monocular scale correction, KITTI
segment errors and trajectory accumulation. Host numpy on [N, 4, 4]
camera-to-world poses.

``umeyama_alignment`` uses the normalized scale only; the JAX package's
``reference_scale_bug`` side-by-side mode has no caller in the port.
``plot_path_heatmaps`` (matplotlib) is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KITTI_SEGMENT_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)


def positions(poses: np.ndarray) -> np.ndarray:
    """[N, 4, 4] -> [N, 3] translations."""
    return np.asarray(poses)[:, :3, 3]


def accumulate_trajectory(
    rel_poses: Sequence[np.ndarray], T0: Optional[np.ndarray] = None
) -> np.ndarray:
    """Compose relative poses into absolute ones, the start pose first:
    [len(rel_poses) + 1, 4, 4]."""
    T = np.eye(4) if T0 is None else np.asarray(T0, np.float64)
    out = [T.copy()]
    for rel in rel_poses:
        T = T @ np.asarray(rel, np.float64)
        out.append(T.copy())
    return np.asarray(out)


def relative_pose(T1: np.ndarray, T2: np.ndarray) -> np.ndarray:
    """``inv(T1) @ T2``, source -> target."""
    return np.linalg.inv(T1) @ T2


def umeyama_alignment(
    poses_pred: np.ndarray, poses_gt: np.ndarray
) -> Tuple[np.ndarray, float, np.ndarray, np.ndarray]:
    """7-DoF similarity alignment of pred onto gt: (poses_aligned, scale,
    R, t) with ``p_aligned = s R p_pred + t``."""
    p = positions(poses_pred).astype(np.float64)
    g = positions(poses_gt).astype(np.float64)
    mu_p, mu_g = p.mean(axis=0), g.mean(axis=0)
    pc, gc = p - mu_p, g - mu_g
    U, S, Vt = np.linalg.svd(pc.T @ gc)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt = Vt.copy()
        Vt[-1, :] *= -1
        R = Vt.T @ U.T
    var_p = np.mean(np.sum(pc**2, axis=1))
    scale = float(np.sum(S) / (p.shape[0] * var_p)) if var_p > 1e-8 else 1.0
    t = mu_g - scale * R @ mu_p
    aligned = []
    for T in np.asarray(poses_pred, np.float64):
        A = np.eye(4)
        A[:3, :3] = R @ T[:3, :3]
        A[:3, 3] = scale * R @ T[:3, 3] + t
        aligned.append(A)
    return np.asarray(aligned), scale, R, t


def ate_rmse(
    poses_pred: np.ndarray, poses_gt: np.ndarray, align: bool = True
) -> Tuple[float, np.ndarray, Dict]:
    """Absolute trajectory error RMSE after an optional Umeyama alignment:
    (rmse, aligned poses, stats). ``align=False`` gives the unaligned RMSE
    of the positions."""
    if align:
        aligned, scale, _, _ = umeyama_alignment(poses_pred, poses_gt)
    else:
        aligned, scale = np.asarray(poses_pred, np.float64), 1.0
    err = np.linalg.norm(positions(aligned) - positions(poses_gt), axis=1)
    stats = {
        "ate_rmse": float(np.sqrt(np.mean(err**2))),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "ate_std": float(err.std()),
        "umeyama_scale": scale,
    }
    return stats["ate_rmse"], aligned, stats


def rotation_matrix_to_euler(R: np.ndarray) -> np.ndarray:
    """ZYX (roll, pitch, yaw) Euler angles of a rotation matrix."""
    sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy >= 1e-6:
        roll = np.arctan2(R[2, 1], R[2, 2])
        pitch = np.arctan2(-R[2, 0], sy)
        yaw = np.arctan2(R[1, 0], R[0, 0])
    else:
        roll = np.arctan2(-R[1, 2], R[1, 1])
        pitch = np.arctan2(-R[2, 0], sy)
        yaw = 0.0
    return np.array([roll, pitch, yaw])


def rotation_angle_deg(R: np.ndarray) -> float:
    """Geodesic rotation angle of R in degrees."""
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))))


def pose_error(
    T_gt: np.ndarray, T_pred: np.ndarray
) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """(position error in m, rotation error in degrees, position
    difference [3], Euler-angle difference [3])."""
    pos_diff = T_gt[:3, 3] - T_pred[:3, 3]
    rot_error = rotation_angle_deg(T_gt[:3, :3] @ T_pred[:3, :3].T)
    euler_diff = rotation_matrix_to_euler(T_gt[:3, :3]) - rotation_matrix_to_euler(T_pred[:3, :3])
    return float(np.linalg.norm(pos_diff)), rot_error, pos_diff, euler_diff


def rpe(poses_pred: np.ndarray, poses_gt: np.ndarray, delta: int = 1) -> Dict:
    """Relative pose error over the frame pairs ``delta`` apart: mean,
    median and spread of the position (m) and rotation (deg) errors, and
    the per-pair arrays."""
    pos_errs, rot_errs = [], []
    n = min(len(poses_pred), len(poses_gt))
    for i in range(n - delta):
        rel_gt = relative_pose(poses_gt[i], poses_gt[i + delta])
        rel_pred = relative_pose(poses_pred[i], poses_pred[i + delta])
        p, r, _, _ = pose_error(rel_gt, rel_pred)
        pos_errs.append(p)
        rot_errs.append(r)
    pos_errs = np.asarray(pos_errs)
    rot_errs = np.asarray(rot_errs)
    return {
        "rpe_pos_mean": float(pos_errs.mean()),
        "rpe_pos_median": float(np.median(pos_errs)),
        "rpe_pos_std": float(pos_errs.std()),
        "rpe_rot_mean_deg": float(rot_errs.mean()),
        "rpe_rot_median_deg": float(np.median(rot_errs)),
        "rpe_rot_std_deg": float(rot_errs.std()),
        "pos_errors": pos_errs,
        "rot_errors": rot_errs,
    }


def scale_correction_factor(
    rel_gt: Sequence[np.ndarray], rel_pred: Sequence[np.ndarray]
) -> float:
    """Median ratio ``|t_gt| / |t_pred|`` over the pairs where both
    translations exceed 1e-6 (1.0 when none does)."""
    ratios = []
    for g, p in zip(rel_gt, rel_pred):
        gm = np.linalg.norm(g[:3, 3])
        pm = np.linalg.norm(p[:3, 3])
        if gm < 1e-6 or pm < 1e-6:
            continue
        ratios.append(gm / pm)
    return float(np.median(ratios)) if ratios else 1.0


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative path length at each frame."""
    step = np.linalg.norm(np.diff(positions(poses), axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(step)])


def _last_frame_from_segment_length(dist: np.ndarray, first: int, length: float) -> int:
    for i in range(first, len(dist)):
        if dist[i] > dist[first] + length:
            return i
    return -1


def kitti_segment_errors(
    poses_pred: np.ndarray,
    poses_gt: np.ndarray,
    lengths: Sequence[float] = KITTI_SEGMENT_LENGTHS,
    step_size: int = 10,
) -> Tuple[List, float, float]:
    """KITTI segment errors: for every ``step_size``-th first frame and
    every segment length, the rotation and translation error of the
    segment's relative pose per metre. Returns (the list of (first,
    r_err/len, t_err/len, len), the mean t_rel as a fraction per metre,
    the mean r_rel in rad/m)."""
    dist = _trajectory_distances(poses_gt)
    err = []
    for first in range(0, len(poses_gt), step_size):
        for length in lengths:
            last = _last_frame_from_segment_length(dist, first, length)
            if last == -1 or last >= len(poses_pred) or first >= len(poses_pred):
                continue
            delta_gt = relative_pose(poses_gt[first], poses_gt[last])
            delta_pred = relative_pose(poses_pred[first], poses_pred[last])
            E = relative_pose(delta_pred, delta_gt)
            r_err = np.radians(rotation_angle_deg(E[:3, :3]))
            t_err = float(np.linalg.norm(E[:3, 3]))
            err.append((first, r_err / length, t_err / length, length))
    if not err:
        return [], 0.0, 0.0
    arr = np.asarray([(e[1], e[2]) for e in err])
    return err, float(arr[:, 1].mean()), float(arr[:, 0].mean())


def moving_average(x: np.ndarray, w: int) -> np.ndarray:
    """Same-length moving average over a window of ``w``."""
    return np.convolve(np.asarray(x, np.float64), np.ones(w), "same") / w


def speeds_from_poses(poses: np.ndarray, fps: float = 30.0) -> np.ndarray:
    """Per-frame speed (m/s) from consecutive camera positions, 0 first."""
    step = np.linalg.norm(np.diff(positions(poses), axis=0), axis=1)
    return np.concatenate([[0.0], step]) * fps
