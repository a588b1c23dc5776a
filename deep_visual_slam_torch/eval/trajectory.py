"""Absolute trajectory error with Umeyama alignment (port of
``eval/trajectory.py``: ``positions``, ``umeyama_alignment``,
``ate_rmse``). Host numpy on [N, 4, 4] camera-to-world poses."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def positions(poses: np.ndarray) -> np.ndarray:
    """[N, 4, 4] -> [N, 3] translations."""
    return np.asarray(poses)[:, :3, 3]


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
