"""Validation-time trajectory evaluation (port of ``eval/traj_eval.py``):
relative poses accumulated batch by batch, composed into absolute
trajectories, scored, and drawn (``eval_plot``, matplotlib imported where
it draws)."""

from __future__ import annotations

import io
from typing import Dict, List

import numpy as np

from deep_visual_slam_torch.eval.trajectory import accumulate_trajectory, ate_rmse, rpe


class EvalTrajectory:
    """Accumulates predicted (and optionally ground-truth) relative poses."""

    def __init__(self):
        self.pred_rel: List[np.ndarray] = []
        self.gt_rel: List[np.ndarray] = []

    def reset(self) -> None:
        self.pred_rel.clear()
        self.gt_rel.clear()

    def update_state(self, pred_rel_batch, gt_rel_batch=None) -> None:
        """Append a [B, 4, 4] batch of relative poses (numpy, or tensors on
        any device)."""
        for T in _host(pred_rel_batch):
            self.pred_rel.append(np.asarray(T, np.float64))
        if gt_rel_batch is not None:
            for T in _host(gt_rel_batch):
                self.gt_rel.append(np.asarray(T, np.float64))

    def trajectories(self):
        """(predicted [N+1, 4, 4], ground truth or None)."""
        pred = accumulate_trajectory(self.pred_rel)
        gt = accumulate_trajectory(self.gt_rel) if self.gt_rel else None
        return pred, gt

    def metrics(self) -> Dict[str, float]:
        """ATE after a sim(3) alignment and the RPE summary, or {} with
        fewer than three ground-truth poses."""
        pred, gt = self.trajectories()
        if gt is None or len(gt) < 3:
            return {}
        _, _, stats = ate_rmse(pred, gt, align=True)
        stats.update({k: v for k, v in rpe(pred, gt).items() if not isinstance(v, np.ndarray)})
        return stats

    def eval_plot(self, title: str = "trajectory") -> np.ndarray:
        """The predicted (and ground-truth) positions in 3D as an [H, W, 3]
        uint8 image: the figure written as a PNG and decoded."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import PIL.Image

        pred, gt = self.trajectories()
        fig = plt.figure(figsize=(8, 6), dpi=100)
        ax = fig.add_subplot(111, projection="3d")
        p = pred[:, :3, 3]
        ax.plot(p[:, 0], p[:, 1], p[:, 2], "b-", label="pred")
        ax.scatter(p[0, 0], p[0, 1], p[0, 2], c="g", marker="o", s=40)
        if gt is not None:
            g = gt[:, :3, 3]
            ax.plot(g[:, 0], g[:, 1], g[:, 2], "r--", label="gt")
        ax.set_title(title)
        ax.legend()
        buf = io.BytesIO()
        fig.savefig(buf, format="png")
        plt.close(fig)
        buf.seek(0)
        return np.asarray(PIL.Image.open(buf).convert("RGB"))


def _host(batch) -> np.ndarray:
    if hasattr(batch, "detach"):
        batch = batch.detach().cpu().numpy()
    return np.asarray(batch)
