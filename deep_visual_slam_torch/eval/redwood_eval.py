"""Offline Redwood trajectory evaluation (port of ``eval/redwood_eval.py``).

For each test scene: the pose network's relative pose for every pair of
consecutive frames (``invert=True``, the reference's convention), the
ground-truth relative poses ``inv(T1) @ T2`` from the scene's PoseGraph,
an optional median-translation-ratio scale correction, per-pair errors,
and the trajectory's ATE (Umeyama-aligned, and with the reference's
unnormalized scale beside it), RPE and KITTI segment errors.

The port has no image decoder (the card's machine has none): frames come
through ``read_image(path, H, W) -> uint8 [H, W, 3] RGB``, which the caller
supplies; without one the evaluator raises (the file readers are
``ROADMAP.md`` §1, item 1f). The per-pair CSV is written with the ``csv``
module; the trajectory figures (matplotlib) are not ported (item 7).
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device
from deep_visual_slam_torch.data.redwood import TEST_SCENES, load_posegraph_json
from deep_visual_slam_torch.eval.trajectory import (
    accumulate_trajectory,
    ate_rmse,
    kitti_segment_errors,
    pose_error,
    relative_pose,
    rpe,
    scale_correction_factor,
)
from deep_visual_slam_torch.ops.se3 import transformation_from_parameters

CSV_COLUMNS = ("pair", "pos_error_m", "rot_error_deg", "dx", "dy", "dz",
               "droll", "dpitch", "dyaw")


def make_pose_fn(
    pose_model: torch.nn.Module, invert: bool = True, batch_size: int = 16, device=None
) -> Callable[[np.ndarray], np.ndarray]:
    """A pair -> relative-pose predictor: ``pairs`` [N, H, W, 6] float in
    [0, 1] -> [N, 4, 4] from ``pose_model`` (any network returning
    ``(axisangle, translation)`` [B, 1, 1, 3]; moved to ``device``, in eval
    mode, without a gradient), in chunks of ``batch_size`` pairs."""
    device = resolve_device(device)
    pose_model.to(device).eval()

    @torch.inference_mode()
    def predict(pairs: np.ndarray) -> np.ndarray:
        out = []
        for i in range(0, pairs.shape[0], batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(pairs[i : i + batch_size]))
            aa, t = pose_model(chunk.to(device))
            T = transformation_from_parameters(aa[:, 0, 0], t[:, 0, 0], invert=invert)
            out.append(T.float().cpu().numpy())
        return np.concatenate(out, axis=0)

    return predict


class RedwoodEvaluator:
    """Offline evaluation over the Redwood scenes under ``root_dir/fold``."""

    def __init__(
        self,
        pose_fn: Callable[[np.ndarray], np.ndarray],
        root_dir: str,
        image_size=(480, 640),
        fold: str = "test",
        read_image: Optional[Callable[[str, int, int], np.ndarray]] = None,
    ):
        self.pose_fn = pose_fn
        self.root_dir = root_dir
        self.image_size = image_size
        self.fold = fold
        self.read_image = read_image

    def _scene_frames(self, scene: str):
        scene_dir = os.path.join(self.root_dir, self.fold, scene)
        images = sorted(glob.glob(os.path.join(scene_dir, "image", "*.jpg")))
        poses = load_posegraph_json(os.path.join(scene_dir, f"{scene}.json"))
        n = min(len(images), len(poses))
        return images[:n], np.asarray(poses[:n])

    def predict_scene_relatives(self, image_files: Sequence[str]) -> np.ndarray:
        """The predicted relative pose of every consecutive pair [N-1, 4, 4]."""
        if self.read_image is None:
            raise NotImplementedError(
                "RedwoodEvaluator needs read_image(path, H, W) -> uint8 [H, W, 3] RGB: "
                "the port has no image decoder (ROADMAP.md §1, item 1f)"
            )
        H, W = self.image_size
        frames = [self.read_image(p, H, W).astype(np.float32) / 255.0 for p in image_files]
        pairs = np.stack([
            np.concatenate([frames[i], frames[i + 1]], axis=-1)
            for i in range(len(frames) - 1)
        ])
        return self.pose_fn(pairs)

    def evaluate_scene(
        self, scene: str, output_dir: Optional[str] = None, use_scale_correction: bool = True
    ) -> Dict:
        """The scene's metrics (the JAX package's keys); with ``output_dir``
        also ``{scene}_pairs.csv``, one row of :data:`CSV_COLUMNS` a pair."""
        image_files, poses_gt = self._scene_frames(scene)
        rel_pred = self.predict_scene_relatives(image_files)
        rel_gt = np.stack([
            relative_pose(poses_gt[i], poses_gt[i + 1]) for i in range(len(poses_gt) - 1)
        ])

        scale = 1.0
        if use_scale_correction:
            scale = scale_correction_factor(rel_gt, rel_pred)
            rel_pred = rel_pred.copy()
            rel_pred[:, :3, 3] *= scale

        rows = []
        for i, (g, p) in enumerate(zip(rel_gt, rel_pred)):
            pos_e, rot_e, pos_d, rot_d = pose_error(g, p)
            rows.append([i, pos_e, rot_e, *pos_d, *rot_d])

        traj_pred = accumulate_trajectory(rel_pred, poses_gt[0])
        _, _, ate_stats = ate_rmse(traj_pred, poses_gt, align=True)
        ref_ate, _, _ = ate_rmse(traj_pred, poses_gt, align=True, reference_scale_bug=True)
        rpe_stats = {
            k: v for k, v in rpe(traj_pred, poses_gt).items() if not isinstance(v, np.ndarray)
        }
        _, t_rel, r_rel = kitti_segment_errors(traj_pred, poses_gt)
        result = {
            "scene": scene,
            "num_pairs": len(rows),
            "scale_factor": scale,
            **ate_stats,
            "ate_rmse_reference_umeyama": ref_ate,
            **rpe_stats,
            "kitti_t_rel_pct": t_rel * 100.0,
            "kitti_r_rel_deg_per_100m": np.degrees(r_rel) * 100.0,
        }

        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir, f"{scene}_pairs.csv"), "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(CSV_COLUMNS)
                writer.writerows([[row[0]] + [float(v) for v in row[1:]] for row in rows])
        return result

    def evaluate(
        self,
        scenes: Sequence[str] = TEST_SCENES,
        output_dir: Optional[str] = None,
        use_scale_correction: bool = True,
    ) -> List[Dict]:
        """:meth:`evaluate_scene` of each scene found under the fold; a
        missing scene is skipped with a warning."""
        results = []
        for scene in scenes:
            if not os.path.isdir(os.path.join(self.root_dir, self.fold, scene)):
                print(f"Warning: scene '{scene}' not found, skipping")
                continue
            results.append(self.evaluate_scene(scene, output_dir, use_scale_correction))
        return results
