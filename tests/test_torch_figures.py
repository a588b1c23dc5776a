"""The port's figures against the JAX package's, on the CPU, drawn by the
same matplotlib (Agg) in the same process: the functions that return
images must return equal arrays, and the files written must decode to
equal pixels. The trainer's validation panel and trajectory plot are held
with a metrics writer whose image sink is a list. No JAX program is
compiled here.
"""

import cv2
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu import slam_cli as jax_slam_cli
from deep_visual_slam_tpu.eval import redwood_eval as jredwood_eval
from deep_visual_slam_tpu.eval import traj_eval as jtraj_eval
from deep_visual_slam_tpu.eval import trajectory as jtrajectory
from deep_visual_slam_tpu.utils import plot as jplot
from deep_visual_slam_tpu.utils import viz as jviz

from deep_visual_slam_torch import slam_cli
from deep_visual_slam_torch.eval import redwood_eval, traj_eval, trajectory
from deep_visual_slam_torch.training.vo_trainer import Trainer
from deep_visual_slam_torch.utils import plot, viz
from deep_visual_slam_torch.utils.config import load_config
from deep_visual_slam_torch.utils.logging import MetricsWriter

torch.set_num_threads(1)


def _walk(rng, n=12, step=0.05):
    """``n`` camera-to-world poses along a random walk with small turns."""
    poses, T = [], np.eye(4)
    for _ in range(n):
        T = T.copy()
        a = rng.normal(0, 0.03, 3)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        T[:3, :3] = T[:3, :3] @ (np.eye(3) + K)
        T[:3, 3] += rng.normal(0, step, 3) + [0, 0, step]
        poses.append(T)
    return np.stack(poses)


def _pixels(path) -> np.ndarray:
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    assert img is not None and img.size > 0, path
    return img


def test_panels_match_jax():
    """``colorize_disparity``, ``vo_panel`` and ``depth_panel``."""
    rng = np.random.default_rng(0)
    disp = rng.uniform(size=(24, 32, 1)).astype(np.float32)
    np.testing.assert_array_equal(plot.colorize_disparity(disp), jplot.colorize_disparity(disp))
    np.testing.assert_array_equal(plot.colorize_disparity(disp[..., 0] * 0),
                                  jplot.colorize_disparity(disp[..., 0] * 0))
    batch = {"target_image": rng.uniform(-0.1, 1.1, (2, 24, 32, 3)).astype(np.float32)}
    outputs = {k: rng.uniform(size=(2, 24, 32, c)).astype(np.float32)
               for k, c in (("color_left_0", 3), ("color_right_0", 3), ("disp_0", 1))}
    for index in (0, 1):
        got = plot.vo_panel(batch, outputs, index)
        assert got.dtype == np.uint8 and got.shape == (24, 128, 3)
        np.testing.assert_array_equal(got, jplot.vo_panel(batch, outputs, index))
    depth = [rng.uniform(0, 12, (24, 32, 1)) for _ in range(2)]
    np.testing.assert_array_equal(plot.depth_panel(batch["target_image"][0], *depth),
                                  jplot.depth_panel(batch["target_image"][0], *depth))


@pytest.mark.parametrize("chase", [False, True])
def test_visualizer_matches_jax(tmp_path, chase):
    """A trajectory with clouds, rendered once from the fixed view (one cloud
    above the 60,000-point cap) and (``chase``) after every pose from the
    follow camera over the floor: equal arrays and PNGs; ``save_movie``'s
    mp4 decodes to the same frames."""
    rng = np.random.default_rng(1)
    poses = _walk(rng, 3)
    vizs = [viz.Visualizer(str(tmp_path / "port")), jviz.Visualizer(str(tmp_path / "jax"))]
    for i, T in enumerate(poses):
        pts = np.concatenate([rng.uniform(-1, 1, (40, 48, 2)),
                              rng.uniform(0.5, 12, (40, 48, 1))], axis=-1)
        big = i == 2 and not chase
        if big:
            pts = np.concatenate([rng.uniform(-1, 1, (250, 250, 2)),
                                  rng.uniform(0.5, 4, (250, 250, 1))], axis=-1)
        colors = rng.uniform(size=pts.shape)
        for v in vizs:
            v.add_pose(T)
            v.add_pointcloud(pts, colors, T, stride=1 if big else 4)
        if chase or i == len(poses) - 1:
            imgs = [v.render(str(tmp_path / f"{n}_{i}.png"), follow_cam=chase, floor=chase)
                    for n, v in zip(("port", "jax"), vizs)]
            assert imgs[0].dtype == np.uint8 and imgs[0].ndim == 3
            np.testing.assert_array_equal(imgs[0], imgs[1])
            np.testing.assert_array_equal(_pixels(tmp_path / f"port_{i}.png"),
                                          _pixels(tmp_path / f"jax_{i}.png"))
    for a, b in zip(vizs[0].points, vizs[1].points):
        np.testing.assert_array_equal(a, b)
    if chase:
        movies = [v.save_movie(fps=5) for v in vizs]
        frames = []
        for path in movies:
            cap = cv2.VideoCapture(path)
            frames.append([])
            ok, f = cap.read()
            while ok:
                frames[-1].append(f)
                ok, f = cap.read()
            cap.release()
        assert len(frames[0]) == len(poses) == len(frames[1])
        for a, b in zip(*frames):
            np.testing.assert_array_equal(a, b)


def test_trajectory_figures_match_jax(tmp_path):
    """``EvalTrajectory.eval_plot`` (with and without ground truth) returns
    JAX's array; ``plot_path_heatmaps`` (with a decision stream),
    ``RedwoodEvaluator._plot_scene`` and the SLAM CLI's
    ``save_trajectory_plot`` write files with JAX's pixels."""
    rng = np.random.default_rng(2)
    gt, pred = _walk(rng), _walk(rng)
    rel = lambda T: np.stack([np.linalg.inv(a) @ b for a, b in zip(T[:-1], T[1:])])
    for with_gt in (True, False):
        tools = [traj_eval.EvalTrajectory(), jtraj_eval.EvalTrajectory()]
        for tool in tools:
            tool.update_state(rel(pred), rel(gt) if with_gt else None)
        got, want = (t.eval_plot("epoch 3") for t in tools)
        assert got.dtype == np.uint8 and got.shape == (600, 800, 3)
        np.testing.assert_array_equal(got, want)

    decision = (rng.uniform(size=len(pred) - 1) < 0.5).astype(np.float64)
    written = [trajectory.plot_path_heatmaps("seq", gt, pred, str(tmp_path / "port"),
                                             decision=decision),
               jtrajectory.plot_path_heatmaps("seq", gt, pred, str(tmp_path / "jax"),
                                              decision=decision)]
    assert [p.rsplit("/", 1)[1] for p in written[0]] == [
        "seq_path_2d.png", "seq_decision_smoothed.png", "seq_speed.png"]
    redwood_eval.RedwoodEvaluator._plot_scene("loft", pred, gt, str(tmp_path / "port" / "s.png"))
    jredwood_eval.RedwoodEvaluator._plot_scene("loft", pred, gt, str(tmp_path / "jax" / "s.png"))
    slam_cli.save_trajectory_plot(pred, str(tmp_path / "port" / "t.png"))
    jax_slam_cli.save_trajectory_plot(pred, str(tmp_path / "jax" / "t.png"))
    names = [p.rsplit("/", 1)[1] for p in written[0]] + ["s.png", "t.png"]
    for name in names:
        np.testing.assert_array_equal(_pixels(tmp_path / "port" / name),
                                      _pixels(tmp_path / "jax" / name))


class ListWriter(MetricsWriter):
    """A metrics writer whose image sink is a list."""

    def __init__(self):
        super().__init__(None)
        self.images = []

    @property
    def takes_images(self) -> bool:
        return True

    def image(self, tag, image, step):
        self.images.append((tag, np.asarray(image), step))


def test_trainer_logs_panel_and_trajectory_plot(tmp_path):
    """``Trainer.validate`` with an image sink logs the first batch's panel
    and the trajectory figure, equal to JAX's ``vo_panel`` and
    ``eval_plot`` on the same arrays; without a sink (``MetricsWriter`` with
    no TensorBoard) it draws nothing."""
    overrides = {
        "Directory": {"exp_name": "t", "data_dir": f"{tmp_path}/data/",
                      "log_dir": f"{tmp_path}/tb", "weights": f"{tmp_path}/weights",
                      "results": f"{tmp_path}/results"},
        "Dataset": {"redwood": {"mono": False}, "synthetic": {"mono": True, "length": 48}},
        "Train": {"img_h": 64, "img_w": 96, "batch_size": 2, "num_workers": 1,
                  "compute_dtype": "float32"},
    }
    tr = Trainer(load_config(overrides=overrides), device="cpu")
    tr.writer.close()
    tr.writer = ListWriter()
    seen = []
    eval_step = tr.eval_step

    def recording(batch, generator):
        outputs, losses = eval_step(batch, generator)
        seen.append(({k: v.float().numpy() for k, v in batch.items()},
                     {k: v.float().numpy() for k, v in outputs.items()}))
        return outputs, losses

    tr.eval_step = recording
    tr.validate(4)
    assert [tag for tag, _, _ in tr.writer.images] == ["valid/panel", "valid/trajectory"]
    assert len(seen) == 3  # 3 valid batches of 2 samples
    np.testing.assert_array_equal(tr.writer.images[0][1], jplot.vo_panel(*seen[0]))
    ref = jtraj_eval.EvalTrajectory()
    for batch, outputs in seen:
        ref.update_state(outputs["cam_T_cam_right"], batch["gt_pose_target_to_right"])
    np.testing.assert_array_equal(tr.writer.images[1][1], ref.eval_plot("epoch 4"))

    quiet = MetricsWriter(None)
    assert not quiet.takes_images
    tr.writer = quiet
    tr.eval_step = eval_step
    tr.validate(5)  # no figure drawn, nothing written
