"""The port's Redwood evaluation against the JAX package, on the CPU.

- ``load_posegraph_json`` (column-major nodes) and ``load_intrinsic`` on
  files the test writes: equal to JAX's.
- ``ate_rmse`` with and without ``reference_scale_bug``: rtol 1e-12 (the
  same float64 numpy on both sides).
- ``RedwoodEvaluator`` on a tree of 2 scenes x 8 frames at 64x96 written
  with cv2: JAX's evaluator runs its ``PoseNet`` with the port's weights
  (``convert_posenet``) and reads the JPEGs itself; the port's, through the
  CLI's ``evaluate_redwood``, reads them with the test's own cv2 reader
  (a caller's reader). Every key of the result dicts and every
  CSV row: rtol 2e-4, atol 1e-6. XLA and PyTorch sum the networks'
  convolutions in other orders, and the scale correction (a median ratio
  of translations of ~1e-3) and the alignment carry that into every
  metric: at most 6.1e-5 relative measured (the rotation RPE's spread).
- ``eval_redwood_cli.main``: without a card it raises unless given the CPU,
  and without an image reader of the caller's it reads with cv2.
- ``scripts/jax_checkpoint_to_torch.py`` on a JAX VO checkpoint written by
  the JAX package's ``CheckpointManager``: the port reads back exactly
  ``depthnet_from_jax``/``posenet_from_jax`` of the same variables.

One JAX program is compiled: the evaluator's PoseNet step.
"""

import csv
import importlib.util
import json
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.data import redwood as jax_redwood
from deep_visual_slam_tpu.eval import trajectory as jax_trajectory
from deep_visual_slam_tpu.eval.redwood_eval import RedwoodEvaluator as JaxRedwoodEvaluator
from deep_visual_slam_tpu.eval.redwood_eval import make_pose_fn as jax_make_pose_fn
from deep_visual_slam_tpu.models import PoseNet as JaxPoseNet
from deep_visual_slam_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from deep_visual_slam_tpu.utils.torch_weights import convert_depthnet, convert_posenet

from deep_visual_slam_torch import eval_redwood_cli
from deep_visual_slam_torch.data import redwood
from deep_visual_slam_torch.eval import trajectory
from deep_visual_slam_torch.eval.redwood_eval import CSV_COLUMNS
from deep_visual_slam_torch.eval_depth_cli import load_depth_weights
from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.slam.monovo import Networks
from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

H, W = 64, 96
FRAMES = 8
SCENES = ("apartment", "bedroom")
ROOT = Path(__file__).resolve().parents[1]


def _trajectory(rng, n):
    """Camera-to-world poses of a smooth sweep with a little noise."""
    poses = []
    for i in range(n):
        a = 0.05 * i + 0.01 * rng.normal()
        c, s = np.cos(a), np.sin(a)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        T[:3, 3] = [0.1 * i, 0.02 * np.sin(i), 0.05 * i] + 0.005 * rng.normal(size=3)
        poses.append(T)
    return np.asarray(poses)


def _write_tree(root: Path, rng) -> None:
    for scene in SCENES:
        scene_dir = root / "test" / scene
        (scene_dir / "image").mkdir(parents=True)
        base = rng.uniform(size=(H, W, 3))
        for i in range(FRAMES):
            img = np.clip(np.roll(base, 2 * i, axis=1) + 0.1 * rng.uniform(size=(H, W, 3)), 0, 1)
            cv2.imwrite(str(scene_dir / "image" / f"{i:06d}.jpg"), (img * 255).astype(np.uint8))
        nodes = [{"pose": T.flatten(order="F").tolist()} for T in _trajectory(rng, FRAMES)]
        (scene_dir / f"{scene}.json").write_text(json.dumps({"nodes": nodes}))


def _read_image(path, height, width):
    img = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    if img.shape[:2] != (height, width):
        img = cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)
    return img


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def test_posegraph_and_intrinsic_match_jax(tmp_path, rng):
    poses = _trajectory(rng, 5)
    path = tmp_path / "scene.json"
    path.write_text(json.dumps({"nodes": [{"pose": T.flatten(order="F").tolist()}
                                          for T in poses]}))
    got, want = redwood.load_posegraph_json(str(path)), jax_redwood.load_posegraph_json(str(path))
    assert len(got) == len(want) == 5
    for a, b, T in zip(got, want, poses):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, T, atol=1e-6)  # the translation in the last column
    for size in ((480, 640), (240, 320)):  # the published camera, then the file's
        np.testing.assert_array_equal(redwood.load_intrinsic(str(tmp_path), size),
                                      jax_redwood.load_intrinsic(str(tmp_path), size))
        np.save(tmp_path / "intrinsic.npy", np.array([[500.0, 0, 320], [0, 510.0, 240],
                                                      [0, 0, 1]]))
    assert redwood.TEST_SCENES == jax_redwood.TEST_SCENES
    np.testing.assert_array_equal(redwood.REDWOOD_DEFAULT_K3, jax_redwood.REDWOOD_DEFAULT_K3)


@pytest.mark.parametrize("reference_scale_bug", [False, True])
def test_ate_rmse_matches_jax(rng, reference_scale_bug):
    gt = _trajectory(rng, 12)
    pred = gt.copy()
    pred[:, :3, 3] = 0.5 * pred[:, :3, 3] + 0.01 * rng.normal(size=(12, 3))
    got = trajectory.ate_rmse(pred, gt, reference_scale_bug=reference_scale_bug)
    want = jax_trajectory.ate_rmse(pred, gt, reference_scale_bug=reference_scale_bug)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-12, atol=1e-12)
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], rtol=1e-12, err_msg=k)


def test_redwood_evaluator_matches_jax(tmp_path, rng):
    _write_tree(tmp_path, rng)
    pose = PoseNet(generator=torch.Generator().manual_seed(3))
    variables = convert_posenet(_numpy(pose.state_dict()))
    jax_fn = jax_make_pose_fn(JaxPoseNet(), variables, invert=True)
    want = JaxRedwoodEvaluator(jax_fn, str(tmp_path), image_size=(H, W)).evaluate(
        scenes=SCENES + ("loft",))
    out = tmp_path / "out"
    got, trajectories = eval_redwood_cli.evaluate_redwood(
        pose, str(tmp_path), (H, W), str(out), scenes=SCENES + ("loft",),
        read_image=_read_image, device="cpu")
    assert [r["scene"] for r in got] == [r["scene"] for r in want] == list(SCENES)
    assert list(trajectories) == list(SCENES)
    assert all(a.shape == g.shape == (FRAMES, 4, 4) for a, g in trajectories.values())
    summary = json.loads((out / "summary.json").read_text())
    for ours, theirs, saved in zip(got, want, summary):
        assert ours.keys() == theirs.keys() == saved.keys()
        assert "ate_rmse_reference_umeyama" in ours
        assert ours["num_pairs"] == theirs["num_pairs"] == FRAMES - 1
        for k, v in theirs.items():
            if k != "scene":
                np.testing.assert_allclose(ours[k], v, rtol=2e-4, atol=1e-6, err_msg=k)
                np.testing.assert_allclose(saved[k], ours[k], rtol=1e-12, err_msg=k)

        # The CSV rows against JAX's per-pair errors of its own predictions.
        evaluator = JaxRedwoodEvaluator(jax_fn, str(tmp_path), image_size=(H, W))
        files, poses_gt = evaluator._scene_frames(theirs["scene"])
        rel_pred = evaluator.predict_scene_relatives(files).copy()
        rel_pred[:, :3, 3] *= theirs["scale_factor"]
        with open(out / f"{theirs['scene']}_pairs.csv") as f:
            rows = list(csv.reader(f))
        assert tuple(rows[0]) == CSV_COLUMNS
        assert len(rows) == FRAMES
        for i, row in enumerate(rows[1:]):
            g = jax_trajectory.relative_pose(poses_gt[i], poses_gt[i + 1])
            pos_e, rot_e, pos_d, rot_d = jax_trajectory.pose_error(g, rel_pred[i])
            assert int(row[0]) == i
            np.testing.assert_allclose([float(v) for v in row[1:]],
                                       [pos_e, rot_e, *pos_d, *rot_d], rtol=2e-4, atol=1e-6)


def test_eval_redwood_cli_needs_a_card_and_a_reader(tmp_path, rng):
    """No card: the default device refuses (no fallback). With ``--device
    cpu`` the CLI reads the frames itself (cv2) and gives what the evaluator
    gives with the test's reader, and writes the scene's figures."""
    import yaml

    _write_tree(tmp_path, rng)
    cfg = tmp_path / "vo.yaml"
    cfg.write_text(yaml.safe_dump({"Train": {"img_h": H, "img_w": W}}))
    args = ["--config", str(cfg), "--data_root", str(tmp_path),
            "--output", str(tmp_path / "out"), "--scenes", "apartment"]
    if not torch.cuda.is_available():  # no fallback: the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            eval_redwood_cli.main(args)
    got = eval_redwood_cli.main(args + ["--device", "cpu"])
    want, _ = eval_redwood_cli.evaluate_redwood(
        PoseNet(generator=torch.Generator().manual_seed(0)), str(tmp_path), (H, W),
        str(tmp_path / "want"), scenes=("apartment",), read_image=_read_image, device="cpu")
    assert got == want
    for name in ("apartment_trajectory.png", "apartment_path_2d.png", "apartment_speed.png"):
        assert (tmp_path / "out" / name).stat().st_size > 0
        assert not (tmp_path / "want" / name).exists()


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_torch", ROOT / "scripts" / "jax_checkpoint_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_jax_checkpoint_converter(tmp_path):
    """A JAX VO trainer checkpoint (params and batch_stats of both networks,
    with random running statistics) through the converter script, read back
    by ``Networks.from_checkpoint``, ``load_depth_weights`` and
    ``load_pose_weights``."""
    rng = np.random.default_rng(8)
    trees = {}
    for name, net, convert in (("depth", DepthNet(generator=torch.Generator().manual_seed(1)),
                                convert_depthnet),
                               ("pose", PoseNet(generator=torch.Generator().manual_seed(2)),
                                convert_posenet)):
        sd = _numpy(net.state_dict())
        for k in sd:
            if k.endswith(("running_mean", "running_var")):
                sd[k] = rng.uniform(0.5, 1.5, size=sd[k].shape).astype(np.float32)
        trees[name] = convert(sd)
    state = types.SimpleNamespace(
        params={k: v["params"] for k, v in trees.items()},
        batch_stats={k: v["batch_stats"] for k, v in trees.items()},
        opt_state={"count": np.zeros((), np.int32)}, step=np.int32(7))
    ckpt = tmp_path / "jax_ckpt"
    manager = JaxCheckpointManager(str(ckpt))
    manager.save(7, state)
    manager.close()

    out = tmp_path / "port.pt"
    _load_script().main(["--ckpt", str(ckpt), "--out", str(out),
                         "--config", str(ROOT / "configs" / "vo.yaml")])
    want = {"depth": depthnet_from_jax(trees["depth"]), "pose": posenet_from_jax(trees["pose"])}
    depth, pose = DepthNet(), PoseNet()
    load_depth_weights(depth, str(out))
    eval_redwood_cli.load_pose_weights(pose, str(out))
    nets = Networks.from_checkpoint(str(out), dtype=torch.float32, device="cpu")
    for name, model in (("depth", depth), ("pose", pose), ("depth", nets.depth_model),
                        ("pose", nets.pose_model)):
        got = model.state_dict()
        assert got.keys() == want[name].keys()
        for k, v in want[name].items():
            if not k.endswith("num_batches_tracked"):
                torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)
