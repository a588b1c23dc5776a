"""The port's SLAM, VO-prediction and Depth-Anything CLIs on the CPU.

- ``iter_frames`` and ``depth_colormap`` against the JAX CLI's, over a PNG
  directory and an mp4v video written into ``tmp_path`` (4 frames at
  96x128): equal frames and colours.
- ``slam_cli.main`` in-process on those 4 frames, with the KLT frontend
  (global BA and both videos on) and with ORB: its ``trajectory.npy``
  equal to the port's own ``MonoVO`` driven over the same frames with the
  same options, a loop that ``tests/test_torch_slam.py`` and
  ``tests/test_torch_orb.py`` hold to JAX's (so no JAX ``MonoVO`` is
  compiled here); ``trajectory.png`` written.
- ``predict.main`` on the synthetic source at 64x96 with a params-only
  weights file: a [4, 4, 4] trajectory and the point clouds, equal to a
  loop that calls the networks directly with the JAX CLI's pairing (depth
  on the target, pose on (target, source_right), the config's depth range).
  The same comparison with depth taken on ``source_right`` must fail.
- ``predict_depth_anything.main`` reading a PNG directory with its own
  reader: the frames it hands the model are cv2's RGB, and its
  ``--colormap`` PNG equals what the JAX CLI writes for the same depth (the
  JAX CLI run with its model replaced by that depth, so no JAX program is
  compiled beyond returning it).
"""

import sys

import cv2
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu import slam_cli as jax_slam_cli

from deep_visual_slam_torch import predict, predict_depth_anything, slam_cli
from deep_visual_slam_torch.data.synthetic import synthetic_multidepth_sequence
from deep_visual_slam_torch.ops import backproject, disp_to_depth, transformation_from_parameters
from deep_visual_slam_torch.slam import MonoVO
from deep_visual_slam_torch.training.state import init_vo_models
from deep_visual_slam_torch.utils.checkpoint import save_params_only

torch.set_num_threads(1)

H, W = 96, 128


@pytest.fixture(scope="module")
def frames():
    """4 renders of the piecewise-planar sweep at 96x128, uint8 RGB."""
    f, _, _, _ = synthetic_multidepth_sequence(4, H, W, seed=3, step_translation=0.02,
                                               step_rotation=0.004)
    return (np.clip(f, 0, 1) * 255).round().astype(np.uint8)


def _write_inputs(root, frames):
    (root / "png").mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(root / "png" / f"{i:03d}.png"), cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    (root / "png" / "zz_broken.png").write_bytes(b"not an image")
    writer = cv2.VideoWriter(str(root / "v.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()


def test_iter_frames_and_colormap_match_jax(tmp_path, frames):
    _write_inputs(tmp_path, frames)
    for source in ("png", "v.mp4"):
        for size in ((H, W), (48, 80)):
            got = list(slam_cli.iter_frames(str(tmp_path / source), size))
            want = list(jax_slam_cli.iter_frames(str(tmp_path / source), size))
            assert len(got) == len(want) == 4
            for g, w in zip(got, want):
                assert g.dtype == np.uint8 and g.shape == (*size, 3)
                np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(next(slam_cli.iter_frames(str(tmp_path / "png"), (H, W))),
                                  frames[0])
    depth = np.random.default_rng(0).uniform(-1, 14, (H, W)).astype(np.float32)
    for max_depth in (10.0, 4.0):
        got = slam_cli.depth_colormap(depth, max_depth)
        assert got.dtype == np.uint8 and got.shape == (H, W, 3)
        np.testing.assert_array_equal(got, jax_slam_cli.depth_colormap(depth, max_depth))


@pytest.mark.parametrize("frontend", ["klt", "orb"])
def test_slam_cli_matches_monovo(tmp_path, frames, frontend):
    _write_inputs(tmp_path, frames)
    out = tmp_path / "out"
    extra = (["--global_ba", "--depth_video", "--scene_video"] if frontend == "klt" else [])
    argv = ["--input", str(tmp_path / "png"), "--output", str(out), "--img_h", str(H),
            "--img_w", str(W), "--frontend", frontend, "--num_kf", "4", "--max_points", "64",
            "--device", "cpu", *extra]
    traj = slam_cli.main(argv)
    assert np.array_equal(np.load(out / "trajectory.npy"), traj) and traj.shape == (4, 4, 4)
    assert (out / "trajectory.png").stat().st_size > 0
    if frontend == "klt":
        assert (out / "depth.mp4").stat().st_size > 0 and (out / "scene.mp4").stat().st_size > 0

    args = slam_cli.parser().parse_args(argv)
    K = slam_cli.intrinsic_from_args(args)
    vo = MonoVO(K, image_shape=(H, W), num_kf=4, max_points=64, frontend=frontend,
                fetch_depth=frontend == "orb" or args.depth_video, device="cpu")
    for f in frames:
        vo.process_frame(f)
    if args.global_ba:
        assert vo.mp.global_bundle_adjustment(K)
    want = vo.trajectory()
    assert np.abs(want[-1, :3, 3]).max() > 1e-4  # the camera moved
    np.testing.assert_array_equal(traj, want)


def _predict_config(root):
    import yaml

    cfg = {"Directory": {"data_dir": str(root / "data")},
           "Dataset": {"redwood": {"mono": False}, "synthetic": {"mono": True, "length": 32}},
           "Train": {"img_h": 64, "img_w": 96, "batch_size": 2, "vis_batch_size": 1,
                     "num_workers": 1, "min_depth": 0.5, "max_depth": 20.0}}
    path = root / "vo.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _reference_scene(root, depth_on):
    """The trajectory and clouds of a direct loop over the test split: pose
    on (target, source_right), depth on ``depth_on``."""
    from deep_visual_slam_torch.data.loader import VoDataLoader, device_prefetch
    from deep_visual_slam_torch.utils.config import load_config

    config = load_config(str(_predict_config(root)))
    depth_model, pose_model = init_vo_models(7)
    depth_model.eval(), pose_model.eval()
    save_params_only({"depth": depth_model.state_dict(), "pose": pose_model.state_dict()},
                     str(root / "weights.pt"))
    world, poses, clouds = np.eye(4), [], []
    with torch.no_grad():
        for batch in device_prefetch(VoDataLoader(config).test_loader, "cpu"):
            disps = depth_model(batch[depth_on])
            _, depth = disp_to_depth(disps[("disp", 0)], 0.5, 20.0)
            points = backproject(depth[..., 0], batch["inv_K"])[0].numpy()
            aa, t = pose_model(torch.cat([batch["target_image"], batch["source_right"]], -1))
            world = world @ transformation_from_parameters(aa[:, 0, 0], t[:, 0, 0])[0].numpy()
            poses.append(world)
            pts = points[::8, ::8].reshape(-1, 3)
            pts = pts[(pts[:, 2] > 0) & (pts[:, 2] < 10.0)]
            clouds.append((pts @ world[:3, :3].T + world[:3, 3]) * np.array([1.0, -1.0, 1.0]))
    return np.stack(poses), clouds


def _assert_scene(viz, traj, poses, clouds):
    np.testing.assert_allclose(traj, poses, rtol=0, atol=1e-6)
    assert len(viz.points) == len(clouds)
    for got, want in zip(viz.points, clouds):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_predict_main_matches_direct_nets(tmp_path):
    """``predict.main`` writes ``scene.png`` and the [4, 4, 4] trajectory of
    the direct loop; held to a loop that takes depth on ``source_right``,
    the comparison fails."""
    poses, clouds = _reference_scene(tmp_path, "target_image")
    out = tmp_path / "out"
    viz = predict.main(["--config", str(_predict_config(tmp_path)), "--weights",
                        str(tmp_path / "weights.pt"), "--output", str(out),
                        "--pointcloud_every", "1", "--device", "cpu"])
    traj = np.load(out / "trajectory.npy")
    assert traj.shape == (4, 4, 4) and (out / "scene.png").stat().st_size > 0
    _assert_scene(viz, traj, poses, clouds)
    wrong_poses, wrong_clouds = _reference_scene(tmp_path, "source_right")
    with pytest.raises(AssertionError):
        _assert_scene(viz, traj, wrong_poses, wrong_clouds)


def test_predict_depth_anything_reads_files_and_colormaps(tmp_path, monkeypatch):
    """The CLI's own reader over a PNG directory (one file unreadable,
    skipped), and ``--colormap`` against the JAX CLI's file for the same
    depth; the model is replaced by a recorder of what it is given."""
    from deep_visual_slam_tpu import predict_depth_anything as jax_cli

    rng = np.random.default_rng(5)
    (tmp_path / "imgs").mkdir()
    images = {}
    for name in ("a", "b"):
        images[name] = rng.integers(0, 256, (30, 44, 3), dtype=np.uint8)
        cv2.imwrite(str(tmp_path / "imgs" / f"{name}.png"),
                    cv2.cvtColor(images[name], cv2.COLOR_RGB2BGR))
    (tmp_path / "imgs" / "c.png").write_bytes(b"broken")
    seen, depths = [], []

    def fake_infer(model, rgb, device, dtype):
        seen.append(rgb)
        depths.append(rng.uniform(0.3, 18.0, rgb.shape[:2]).astype(np.float32))
        return depths[-1]

    monkeypatch.setattr(predict_depth_anything, "infer_depth", fake_infer)
    import deep_visual_slam_torch.models.depth_anything as port_da
    import deep_visual_slam_torch.utils.pretrained as port_pretrained

    monkeypatch.setattr(port_da, "DepthAnythingV2", lambda *a, **k: torch.nn.Identity())
    monkeypatch.setattr(port_pretrained, "load_depth_anything_state_dict", lambda *a: {})
    written = predict_depth_anything.main(
        ["--weights", "unused.pth", "--input", str(tmp_path / "imgs"), "--output",
         str(tmp_path / "port"), "--colormap", "--device", "cpu"])
    assert [p.rsplit("/", 1)[1] for p in written] == ["a_depth.png", "b_depth.png"]
    assert len(seen) == 2
    for rgb, name in zip(seen, ("a", "b")):
        assert rgb.dtype == np.uint8
        np.testing.assert_array_equal(rgb, images[name])

    import jax
    import jax.numpy as jnp

    import deep_visual_slam_tpu.models.depth_anything as jda
    import deep_visual_slam_tpu.utils.pretrained as jpretrained

    served = iter(depths)

    class Served:
        def __init__(self, **kwargs):
            pass

        def apply(self, variables, x):
            padded = np.zeros(x.shape[:3], np.float32)
            d = next(served)
            padded[0, : d.shape[0], : d.shape[1]] = d
            return jnp.asarray(padded)

    monkeypatch.setattr(jda, "DepthAnythingV2", Served)
    monkeypatch.setattr(jpretrained, "load_depth_anything_variables", lambda *a: {})
    monkeypatch.setattr(jax, "jit", lambda fn: fn)
    monkeypatch.setattr(sys, "argv", ["predict_depth_anything", "--weights", "unused.pth",
                                      "--input", str(tmp_path / "imgs"), "--output",
                                      str(tmp_path / "jax"), "--colormap"])
    jax_cli.main()
    for name in ("a", "b"):
        for suffix in ("_depth.png", "_depth_vis.png"):
            got = cv2.imread(str(tmp_path / "port" / f"{name}{suffix}"), cv2.IMREAD_UNCHANGED)
            want = cv2.imread(str(tmp_path / "jax" / f"{name}{suffix}"), cv2.IMREAD_UNCHANGED)
            assert got is not None and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
