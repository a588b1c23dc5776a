"""The port's MarsLogger, capture-rig, IRS and stereo sources against the
JAX package's, on the CPU, on scenes written into ``tmp_path`` as
``tests/test_handlers.py`` writes them (a 12-frame mp4v video, JPEG and PNG
frames at 60x80 and 54x96, read at 48x64 and at the files' size).

Both packages decode and encode with the same cv2: the frames extracted
from a video must be the same JPEG bytes, and every sample must equal
JAX's, drawn from the same generator (jittered images within the hue
step's 1e-5, ``tests/test_torch_data.py``). JAX's float triplet read takes
its cv2 route (its native resize answering ``None``): the port reads as
that route does (``tests/test_torch_io.py`` states the gap to the native
one). No JAX program is compiled here.
"""

import json

import cv2
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu import native as jnative
from deep_visual_slam_tpu.data import handlers as jhandlers

from deep_visual_slam_torch.data import handlers

torch.set_num_threads(1)

SIZES = ((48, 64), (60, 80))


@pytest.fixture(autouse=True)
def _cv2_route(monkeypatch):
    monkeypatch.setattr(jnative, "resize_normalize_batch", lambda *a, **k: None)


def _frames(rng, n, h, w):
    return (rng.uniform(size=(n, h, w, 3)) * 255).astype(np.uint8)


def _assert_equal_samples(port_ds, jax_ds, seeds=range(3), image_atol=1e-5):
    assert len(port_ds) == len(jax_ds) > 0
    for idx in range(len(jax_ds)):
        for seed in seeds:
            rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = port_ds.__getitem__(idx, rng_p), jax_ds.__getitem__(idx, rng_j)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                atol = image_atol if got[k].ndim == 3 else 0.0
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
            assert rng_p.uniform() == rng_j.uniform()


def _mars_scene(root, rng):
    scene = root / "train" / "scene_0"
    scene.mkdir(parents=True)
    writer = cv2.VideoWriter(str(scene / "movie.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (80, 60))
    for frame in _frames(rng, 12, 60, 80):
        writer.write(frame)
    writer.release()
    calib = root / "calibration_results"
    calib.mkdir()
    (calib / "calibration_results.json").write_text(
        json.dumps({"image_height": 60, "image_width": 80}))
    np.save(calib / "camera_matrix.npy", np.array([[100.0, 0, 40], [0, 110.0, 30], [0, 0, 1]]))
    return scene, calib


@pytest.mark.parametrize("size", SIZES)
def test_mars_logger_matches_jax(tmp_path, size):
    """The same video extracted by each package into its own copy of the
    scene: the same JPEG files byte for byte, the rotated intrinsics, and
    the same samples; a second construction reuses the frames."""
    roots = {name: _mars_scene(tmp_path / name, np.random.default_rng(0))
             for name in ("port", "jax")}
    port = handlers.MarsLoggerDataset(str(roots["port"][0]), str(roots["port"][1]), size)
    ref = jhandlers.MarsLoggerDataset(str(roots["jax"][0]), str(roots["jax"][1]), size)
    got = sorted((roots["port"][0] / "rgb").glob("*.jpg"))
    want = sorted((roots["jax"][0] / "rgb").glob("*.jpg"))
    assert [p.name for p in got] == [p.name for p in want] and len(got) == 12
    assert all(a.read_bytes() == b.read_bytes() for a, b in zip(got, want))
    np.testing.assert_array_equal(port.intrinsic, ref.intrinsic)
    _assert_equal_samples(port, ref)
    again = handlers.MarsLoggerDataset(str(roots["port"][0]), str(roots["port"][1]), size,
                                       is_train=False)
    assert again.rgb_paths == port.rgb_paths and not again.augment


@pytest.mark.parametrize("size", SIZES)
def test_custom_rig_and_irs_match_jax(tmp_path, size):
    """A capture-rig scene (JPEG and PNG frames at 60x80, intrinsics at the
    first frame's size) and an IRS scene (``l_*.png`` at 54x96, the fixed
    camera), in training and in evaluation."""
    rng = np.random.default_rng(1)
    rig = tmp_path / "rig"
    (rig / "rgb_left").mkdir(parents=True)
    (rig / "sensor").mkdir()
    for i, frame in enumerate(_frames(rng, 10, 60, 80)):
        cv2.imwrite(str(rig / "rgb_left" / f"{i:05d}.{'jpg' if i % 2 else 'png'}"), frame)
    np.save(rig / "sensor" / "left_intrinsics.npy",
            np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]]))
    irs = tmp_path / "irs"
    irs.mkdir()
    for i, frame in enumerate(_frames(rng, 8, 54, 96)):
        cv2.imwrite(str(irs / f"l_{i:04d}.png"), frame)
    for is_train in (True, False):
        for port, ref in (
            (handlers.CustomRigDataset(str(rig), size, is_train),
             jhandlers.CustomRigDataset(str(rig), size, is_train)),
            (handlers.IrsDataset(str(irs), size, is_train),
             jhandlers.IrsDataset(str(irs), size, is_train)),
        ):
            assert port.rgb_paths == ref.rgb_paths
            np.testing.assert_array_equal(port.intrinsic, ref.intrinsic)
            _assert_equal_samples(port, ref)
    with pytest.raises(ValueError, match="no left frames"):
        handlers.IrsDataset(str(tmp_path), size)


def test_stereo_builders_match_jax(tmp_path):
    """``irs_stereo_dataset`` and ``custom_stereo_dataset``: both directed
    samples of every pair, the baseline poses, and the softer jitter drawn
    from the same generator; a bare ``StereoSnippetDataset`` too."""
    rng = np.random.default_rng(2)
    irs = tmp_path / "irs"
    (irs / "left").mkdir(parents=True)
    (irs / "right").mkdir()
    for i in range(4):
        cv2.imwrite(str(irs / "left" / f"{i}.png"), _frames(rng, 1, 54, 96)[0])
        cv2.imwrite(str(irs / "right" / f"{i}.png"), _frames(rng, 1, 54, 96)[0])
    rig = tmp_path / "rig"
    for side in ("rgb_left", "rgb_right"):
        (rig / side).mkdir(parents=True)
        for i in range(3):
            cv2.imwrite(str(rig / side / f"{i}.jpg"), _frames(rng, 1, 60, 80)[0])
    (rig / "sensor").mkdir()
    np.save(rig / "sensor" / "left_intrinsics.npy",
            np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]]))
    (rig / "sensor" / "stereo_parameters.json").write_text(json.dumps({"baseline_m": 0.12}))
    for is_train in (True, False):
        pairs = (
            (handlers.irs_stereo_dataset(str(irs), (48, 64), is_train),
             jhandlers.irs_stereo_dataset(str(irs), (48, 64), is_train)),
            (handlers.custom_stereo_dataset(str(rig), (48, 64), is_train),
             jhandlers.custom_stereo_dataset(str(rig), (48, 64), is_train)),
        )
        for port, ref in pairs:
            assert port.source_paths == ref.source_paths
            assert port.target_paths == ref.target_paths
            _assert_equal_samples(port, ref, seeds=range(4))
    assert len(pairs[0][0]) == 8 and pairs[1][0][0]["pose"][0, 3] == np.float32(-0.12)
    bare = [str(p) for p in sorted((irs / "left").glob("*.png"))]
    K = np.eye(4)
    _assert_equal_samples(
        handlers.StereoSnippetDataset(bare, bare[::-1], [K] * 4, [K] * 4, (54, 96)),
        jhandlers.StereoSnippetDataset(bare, bare[::-1], [K] * 4, [K] * 4, (54, 96)),
    )
    with pytest.raises(ValueError, match="no stereo pairs"):
        handlers.build_stereo_dataset([], [], K, 0.1, (48, 64))


def test_mars_logger_handler_matches_jax(tmp_path, capsys):
    """``MarsLoggerDataHandler`` over a train fold of one video scene and one
    scene without a video (skipped with JAX's warning), in two copies: the
    same warnings, lengths and samples."""
    handlers_out = {}
    for name, module in (("port", handlers), ("jax", jhandlers)):
        root = tmp_path / name
        _mars_scene(root, np.random.default_rng(3))
        (root / "train" / "scene_1").mkdir()
        cfg = {"Train": {"img_h": 48, "img_w": 64}, "Directory": {"data_dir": str(tmp_path)},
               "Dataset": {"mars_logger": {"mono": True}}}
        handlers_out[name] = module.MarsLoggerDataHandler(cfg, root_dir=str(root))
        handlers_out[name + "_out"] = capsys.readouterr().out.replace(str(root), "<root>")
    assert handlers_out["port_out"] == handlers_out["jax_out"]
    assert "Warning: skipping mars_logger scene <root>/train/scene_1" in handlers_out["port_out"]
    assert handlers_out["port"].valid_dataset is handlers_out["jax"].valid_dataset is None
    _assert_equal_samples(handlers_out["port"].train_dataset, handlers_out["jax"].train_dataset)
    np.testing.assert_allclose(handlers.rescale_intrinsic_4x4(
        handlers.IRS_K3, (48, 64), handlers.IRS_NATIVE_SIZE), jhandlers.rescale_intrinsic_4x4(
        jhandlers.IRS_K3, (48, 64), jhandlers.IRS_NATIVE_SIZE), rtol=0, atol=0)
