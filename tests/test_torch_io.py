"""The port's image readers, path datasets and packer against the JAX
package's, on the CPU, on trees written into ``tmp_path`` with cv2.

Both packages decode with the same cv2, so frames, depth maps, samples and
shards must be equal bit for bit. Two places differ by design:
- the host jitter's hue step is cv2's float RGB<->HSV on the JAX side and
  the same formulas in numpy in the port (``tests/test_torch_data.py``):
  jittered images within atol 1e-5;
- JAX's float ``_load_triplet`` takes its g++ resize (``native/``) when the
  library loads, and cv2 otherwise; the port reads as that cv2 route does.
  The port is held equal to JAX's cv2 route (``_load``, and
  ``_load_triplet`` with the native call answering ``None``); against the
  native route it stays within one grey level (1/255), both sides being
  bilinear resizes of the same uint8 decode with other rounding.

No JAX program is compiled here.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu import native as jnative
from deep_visual_slam_tpu.data import base as jbase
from deep_visual_slam_tpu.data import loader as jloader
from deep_visual_slam_tpu.data import nyu as jnyu
from deep_visual_slam_tpu.data import redwood as jredwood

from deep_visual_slam_torch.data import base, loader, nyu, packed, redwood

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 96  # the files' size
SIZES = ((64, 96), (48, 72))  # read as they are, and resized
FRAMES = 9


def _smooth_frames(rng, n, h, w):
    """``n`` uint8 frames of a random low-frequency texture (JPEG keeps it)."""
    coarse = rng.uniform(0, 255, (n, h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
    return np.stack([cv2.resize(c, (w, h), interpolation=cv2.INTER_CUBIC)
                     for c in coarse]).clip(0, 255).astype(np.uint8)


def write_redwood_tree(root: Path, rng, scenes=("apartment", "bedroom"), fold="test",
                       n=FRAMES, size=(H, W)):
    """A Redwood fold as ``scripts/record_parity.py:make_redwood_fixture``
    writes it (BGR JPEGs, column-major camera-to-world PoseGraph nodes), with
    random frames and a random walk of poses, at ``size``."""
    root.mkdir(parents=True, exist_ok=True)
    np.save(root / "intrinsic.npy", np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]]))
    for scene in scenes:
        img_dir = root / fold / scene / "image"
        img_dir.mkdir(parents=True)
        nodes = []
        T = np.eye(4)
        for i, frame in enumerate(_smooth_frames(rng, n, *size)):
            cv2.imwrite(str(img_dir / f"{i:06d}.jpg"), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            T = T.copy()
            T[:3, 3] += rng.normal(0, 0.02, 3)
            nodes.append({"pose": T.flatten(order="F").tolist()})
        (root / fold / scene / f"{scene}.json").write_text(json.dumps({"nodes": nodes}))


def write_custom_scene(scene: Path, rng, n=FRAMES, size=(60, 80), stereo=False):
    """A capture-rig scene as ``tests/test_handlers.py`` writes one."""
    sides = ("rgb_left", "rgb_right") if stereo else ("rgb_left",)
    for side in sides:
        (scene / side).mkdir(parents=True)
        for i, frame in enumerate(_smooth_frames(rng, n, *size)):
            cv2.imwrite(str(scene / side / f"{i:05d}.jpg"), frame)
    (scene / "sensor").mkdir()
    np.save(scene / "sensor" / "left_intrinsics.npy",
            np.array([[100.0, 0, 40], [0, 100.0, 30], [0, 0, 1]]))
    if stereo:
        (scene / "sensor" / "stereo_parameters.json").write_text(json.dumps({"baseline_m": 0.12}))


def _cv2_route(monkeypatch):
    """JAX's float triplet read without its native resize: its cv2 route."""
    monkeypatch.setattr(jnative, "resize_normalize_batch", lambda *a, **k: None)


def _assert_samples(got, want, image_atol=0.0):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        atol = image_atol if k in ("source_left", "target_image", "source_right") else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("size", SIZES)
def test_readers_match_jax(tmp_path, monkeypatch, size):
    """``read_image_rgb``, the float and uint8 triplets and the 16-bit depth
    read against JAX's, at the files' size and resized; the gap to JAX's
    native route."""
    rng = np.random.default_rng(0)
    write_redwood_tree(tmp_path, rng, scenes=("loft",))
    paths = sorted(str(p) for p in (tmp_path / "test" / "loft" / "image").glob("*.jpg"))
    h, w = size
    for p in paths[:3]:
        got = base.read_image_rgb(p, h, w)
        assert got.dtype == np.float32 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, jbase.read_image_rgb(p, h, w))
    K = np.eye(4, dtype=np.float32)
    port = base.PathSnippetDataset(paths, K, size)
    ref = jbase.SnippetDataset(paths, K, size)
    idx = [0, 2, 5]
    native = ref._load_triplet(idx)  # the g++ route where it loads
    np.testing.assert_array_equal(port._load_triplet_u8(idx), ref._load_triplet_u8(idx))
    got = port._load_triplet(idx)
    np.testing.assert_array_equal(got, np.stack([ref._load(i) for i in idx]))
    _cv2_route(monkeypatch)
    np.testing.assert_array_equal(got, ref._load_triplet(idx))
    assert np.abs(got - native).max() <= 1.0 / 255 + 1e-6

    depth = rng.integers(0, 60000, (H, W)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    raw = base.read_depth_raw(str(tmp_path / "d.png"), h, w)
    want = depth if size == (H, W) else cv2.resize(depth, (w, h), interpolation=cv2.INTER_NEAREST)
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(raw, want)
    with pytest.raises(FileNotFoundError):
        base.read_image_rgb(str(tmp_path / "missing.jpg"), h, w)


def test_redwood_datasets_match_jax(tmp_path, monkeypatch, capsys):
    """The three folds through ``RedwoodDataHandler``: scene names, lengths,
    intrinsics, and every sample drawn with the same generator, with the
    jitter (train) and with the ground-truth poses (validation, test); a
    scene without its PoseGraph is skipped with JAX's warning."""
    _cv2_route(monkeypatch)
    rng = np.random.default_rng(1)
    for fold in ("train", "validation", "test"):
        write_redwood_tree(tmp_path, rng, scenes=("a_scene", "b_scene"), fold=fold)
    (tmp_path / "train" / "broken" / "image").mkdir(parents=True)
    cfg = {"Train": {"img_h": 48, "img_w": 72}, "Directory": {"data_dir": str(tmp_path)},
           "Dataset": {"redwood": {"mono": True}}}
    ours = redwood.RedwoodDataHandler(cfg, root_dir=str(tmp_path))
    port_out = capsys.readouterr().out
    theirs = jredwood.RedwoodDataHandler(cfg, root_dir=str(tmp_path))
    assert port_out == capsys.readouterr().out
    assert "Warning: skipping Redwood scene 'broken'" in port_out
    jittered = 0
    for name in ("train_dataset", "valid_dataset", "test_dataset"):
        p, j = getattr(ours, name), getattr(theirs, name)
        assert p.scene_names == j.scene_names == ["a_scene", "b_scene"]
        assert len(p) == len(j) > 0
        for idx in range(len(j)):
            seed = 100 * idx + len(name)
            rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = p.__getitem__(idx, rng_p), j.__getitem__(idx, rng_j)
            if name == "train_dataset":  # the same gaps without the jitter
                for s in p.datasets:
                    s.augment = False
                plain = p.__getitem__(idx, np.random.default_rng(seed))
                for s in p.datasets:
                    s.augment = True
                jittered += not np.array_equal(plain["target_image"], got["target_image"])
            _assert_samples(got, want, image_atol=1e-5)
            assert rng_p.uniform() == rng_j.uniform()
        if name != "train_dataset":
            assert "gt_pose_target_to_right" in got
    assert 0 < jittered < len(ours.train_dataset)


def test_nyu_dataset_matches_jax(tmp_path):
    """``nyu_dataset`` over both layouts (``rgb/``+``depth/`` and flat
    ``rgb_*``/``depth_*``), read as it is and resized: the same files, and
    the same samples (flips, jitter, metres, mask) from the same generator."""
    rng = np.random.default_rng(2)
    for layout in ("dirs", "flat"):
        split = tmp_path / layout / "train"
        for sub in (("rgb", "depth") if layout == "dirs" else ("",)):
            (split / sub).mkdir(parents=True, exist_ok=True)
        for i, img in enumerate(_smooth_frames(rng, 3, H, W)):
            depth = rng.integers(200, 12000, (H, W)).astype(np.uint16)
            rgb_path = split / ("rgb" if layout == "dirs" else "") / (
                f"{i:03d}.png" if layout == "dirs" else f"rgb_{i:03d}.jpg")
            depth_path = split / ("depth" if layout == "dirs" else "") / (
                f"{i:03d}.png" if layout == "dirs" else f"depth_{i:03d}.png")
            cv2.imwrite(str(rgb_path), img)
            cv2.imwrite(str(depth_path), depth)
        for size in SIZES:
            p = nyu.nyu_dataset(str(tmp_path / layout), "train", size, 10.0, True)
            j = jnyu.nyu_dataset(str(tmp_path / layout), "train", size, 10.0, True)
            assert p.rgb_paths == j.rgb_paths and p.depth_paths == j.depth_paths
            assert len(p) == len(j) == 3
            for idx in range(3):
                for seed in range(4):
                    rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
                    got, want = p.__getitem__(idx, rng_p), j.__getitem__(idx, rng_j)
                    assert got.keys() == want.keys()
                    np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=1e-5)
                    np.testing.assert_array_equal(got["depth"], want["depth"])
                    np.testing.assert_array_equal(got["valid_mask"], want["valid_mask"])
    assert nyu.nyu_dataset(str(tmp_path / "dirs"), "test", (H, W), 10.0, False) is None


def _jax_pack_script():
    spec = importlib.util.spec_from_file_location("jax_pack_dataset",
                                                  ROOT / "scripts" / "pack_dataset.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_packers_write_jax_bytes(tmp_path):
    """``pack_from_paths`` and ``pack_dataset --config`` (Redwood and a
    custom scene, resized) against JAX's: equal ``images.npy`` bytes and
    ``meta.npz`` arrays. JAX's script skips the Redwood scenes (its
    ``_flatten`` does not open a ``RedwoodDataset``); the port packs them,
    equal to JAX's ``pack_from_paths`` on the same scene."""
    from deep_visual_slam_tpu.data import packed as jpacked

    from deep_visual_slam_torch import pack_dataset

    rng = np.random.default_rng(3)
    data = tmp_path / "data"
    write_redwood_tree(data / "redwood", rng, scenes=("lobby",), fold="train")
    write_redwood_tree(data / "redwood", rng, scenes=("loft",), fold="test")
    write_custom_scene(data / "custom_data" / "valid" / "rig", rng)
    paths = sorted(str(p) for p in (data / "redwood" / "train" / "lobby" / "image").glob("*"))
    K = np.eye(4, dtype=np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(paths), 1, 1))
    for name, pack in (("port", packed.pack_from_paths), ("jax", jpacked.pack_from_paths)):
        pack(str(tmp_path / name), paths, K, (48, 72), poses=poses, chunk=4)
    _assert_same_shards(tmp_path / "port", tmp_path / "jax")

    cfg = {"Directory": {"data_dir": str(data)},
           "Train": {"img_h": 48, "img_w": 72, "batch_size": 2},
           "Dataset": {"redwood": {"mono": True}, "custom_data": {"mono": True}}}
    cfg_path = tmp_path / "vo.yaml"
    import yaml

    cfg_path.write_text(yaml.safe_dump(cfg))
    pack_dataset.main(["--config", str(cfg_path), "--out", str(tmp_path / "cfg_port")])
    _jax_pack_script().pack_config(str(cfg_path), str(tmp_path / "cfg_jax"))
    def shards(root):
        return sorted(str(p.relative_to(root)) for p in root.glob("*/*"))

    assert shards(tmp_path / "cfg_jax") == ["valid/000_rgb_left"]
    assert shards(tmp_path / "cfg_port") == ["test/000_image", "train/000_image",
                                             "valid/000_rgb_left"]
    _assert_same_shards(tmp_path / "cfg_port" / "valid" / "000_rgb_left",
                        tmp_path / "cfg_jax" / "valid" / "000_rgb_left")
    for fold, scene in (("train", "lobby"), ("test", "loft")):
        scene_ds = jredwood.load_scene(str(data / "redwood" / fold / scene), scene,
                                       jredwood.load_intrinsic(str(data / "redwood"), (48, 72)),
                                       (48, 72), fold == "train", fold == "train")
        jpacked.pack_from_paths(str(tmp_path / "want" / fold), scene_ds.rgb_paths,
                                scene_ds.intrinsic, (48, 72), poses=scene_ds.poses)
        _assert_same_shards(tmp_path / "cfg_port" / fold / "000_image", tmp_path / "want" / fold)


def _assert_same_shards(a: Path, b: Path) -> None:
    assert (a / packed.IMAGES).read_bytes() == (b / packed.IMAGES).read_bytes()
    with np.load(a / packed.META) as ma, np.load(b / packed.META) as mb:
        assert sorted(ma.files) == sorted(mb.files)
        for k in ma.files:
            assert ma[k].dtype == mb[k].dtype
            np.testing.assert_array_equal(ma[k], mb[k])


def test_vo_data_loader_with_path_sources_matches_jax(tmp_path, monkeypatch, capsys):
    """``VoDataLoader`` with ``redwood.mono``, a custom source (mono and
    stereo, one scene broken) and packed shards: the same warnings, and one
    epoch of each loader equal to JAX's at the same seed (train images within
    the jitter's 1e-5). No Redwood validation fold: its samples carry
    ground-truth poses and the custom rig's do not, which neither package's
    collation takes in one batch."""
    _cv2_route(monkeypatch)
    rng = np.random.default_rng(4)
    data = tmp_path / "data"
    write_redwood_tree(data / "redwood", rng, scenes=("apartment", "loft"), fold="train")
    write_redwood_tree(data / "redwood", rng, scenes=("lobby",), fold="test")
    write_custom_scene(data / "custom_data" / "train" / "rig_a", rng, stereo=True)
    write_custom_scene(data / "custom_data" / "valid" / "rig_b", rng, stereo=True)
    (data / "custom_data" / "train" / "rig_empty").mkdir()
    frames = rng.integers(0, 256, (FRAMES, 48, 72, 3), dtype=np.uint8)
    packed.pack_scene(str(data / "packed" / "train" / "p"), frames, np.eye(4),
                      poses=np.tile(np.eye(4), (FRAMES, 1, 1)))
    cfg = {"Directory": {"data_dir": str(data)},
           "Train": {"img_h": 48, "img_w": 72, "batch_size": 3, "num_workers": 2, "seed": 7,
                     "vis_batch_size": 1},
           "Dataset": {"redwood": {"mono": True}, "custom_data": {"mono": True, "stereo": True},
                       "packed": {"mono": True}}}
    ours = loader.VoDataLoader(cfg)
    port_out = capsys.readouterr().out
    theirs = jloader.VoDataLoader(cfg)
    assert port_out == capsys.readouterr().out
    assert port_out.count("Warning: skipping custom") == 2  # mono and stereo
    for name in ("train_loader", "valid_loader", "test_loader", "train_stereo_loader",
                 "valid_stereo_loader"):
        p, j = getattr(ours, name), getattr(theirs, name)
        assert len(p) == len(j) > 0, name
        p.set_epoch(1)
        j.set_epoch(1)
        got, want = list(p), list(j)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                atol = 1e-5 if name.startswith("train") and g[k].dtype == np.float32 else 0.0
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=f"{name} {k}")


def _jax_leaves(ds):
    """The leaf datasets under JAX's ``ConcatDataset`` and ``RedwoodDataset``."""
    for name in ("datasets", "scenes"):
        if hasattr(ds, name):
            return [leaf for d in getattr(ds, name) for leaf in _jax_leaves(d)]
    return [ds]


def test_vo_data_loader_flags_reach_redwood_scenes(tmp_path, monkeypatch):
    """``Train.device_augment``, alone and with ``Train.uint8_h2d``, over
    ``redwood.mono`` beside a custom source: every train leaf, the Redwood
    scenes included, has its host jitter off and, with ``uint8_h2d``, emits
    uint8. One epoch equals JAX's loader with the jitter of each of its
    leaves turned off by hand (JAX's flags do not reach its Redwood scenes),
    uint8 images scaled by 1/255."""
    _cv2_route(monkeypatch)
    rng = np.random.default_rng(5)
    data = tmp_path / "data"
    write_redwood_tree(data / "redwood", rng, scenes=("apartment", "loft"), fold="train")
    write_custom_scene(data / "custom_data" / "train" / "rig_a", rng)
    cfg = {"Directory": {"data_dir": str(data)},
           "Train": {"img_h": 48, "img_w": 72, "batch_size": 3, "num_workers": 2, "seed": 7},
           "Dataset": {"redwood": {"mono": True}, "custom_data": {"mono": True}}}
    ref = jloader.VoDataLoader(cfg)
    for leaf in _jax_leaves(ref.train_dataset):
        leaf.augment = False
    ref.train_loader.set_epoch(1)
    want = list(ref.train_loader)
    images = ("source_left", "target_image", "source_right")
    for uint8 in (False, True):
        c = json.loads(json.dumps(cfg))
        c["Train"].update(device_augment=True, uint8_h2d=uint8)
        ours = loader.VoDataLoader(c)
        leaves = []
        loader._walk(ours.train_dataset, leaves.append)
        assert [type(d).__name__ for d in leaves] == ["PathSnippetDataset"] * 2 + [
            "CustomRigDataset"]
        assert not any(d.augment for d in leaves)
        assert all(d.output_uint8 is uint8 for d in leaves)
        ours.train_loader.set_epoch(1)
        got = list(ours.train_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                if k in images and uint8:
                    assert g[k].dtype == np.uint8
                    np.testing.assert_array_equal(g[k].astype(np.float32) / 255.0, w[k])
                else:
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_readers_raise_without_cv2_and_matplotlib():
    """Without cv2 and matplotlib every module that ``chip_smoke.py`` and
    the CLIs import still imports; a call that needs one raises
    ``ImportError``, with no other route taken."""
    code = """
import sys
sys.modules["cv2"] = None
sys.modules["matplotlib"] = None
import pkgutil, importlib
import deep_visual_slam_torch
for m in pkgutil.walk_packages(deep_visual_slam_torch.__path__, "deep_visual_slam_torch."):
    importlib.import_module(m.name)
import numpy as np
from deep_visual_slam_torch.data.base import read_image_rgb
from deep_visual_slam_torch.utils.plot import colorize_disparity
from deep_visual_slam_torch.utils.viz import Visualizer
for call in (lambda: read_image_rgb("x.jpg", 4, 4),
             lambda: colorize_disparity(np.zeros((4, 4))),
             lambda: Visualizer(sys.argv[1]).render()):
    try:
        call()
    except ImportError:
        continue
    raise SystemExit("no ImportError")
print("ok")
"""
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        r = subprocess.run([sys.executable, "-c", code, out], cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
