"""The port's data layer against the JAX package's, on the CPU.

The same seeds go through both packages' loaders, datasets and fixtures.
Where both compute in numpy (the loader's order, the per-sample generators,
the triplet gaps, packed reads, collation) the batches must be equal bit
for bit. The host jitter's hue step is OpenCV's float RGB<->HSV on the JAX
side and the same formulas in numpy in the port: atol 1e-5 (the two round
differently in the last bits, and the result is clipped to [0, 1]). The
synthetic renders run through XLA on one side and PyTorch on the other:
images and poses within atol 1e-6. No JAX program is compiled here beyond
the eager operations of the JAX fixtures.
"""

import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.data import base as jbase
from deep_visual_slam_tpu.data import loader as jloader
from deep_visual_slam_tpu.data import packed as jpacked
from deep_visual_slam_tpu.data import synthetic as jsynthetic
from deep_visual_slam_tpu.utils.config import load_config as jax_load_config

from deep_visual_slam_torch.data import base, loader, packed, synthetic
from deep_visual_slam_torch.utils.config import load_config

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

H, W = 16, 24
N_FRAMES = 12


def _write_scenes(root):
    """Two scenes of random uint8 frames with camera-to-world poses, one
    written by each package's ``pack_scene``."""
    rng = np.random.default_rng(11)
    K = synthetic.default_intrinsics(H, W)
    for name, pack in (("a", jpacked.pack_scene), ("b", packed.pack_scene)):
        frames = rng.integers(0, 256, (N_FRAMES, H, W, 3), dtype=np.uint8)
        poses = np.tile(np.eye(4, dtype=np.float32), (N_FRAMES, 1, 1))
        poses[:, :3, 3] = np.cumsum(rng.normal(0, 0.02, (N_FRAMES, 3)), axis=0)
        pack(str(root / name), frames, K, poses=poses)
    return [str(root / n) for n in ("a", "b")]


def _datasets(module, scenes, is_train, augment, uint8):
    out = []
    for scene in scenes:
        ds = module.PackedSnippetDataset(scene, (H, W), is_train=is_train, augment=augment)
        ds.output_uint8 = uint8
        out.append(ds)
    return out


def _assert_batches(got, want, image_atol=0.0, atol=0.0):
    """Equal batches: images within ``image_atol``, every array within
    ``atol``, bit for bit where both are 0."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            tol = max(atol, image_atol if k in ("source_left", "target_image",
                                                 "source_right") else 0.0)
            if tol:
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("case", ["float_train", "uint8_train", "float_eval", "float_jitter"])
def test_loader_batches_match_jax(tmp_path, case):
    """Two epochs over the concatenation of two packed scenes (one packed by
    each package), the second resumed one batch in with ``skip_batches``:
    the same batches as the JAX loader's, bit for bit (the jittered images
    within atol 1e-5)."""
    scenes = _write_scenes(tmp_path)
    is_train = case != "float_eval"
    augment = case == "float_jitter"
    uint8 = case == "uint8_train"
    loaders = [
        mod_loader.DataLoader(
            mod_loader.ConcatDataset(_datasets(mod_packed, scenes, is_train, augment, uint8)),
            batch_size=3, shuffle=is_train, num_workers=2, seed=7,
        )
        for mod_loader, mod_packed in ((loader, packed), (jloader, jpacked))
    ]
    assert len(loaders[0]) == len(loaders[1]) == (2 * (N_FRAMES - (6 if is_train else 2))) // 3
    epochs = [[], []]
    for i, ld in enumerate(loaders):
        for epoch in (1, 2):
            ld.set_epoch(epoch)
            if epoch == 2:
                ld.skip_batches(1)
            epochs[i].append(list(ld))
    for got, want in zip(*epochs):
        _assert_batches(got, want, image_atol=1e-5 if augment else 0.0)
    assert len(epochs[0][1]) == len(epochs[0][0]) - 1
    if uint8:
        assert epochs[0][0][0]["target_image"].dtype == np.uint8
    if augment:  # some samples were jittered: the images differ from the shard's
        plain = loaders[0].dataset.datasets[0]
        plain.augment = False
        first = epochs[0][0][0]["target_image"][0]
        assert any(
            not np.array_equal(first, plain[j]["target_image"]) for j in range(len(plain))
        )


def test_shards_load_in_both_packages(tmp_path):
    """A shard from either package reads the same in the other, with the
    shape check and pickling of the memmap; ``ConcatDataset`` finds items
    across scenes as the JAX one does, empty datasets dropped."""
    import pickle

    scenes = _write_scenes(tmp_path)
    ours = loader.ConcatDataset([*_datasets(packed, scenes, False, False, False), None])
    theirs = jloader.ConcatDataset([*_datasets(jpacked, scenes, False, False, False), None])
    assert len(ours) == len(theirs) == 2 * (N_FRAMES - 2)
    for idx in (0, N_FRAMES - 3, N_FRAMES - 2, len(ours) - 1):
        g = ours.__getitem__(idx, np.random.default_rng(idx))
        w = theirs.__getitem__(idx, np.random.default_rng(idx))
        _assert_batches([g], [w])
    for scene in scenes:
        ours = packed.PackedSnippetDataset(scene, (H, W), is_train=False)
        theirs = jpacked.PackedSnippetDataset(scene, (H, W), is_train=False)
        ours = pickle.loads(pickle.dumps(ours))
        np.testing.assert_array_equal(ours._images, theirs._images)
        np.testing.assert_array_equal(ours.intrinsic, theirs.intrinsic)
        _assert_batches([ours[3]], [theirs[3]])
    with pytest.raises(ValueError, match="re-pack"):
        packed.PackedSnippetDataset(scenes[0], (H + 1, W))
    assert packed.list_packed_scenes(str(tmp_path)) == jpacked.list_packed_scenes(str(tmp_path))


def test_color_jitter_matches_cv2():
    """The numpy HSV formulas against OpenCV's, through the whole jitter,
    on random pixels plus greys, black, white and saturated primaries, for
    hue turns both ways, none (below 1e-6) and zero saturation."""
    rng = np.random.default_rng(3)
    images = rng.uniform(size=(2, 6, 8, 3)).astype(np.float32)
    images[0, 0, :6] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0], [0, 1, 0], [0, 0, 1]]
    for factors in ((1.2, 0.8, 1.3, 0.15), (0.7, 1.25, 0.75, -0.2), (1.0, 1.0, 1.0, 1e-7),
                    (1.3, 1.3, 0.0, 0.1)):
        got = base.apply_color_jitter_np(images, *factors)
        want = jbase.apply_color_jitter_np(images, *factors)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=str(factors))
    # The drawn form consumes the generator as the JAX one does.
    got = base.color_jitter(images, np.random.default_rng(8))
    want = jbase.color_jitter(images, np.random.default_rng(8))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_synthetic_vo_dataset_matches_jax():
    """Train items, and eval items with their ground-truth poses."""
    for is_train, idx in ((True, 0), (True, 4), (False, 0), (False, 4)):
        ours = synthetic.SyntheticVoDataset((H * 2, W * 2), length=6, seed=5, is_train=is_train)
        theirs = jsynthetic.SyntheticVoDataset((H * 2, W * 2), length=6, seed=5,
                                               is_train=is_train)
        g, w = ours[idx], theirs[idx]
        assert set(g) == set(w) and ("gt_pose_target_to_right" in g) is not is_train
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            atol = 2e-6 if k in ("source_left", "source_right") else 1e-6
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)


def test_synthetic_stereo_dataset_and_depth_batch_match_jax():
    ours = synthetic.SyntheticStereoDataset((H * 2, W * 2), length=4, seed=9)
    theirs = jsynthetic.SyntheticStereoDataset((H * 2, W * 2), length=4, seed=9)
    for idx in (0, 3):
        g, w = ours[idx], theirs[idx]
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-6, err_msg=k)
    g = synthetic.synthetic_depth_batch(2, 2, H, W, device="cpu")
    w = jsynthetic.synthetic_depth_batch(2, 2, H, W)
    for k in w:
        np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


def test_slam_sequence_distractor_matches_jax():
    """The plane sweep with a flickering distractor patch: frames, poses and
    the patch masks."""
    kw = dict(seed=3, step_translation=0.02, step_rotation=0.004, distractor="flicker",
              flicker_amp=0.3)
    frames, K, poses, masks = synthetic.synthetic_slam_sequence(5, 48, 64, device="cpu", **kw)
    jframes, jK, jposes, jmasks = jsynthetic.synthetic_slam_sequence(5, 48, 64, **kw)
    np.testing.assert_array_equal(K, jK)
    np.testing.assert_allclose(poses, jposes, rtol=0, atol=1e-6)
    np.testing.assert_allclose(frames, jframes, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(masks, jmasks)
    assert masks[0].any() and not np.array_equal(frames[0][masks[0]], frames[1][masks[0]])


def _configs(tmp_path, **train):
    """The same config for both packages: packed shards under tmp_path and
    the synthetic mono and stereo streams."""
    _write_scenes(tmp_path / "packed" / "train")
    _write_scenes(tmp_path / "packed" / "valid")
    overrides = {
        "Directory": {"data_dir": str(tmp_path)},
        "Dataset": {
            "redwood": {"mono": False},
            "packed": {"mono": True, "root": str(tmp_path / "packed")},
            "synthetic": {"mono": False, "stereo": True, "length": 8},
        },
        "Train": {"img_h": H, "img_w": W, "batch_size": 2, "num_workers": 2, **train},
    }
    return load_config(overrides=overrides), jax_load_config(overrides=overrides)


def _leaves(ds):
    """The leaf datasets under either package's ``ConcatDataset``."""
    if hasattr(ds, "datasets"):
        return [leaf for d in ds.datasets for leaf in _leaves(d)]
    return [ds]


def test_vo_data_loader_flags_match_jax(tmp_path):
    """``Train.uint8_h2d`` with ``device_augment``: every train source emits
    uint8 with host jitter off; with a synthetic mono source beside the
    packed ones (no uint8 output) nothing does, all or nothing, and
    ``device_augment`` alone still turns the host jitter off. The loaders'
    lengths and seeds and the stereo loaders agree with JAX's."""
    for mixed in (False, True):
        _check_flags(tmp_path / str(mixed), mixed)


def _check_flags(tmp_path, mixed):
    cfg, jcfg = _configs(tmp_path, uint8_h2d=True, device_augment=True)
    for c in (cfg, jcfg):
        c["Dataset"]["synthetic"]["mono"] = mixed
    ours, theirs = loader.VoDataLoader(cfg), jloader.VoDataLoader(jcfg)
    for name in ("train_loader", "valid_loader", "test_loader", "train_stereo_loader",
                 "valid_stereo_loader"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert (len(a), a.seed, a.shuffle, a.batch_size) == (len(b), b.seed, b.shuffle,
                                                              b.batch_size), name
    flags = [
        [(type(d).__name__, getattr(d, "output_uint8", None), getattr(d, "augment", None))
         for d in _leaves(x.train_dataset)]
        for x in (ours, theirs)
    ]
    assert flags[0] == flags[1]
    assert all(f[1] is (False if mixed else True) for f in flags[0] if f[1] is not None)
    assert all(f[2] is False for f in flags[0] if f[2] is not None)
    ours.train_loader.set_epoch(1)
    theirs.train_loader.set_epoch(1)
    # Synthetic items are rendered by XLA and PyTorch: within 2e-6 (above).
    _assert_batches(list(ours.train_loader), list(theirs.train_loader),
                    atol=2e-6 if mixed else 0.0)


def test_vo_data_loader_raises_for_path_sources(tmp_path):
    """Each source that reads image files raises, naming the ROADMAP item,
    instead of being skipped."""
    for source in ("redwood", "mars_logger", "custom_data", "irs"):
        cfg, _ = _configs(tmp_path / source)
        cfg["Dataset"][source] = {"mono": source != "irs", "stereo": source == "irs"}
        with pytest.raises(NotImplementedError, match=f"Dataset.{source}.*ROADMAP"):
            loader.VoDataLoader(cfg)
