"""Pack scenes into shards for ``Dataset.packed`` (port of
``scripts/pack_dataset.py``): synthetic renders, or every path-listed scene
that a config enables.

    python3 -m deep_visual_slam_torch.pack_dataset --synthetic 24 --frames 96 \\
        --out results/packed
    python3 -m deep_visual_slam_torch.pack_dataset --config configs/vo.yaml \\
        [--out <data_dir>/packed]

Scene ``i`` is drawn from seed ``1000 + i`` (the BA ablation's seeds 100-102
stay out of it) along a sweep of 0.02 m and 0.004 rad a step, and split
80/10/10 into ``<out>/{train,valid,test}/scene_<i>`` once there are three
scenes or more. ``--generator plane`` renders the textured slanted plane
(``synthetic_slam_sequence``), ``multidepth`` the piecewise-planar ray-cast
scene, ``mix`` alternates them. Frames are stored as uint8 with the
camera-to-world ground-truth poses. A scene whose shard exists is kept.

``--config`` packs the scenes of the config's path sources (Redwood,
MarsLogger, the custom rig, IRS), fold by fold in the loader's order, into
``<out>/<fold>/<k>_<directory of the scene's frames>``, with their
intrinsics at the config's size and their poses; the frames are decoded and
truncated to uint8 as the JAX package's packer does, so both write the same
bytes. The JAX script leaves the Redwood scenes out (its flattening does not
open a ``RedwoodDataset``); this one packs them.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def pack_synthetic(out_root: str, n_scenes: int, n_frames: int, size,
                   generator: str = "plane", device=None) -> None:
    from deep_visual_slam_torch.data.packed import IMAGES, pack_scene
    from deep_visual_slam_torch.data.synthetic import (
        synthetic_multidepth_sequence,
        synthetic_slam_sequence,
    )

    H, W = size
    n_valid = max(1, n_scenes // 10) if n_scenes >= 3 else 0
    n_test = n_valid
    folds = ["train"] * (n_scenes - n_valid - n_test) + ["valid"] * n_valid + ["test"] * n_test
    for i, fold in enumerate(folds):
        out_dir = os.path.join(out_root, fold, f"scene_{i:03d}")
        if os.path.exists(os.path.join(out_dir, IMAGES)):
            print(f"{out_dir}: exists, skipping", flush=True)
            continue
        t0 = time.time()
        sweep = dict(seed=1000 + i, step_translation=0.02, step_rotation=0.004)
        if generator == "multidepth" or (generator == "mix" and i % 2):
            frames, K, poses_cw, _ = synthetic_multidepth_sequence(n_frames, H, W, **sweep)
        else:
            frames, K, poses_cw = synthetic_slam_sequence(n_frames, H, W, device=device, **sweep)
        # The snippet datasets expect camera-to-world poses.
        poses_wc = np.linalg.inv(poses_cw.astype(np.float64)).astype(np.float32)
        pack_scene(out_dir, (np.clip(frames, 0, 1) * 255).astype(np.uint8), K, poses=poses_wc)
        print(f"{out_dir}: {n_frames}x{H}x{W} in {time.time() - t0:.1f}s", flush=True)


def pack_config(config_path: str, out_root: str | None) -> None:
    """Every path-listed scene of the config's train, valid and test sets as
    a shard under ``out_root`` (default ``<Directory.data_dir>/packed``)."""
    from deep_visual_slam_torch.data.base import PathSnippetDataset
    from deep_visual_slam_torch.data.loader import VoDataLoader, _walk
    from deep_visual_slam_torch.data.packed import pack_from_paths
    from deep_visual_slam_torch.utils.config import load_config

    config = load_config(config_path)
    image_size = (config["Train"]["img_h"], config["Train"]["img_w"])
    out_root = out_root or os.path.join(config["Directory"]["data_dir"], "packed")
    loader = VoDataLoader(config)
    for fold, ds in (("train", loader.train_dataset), ("valid", loader.valid_dataset),
                     ("test", loader.test_dataset)):
        scenes: list = []
        _walk(ds, scenes.append)
        for k, scene in enumerate(scenes):
            if not isinstance(scene, PathSnippetDataset) or not scene.rgb_paths:
                continue
            name = os.path.basename(os.path.dirname(os.path.abspath(str(scene.rgb_paths[0]))))
            out_dir = os.path.join(out_root, fold, f"{k:03d}_{name}")
            t0 = time.time()
            pack_from_paths(out_dir, scene.rgb_paths, scene.intrinsic, image_size,
                            poses=scene.poses)
            print(f"{out_dir}: {len(scene.rgb_paths)} frames in {time.time() - t0:.1f}s",
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None, help="pack this config's path-listed scenes")
    ap.add_argument("--synthetic", type=int, default=0, help="render N synthetic scenes instead")
    ap.add_argument("--frames", type=int, default=96, help="frames per scene")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    ap.add_argument("--out", default=None,
                    help="output root (default: results/packed with --synthetic, "
                    "<Directory.data_dir>/packed with --config)")
    ap.add_argument("--generator", choices=("plane", "multidepth", "mix"), default="plane")
    ap.add_argument("--device", default=None,
                    help="torch device of the plane renders (default: CUDA, which must "
                    "be present)")
    args = ap.parse_args(argv)
    if args.synthetic:
        pack_synthetic(args.out or "results/packed", args.synthetic, args.frames, args.size,
                       args.generator, device=args.device)
    elif args.config:
        pack_config(args.config, args.out)
    else:
        ap.error("one of --config / --synthetic is required")


if __name__ == "__main__":
    main()
