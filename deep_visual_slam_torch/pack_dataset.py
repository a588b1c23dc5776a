"""Render synthetic scenes into packed shards for ``Dataset.packed``
(the ``--synthetic`` route of ``scripts/pack_dataset.py``).

    python3 -m deep_visual_slam_torch.pack_dataset --synthetic 24 --frames 96 \\
        --out results/packed

Scene ``i`` is drawn from seed ``1000 + i`` (the BA ablation's seeds 100-102
stay out of it) along a sweep of 0.02 m and 0.004 rad a step, and split
80/10/10 into ``<out>/{train,valid,test}/scene_<i>`` once there are three
scenes or more. ``--generator plane`` renders the textured slanted plane
(``synthetic_slam_sequence``), ``multidepth`` the piecewise-planar ray-cast
scene, ``mix`` alternates them. Frames are stored as uint8 with the
camera-to-world ground-truth poses. A scene whose shard exists is kept.
Packing the scenes of a config's path sources needs an image decoder and
comes with the path datasets.
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--synthetic", type=int, required=True, help="number of scenes to render")
    ap.add_argument("--frames", type=int, default=96, help="frames per scene")
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    ap.add_argument("--out", default="results/packed", help="output root")
    ap.add_argument("--generator", choices=("plane", "multidepth", "mix"), default="plane")
    ap.add_argument("--device", default=None,
                    help="torch device of the plane renders (default: CUDA, which must "
                    "be present)")
    args = ap.parse_args(argv)
    pack_synthetic(args.out, args.synthetic, args.frames, args.size, args.generator,
                   device=args.device)


if __name__ == "__main__":
    main()
