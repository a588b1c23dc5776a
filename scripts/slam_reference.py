"""Reference numbers of the JAX package's SLAM loop on an oracle-initialized
sequence, for holding the PyTorch port to them.

    JAX_PLATFORMS=cpu python scripts/slam_reference.py --size 480 640 \
        --frames 60 --seed 100

Runs ``deep_visual_slam_tpu.slam.MonoVO`` (KLT frontend, windowed BA at
levels (2, 1), ``num_kf=7``, ``max_points=256``, random fp32 networks whose
outputs the oracle replaces) over ``synthetic_multidepth_sequence`` with
``step_translation=0.02`` and ``step_rotation=0.004``, initialized from GT
depth and GT relative poses with 0.3 deg / 0.005 m odometry noise
(``scripts/ba_ablation.py:make_oracle_inits``, the settings of
``docs/ba_ablation_r03.json``), once with ``optimize=False`` and once with
``optimize=True``. Prints one JSON object: per run the keyframe ids, the
unaligned translation RMSE of the camera centres against GT and the ATE
RMSE after a sim(3) Umeyama alignment (``eval/trajectory.py:ate_rmse``, the
ablation's metric), both in metres, and the seconds each run took on this
host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seed", type=int, default=100)
    args = ap.parse_args()
    H, W = args.size

    import jax.numpy as jnp

    from deep_visual_slam_tpu.data.synthetic import synthetic_multidepth_sequence
    from deep_visual_slam_tpu.eval.trajectory import ate_rmse
    from deep_visual_slam_tpu.slam import MonoVO, Networks
    from scripts.ba_ablation import make_oracle_inits

    frames, K, gt_cw, gt_depths = synthetic_multidepth_sequence(
        args.frames, H, W, seed=args.seed, step_translation=0.02, step_rotation=0.004
    )
    oracle = make_oracle_inits(gt_cw, gt_depths, args.seed, 0.3, 0.005, 0.0)
    nets = Networks(image_shape=(H, W), dtype=jnp.float32)
    gt_wc = np.linalg.inv(np.asarray(gt_cw, np.float64))
    out = {"size": [H, W], "frames": args.frames, "seed": args.seed}
    for name, optimize in (("no_ba", False), ("windowed_ba", True)):
        vo = MonoVO(K, networks=nets, image_shape=(H, W))
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            vo.process_frame(f, optimize=optimize, oracle_depth=oracle[0][i],
                             oracle_rel=oracle[1][i])
        traj = vo.trajectory()
        out[name] = {
            "keyframes": sorted(f.id for f in vo.mp.frames if f.anchor is f),
            "translation_rmse": ate_rmse(traj, gt_wc, align=False)[0],
            "ate_rmse": ate_rmse(traj, gt_wc)[0],
            "seconds": time.perf_counter() - t0,
        }
        print(name, out[name], flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
