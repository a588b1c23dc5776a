"""Pose-prior / Huber sweep of the windowed BA (port of
``scripts/prior_pareto.py``).

    python3 -m deep_visual_slam_torch.prior_pareto --vo_ckpt <VO trainer checkpoint dir>

From network initialization, windowed BA lowers the ATE and raises the
RPE-pos (the drift is spread over the window). This maps that trade-off over
``pose_prior_weight`` x ``huber_delta`` on the net-init ablation's protocol
(``ba_ablation.py``: multidepth scenes of seeds 100-102, 60 frames at
480x640, a sweep of 0.02 m and 0.004 rad a step): ``no_ba`` and one
windowed-BA run of every grid point, each scored by ``ba_ablation.evaluate``
and set against ``no_ba`` as ``ate_vs_no_ba_pct`` and
``rpe_pos_vs_no_ba_pct``. The networks are those of the newest checkpoint
under ``--vo_ckpt`` (random from seed 0 without it), on the card unless
``--device cpu``. The JSON goes to ``results/prior_pareto_torch.json``
unless ``--out_json`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from deep_visual_slam_torch import ba_ablation as abl
from deep_visual_slam_torch.data import synthetic_multidepth_sequence


def main(argv=None) -> dict:
    """The sweep; returns the record it writes."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[100, 101, 102])
    ap.add_argument("--vo_ckpt", default=None)
    ap.add_argument("--weights", type=float, nargs="+", default=[0.0, 1e2, 1e3, 1e4])
    ap.add_argument("--deltas", type=float, nargs="+", default=[0.05, 0.11])
    ap.add_argument("--step_translation", type=float, default=0.02)
    ap.add_argument("--step_rotation", type=float, default=0.004)
    ap.add_argument("--out_json", default="results/prior_pareto_torch.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)
    H, W = args.size

    nn, provenance = abl.load_networks(args.vo_ckpt, device=args.device)
    device = nn.device
    record = {
        "provenance": {
            "protocol": "net-init windowed-BA sweep, same scenes as "
                        "docs/ba_ablation_net_r04.json",
            "weights": provenance,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "grid": {"pose_prior_weight": args.weights, "huber_delta": args.deltas},
            "seeds": args.seeds,
            "frames": args.frames,
            "size": [H, W],
        },
        "per_config": {},
    }
    scenes = {}
    for seed in args.seeds:
        frames, K, gt_cw, _ = synthetic_multidepth_sequence(
            args.frames, H, W, seed=seed, step_translation=args.step_translation,
            step_rotation=args.step_rotation)
        scenes[seed] = (frames, K, gt_cw)

    def run_cfg(name, optimize, w=1e3, d=0.11):
        per_seed = []
        for seed, (frames, K, gt_cw) in scenes.items():
            traj, kf_ids, _ = abl.run_once(lambda: nn, frames, K, optimize, False,
                                           pose_prior_weight=w, huber_delta=d)
            m = abl.evaluate(traj, gt_cw, kf_ids)
            per_seed.append(m)
            print(f"{name} seed {seed}: {m}", flush=True)
        mean = {k: round(float(np.mean([s[k] for s in per_seed if k in s])), 6)
                for k in per_seed[0]}
        record["per_config"][name] = {"mean": mean, "per_seed": per_seed}
        return mean

    t0 = time.time()
    base = run_cfg("no_ba", optimize=False)
    for w in args.weights:
        for d in args.deltas:
            m = run_cfg(f"w{w:g}_d{d:g}", optimize=True, w=w, d=d)
            m["ate_vs_no_ba_pct"] = round(100 * (m["ate_rmse"] / base["ate_rmse"] - 1), 1)
            m["rpe_pos_vs_no_ba_pct"] = round(
                100 * (m["rpe_pos_mean"] / base["rpe_pos_mean"] - 1), 1)
    record["seconds"] = round(time.time() - t0, 1)

    os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
    with open(args.out_json, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v["mean"] for k, v in record["per_config"].items()}, indent=1))
    print(f"wrote {args.out_json}")
    return record


if __name__ == "__main__":
    main()
