"""BA ablation: does the photometric BA backend improve trajectories?
(port of ``scripts/ba_ablation.py``)

    python3 -m deep_visual_slam_torch.ba_ablation --init oracle --frames 30 --seeds 100

Runs the SLAM loop (``MonoVO.process_frame``) over synthetic scenes with
known ground-truth poses under three configurations:

  no_ba                    ``optimize=False``: the odometry chain alone
  windowed_ba              ``optimize=True``: windowed photometric BA at
                           every keyframe
  windowed_plus_global_ba  windowed BA, then ``Map.global_bundle_adjustment``
                           over the whole keyframe history at the end

(``--distractor`` adds the ``_unc`` rows, BA with the oracle uncertainty
of the distractor mask.) Each run is scored by the ATE RMSE after a sim(3)
Umeyama alignment, the RPE, and the ATE of the keyframe subset, the only
poses global BA writes back; the numbers are rounded as the JAX script
rounds them. The JSON goes to ``results/ba_ablation_torch.json`` unless
``--out_json`` says otherwise.

The networks are random (``Networks(seed=0)``), on the card unless
``--device cpu``. Not ported: ``--vo_ckpt`` (the trainer's checkpoint
format) and ``--frontend orb`` (cv2); both raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from deep_visual_slam_torch.data import (
    make_oracle_inits,
    synthetic_multidepth_sequence,
    synthetic_slam_sequence,
)
from deep_visual_slam_torch.eval import ate_rmse, rpe
from deep_visual_slam_torch.slam import MonoVO, Networks


def load_networks(vo_ckpt, seed: int = 0, device=None):
    """(networks, provenance): random networks from ``seed``."""
    if vo_ckpt:
        raise NotImplementedError(
            "--vo_ckpt: reading the VO trainer's checkpoint is not ported yet"
        )
    return Networks(seed=seed, device=device), "random-init"


def run_once(nn_factory, frames, K, optimize: bool, global_ba: bool,
             ba_levels=(2, 1), oracle=None, depth_damping=1.0,
             pose_prior_weight=1e3, frontend="klt",
             estimate_affine=False, huber_delta=0.11, uncs=None):
    """One SLAM pass on the networks' device; returns (trajectory T_wc
    [N, 4, 4], keyframe ids, seconds)."""
    nets = nn_factory()
    vo = MonoVO(K, image_shape=frames[0].shape[:2], networks=nets,
                ba_levels=ba_levels, depth_damping=depth_damping,
                pose_prior_weight=pose_prior_weight, frontend=frontend,
                estimate_affine=estimate_affine, huber_delta=huber_delta,
                device=nets.device)
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        kw = {}
        if oracle is not None:
            kw = dict(oracle_depth=oracle[0][i], oracle_rel=oracle[1][i])
        if uncs is not None:
            kw["oracle_uncertainty"] = uncs[i]
        vo.process_frame(f, optimize=optimize, **kw)
    if global_ba and len(vo.mp.keyframes) >= 2:
        vo.mp.global_bundle_adjustment(K)
    traj = vo.trajectory()
    elapsed = time.perf_counter() - t0
    # Every keyframe, marginalized ones included: they left the window but
    # still anchor their segments.
    kf_ids = sorted(f.id for f in vo.mp.frames if f.anchor is f)
    return traj, kf_ids, elapsed


def evaluate(traj_wc, gt_cw, kf_ids):
    """ATE and RPE of the predicted T_wc against the ground truth (given as
    T_cw), and the keyframe-subset ATE with three keyframes or more."""
    gt_wc = np.linalg.inv(np.asarray(gt_cw, np.float64))
    _, _, stats = ate_rmse(traj_wc, gt_wc, align=True)
    r = rpe(traj_wc, gt_wc, delta=1)
    out = {
        "ate_rmse": round(stats["ate_rmse"], 6),
        "rpe_pos_mean": round(r["rpe_pos_mean"], 6),
        "rpe_rot_mean_deg": round(r["rpe_rot_mean_deg"], 6),
    }
    if len(kf_ids) >= 3:
        _, _, kstats = ate_rmse(traj_wc[kf_ids], gt_wc[kf_ids], align=True)
        out["kf_ate_rmse"] = round(kstats["ate_rmse"], 6)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, nargs=2, default=(480, 640), metavar=("H", "W"))
    ap.add_argument("--seeds", type=int, nargs="+", default=[100, 101, 102])
    ap.add_argument("--vo_ckpt", default=None,
                    help="a VO trainer checkpoint (not ported: raises)")
    ap.add_argument("--out_json", default="results/ba_ablation_torch.json")
    ap.add_argument("--scene", choices=("multidepth", "plane"), default="multidepth",
                    help="multidepth (default): piecewise-planar ray-cast scenes, "
                    "BA-identifiable; plane: the single slanted plane (degenerate)")
    ap.add_argument("--step_translation", type=float, default=0.02)
    ap.add_argument("--step_rotation", type=float, default=0.004)
    ap.add_argument("--init", choices=("net", "oracle"), default="net",
                    help="net: network depth and pose; oracle: GT depth and GT "
                    "relative poses with injected noise (multidepth only)")
    ap.add_argument("--rot_noise_deg", type=float, default=0.3,
                    help="oracle init: per-frame rotation noise std (deg)")
    ap.add_argument("--trans_noise", type=float, default=0.005,
                    help="oracle init: per-frame translation noise std (m)")
    ap.add_argument("--depth_noise", type=float, default=0.0,
                    help="oracle init: multiplicative depth noise std")
    ap.add_argument("--ba_levels", type=int, nargs="+", default=[2, 1],
                    help="BA pyramid levels, coarsest first")
    ap.add_argument("--frontend", choices=("klt", "orb"), default="klt",
                    help="orb: not ported (cv2): raises")
    ap.add_argument("--depth_damping", type=float, default=1.0,
                    help="depth-Hessian floor of the BA")
    ap.add_argument("--pose_prior_weight", type=float, default=1e3,
                    help="odometry relative-pose prior weight (D3VO Eq. 15)")
    ap.add_argument("--huber_delta", type=float, default=0.11,
                    help="photometric Huber threshold ([0, 1] intensity units)")
    ap.add_argument("--estimate_affine", action="store_true",
                    help="estimate per-frame brightness (a, b) inside BA")
    ap.add_argument("--distractor", choices=("none", "flicker", "moving"), default="none",
                    help="a photometric-violation slab in every scene (multidepth "
                    "only in the port); adds the _unc rows")
    ap.add_argument("--oracle_unc_value", type=float, default=24.0,
                    help="uncertainty inside the distractor mask (0 outside)")
    ap.add_argument("--exposure_ramp", type=float, default=0.0,
                    help="frame i gain = 1 + ramp*(2*i/(N-1) - 1); 0 = off")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)
    H, W = args.size

    if args.frontend == "orb":
        raise NotImplementedError("--frontend orb: the ORB frontend (cv2) is not ported yet")
    distractor = None if args.distractor == "none" else args.distractor
    if distractor and args.scene != "multidepth":
        raise NotImplementedError(
            "--distractor with --scene plane: the plane sequence's distractor is not ported yet"
        )
    if args.init == "oracle" and args.scene != "multidepth":
        ap.error("--init oracle requires --scene multidepth (needs GT depth)")

    # One set of networks for every configuration: the ablation isolates
    # the backend.
    nn, provenance = load_networks(args.vo_ckpt, device=args.device)
    device = nn.device

    configs = {
        "no_ba": dict(optimize=False, global_ba=False),
        "windowed_ba": dict(optimize=True, global_ba=False),
        "windowed_plus_global_ba": dict(optimize=True, global_ba=True),
    }
    if distractor:
        configs["windowed_ba_unc"] = dict(optimize=True, global_ba=False, oracle_unc=True)
        configs["windowed_plus_global_ba_unc"] = dict(
            optimize=True, global_ba=True, oracle_unc=True
        )
    record = {
        "provenance": {
            "data": f"synthetic {args.scene} scenes ({len(args.seeds)} seeds x "
                    f"{args.frames} frames, {W}x{H}, step_translation="
                    f"{args.step_translation} step_rotation={args.step_rotation})",
            "weights": provenance,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "init": args.init,
            "frontend": args.frontend,
            "ba_levels": list(args.ba_levels),
            "depth_damping": args.depth_damping,
            "pose_prior_weight": args.pose_prior_weight,
            "estimate_affine": args.estimate_affine,
            "exposure_ramp": args.exposure_ramp,
            "huber_delta": args.huber_delta,
            "distractor": args.distractor,
            "oracle_unc_value": args.oracle_unc_value if distractor else None,
            "oracle_noise": (
                dict(rot_deg=args.rot_noise_deg, trans=args.trans_noise, depth=args.depth_noise)
                if args.init == "oracle" else None
            ),
        },
        "per_scene": {},
        "mean": {},
    }

    for seed in args.seeds:
        masks = None
        seq = dict(seed=seed, step_translation=args.step_translation,
                   step_rotation=args.step_rotation)
        if args.scene == "multidepth":
            out = synthetic_multidepth_sequence(args.frames, H, W, distractor=distractor, **seq)
            frames, K, gt_cw, gt_depths = out[:4]
            if distractor:
                masks = out[4]
        else:
            frames, K, gt_cw = synthetic_slam_sequence(args.frames, H, W, device=device, **seq)
        uncs = None
        if masks is not None:
            uncs = [m.astype(np.float32) * args.oracle_unc_value for m in masks]
        if args.exposure_ramp:
            nfr = len(frames)
            frames = [
                np.clip(f * (1.0 + args.exposure_ramp * (2 * i / (nfr - 1) - 1)), 0.0, 1.0)
                .astype(np.float32)
                for i, f in enumerate(frames)
            ]
        oracle = None
        if args.init == "oracle":
            oracle = make_oracle_inits(gt_cw, gt_depths, seed, args.rot_noise_deg,
                                       args.trans_noise, args.depth_noise)
        scene = {}
        for name, cfg in configs.items():
            traj, kf_ids, secs = run_once(
                lambda: nn, frames, K, cfg["optimize"], cfg["global_ba"],
                ba_levels=tuple(args.ba_levels), oracle=oracle,
                depth_damping=args.depth_damping,
                pose_prior_weight=args.pose_prior_weight,
                frontend=args.frontend, estimate_affine=args.estimate_affine,
                huber_delta=args.huber_delta,
                uncs=uncs if cfg.get("oracle_unc") else None,
            )
            m = evaluate(traj, gt_cw, kf_ids)
            m["seconds"] = round(secs, 1)
            m["keyframes"] = len(kf_ids)
            scene[name] = m
            print(f"seed {seed} {name}: {m}", flush=True)
        record["per_scene"][str(seed)] = scene

    for name in configs:
        for key in ("ate_rmse", "rpe_pos_mean", "rpe_rot_mean_deg", "kf_ate_rmse"):
            vals = [s[name][key] for s in record["per_scene"].values() if key in s[name]]
            if vals:
                record["mean"].setdefault(name, {})[key] = round(float(np.mean(vals)), 6)

    os.makedirs(os.path.dirname(args.out_json) or ".", exist_ok=True)
    with open(args.out_json, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record["mean"], indent=1))
    print(f"wrote {args.out_json}")


if __name__ == "__main__":
    main()
