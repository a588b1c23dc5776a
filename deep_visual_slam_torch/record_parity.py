"""The fixture parity harness (port of ``scripts/record_parity.py``).

    python3 -m deep_visual_slam_torch.record_parity [--out results/parity] \\
        [--stages data train_vo warmstart train_depth eval slam] [--vo_ckpt <dir or file>] \\
        [--redwood_root <Redwood tree>] [--nyu_root <dir holding nyu_depth_v2/>] [--device cpu]

With no real Redwood or NYU tree it runs on synthetic fixtures rendered by
the port's own generators at 480x640, scored by the reference's formulas;
``--redwood_root``/``--nyu_root`` point the same stages at real trees.
Stages (the first five by default):

  data        five Redwood-layout test scenes (``apartment`` .. ``loft``,
              50 frames of ``synthetic_slam_sequence`` each, JPEG frames and
              a PoseGraph JSON) and an NYU-layout depth tree (200 train and
              64 test slanted planes whose brightness codes their depth)
  train_vo    a short self-supervised VO run (synthetic snippets, 192x256,
              B=8, 3 epochs)
  warmstart   the first batch's loss from random weights against the loss
              from the just-trained networks, saved as state_dict files and
              loaded through ``Train.pretrained_weights``
  train_depth a short supervised depth run on the NYU-layout tree
  eval        ``RedwoodEvaluator`` with this run's PoseNet (or
              ``--vo_ckpt``'s) and ``DepthMetrics`` with this run's DepthNet
              (or ``--depth_ckpt``'s)
  slam        ``MonoVO`` with ``--vo_ckpt``'s networks over the Redwood
              scenes, BA off (odometry) and on (windowed BA)

Results merge into ``<out>/parity_results.json`` under the JAX script's
keys, so stages can run apart. Everything runs on the card unless
``--device cpu``; nothing here draws (the evaluator writes no figure).
``SCENES``, ``H``, ``W``, ``N_FRAMES``, ``NYU_TRAIN`` and ``NYU_TEST`` set
the fixture's size.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import time

import numpy as np
import torch

from deep_visual_slam_torch import resolve_device

SCENES = ["apartment", "bedroom", "boardroom", "lobby", "loft"]
H, W = 480, 640
N_FRAMES = 50
NYU_TRAIN, NYU_TEST = 200, 64


def make_redwood_fixture(root: str, device=None) -> None:
    """The Redwood-layout test scenes under ``root`` (kept where present)."""
    import cv2

    from deep_visual_slam_torch.data.synthetic import default_intrinsics, synthetic_slam_sequence

    os.makedirs(root, exist_ok=True)
    # The renderer's camera: Redwood's (fx = fy = 525, cx = 319.5, cy =
    # 239.5) at 480x640, rescaled at other sizes.
    np.save(os.path.join(root, "intrinsic.npy"),
            default_intrinsics(H, W)[:3, :3].astype(np.float64))
    for si, scene in enumerate(SCENES):
        sdir = os.path.join(root, "test", scene)
        img_dir = os.path.join(sdir, "image")
        if os.path.exists(os.path.join(sdir, f"{scene}.json")):
            continue
        os.makedirs(img_dir, exist_ok=True)
        frames, _, poses_cw = synthetic_slam_sequence(
            N_FRAMES, H, W, seed=100 + si, step_translation=0.02, step_rotation=0.004,
            device=device)
        nodes = []
        for i in range(N_FRAMES):
            bgr = cv2.cvtColor((frames[i] * 255).astype(np.uint8), cv2.COLOR_RGB2BGR)
            cv2.imwrite(os.path.join(img_dir, f"{i:06d}.jpg"), bgr)
            T_wc = np.linalg.inv(poses_cw[i])  # PoseGraph stores camera-to-world
            nodes.append({"pose": T_wc.flatten(order="F").tolist()})
        with open(os.path.join(sdir, f"{scene}.json"), "w") as f:
            json.dump({"nodes": nodes}, f)
        print(f"rendered {scene}: {N_FRAMES} frames", flush=True)


def make_nyu_fixture(root: str, n_train: int | None = None, n_test: int | None = None) -> None:
    """An NYU-layout tree under ``root/nyu_depth_v2``: textured slanted
    planes whose brightness codes the absolute depth (``z / 5``), so that a
    network can learn the scale from one image; depth PNGs in mm."""
    import cv2

    from deep_visual_slam_torch.data.synthetic import plane_depth, smooth_texture

    n_train = NYU_TRAIN if n_train is None else n_train
    n_test = NYU_TEST if n_test is None else n_test
    for split, n in (("train", n_train), ("test", n_test)):
        d = os.path.join(root, "nyu_depth_v2", split)
        if os.path.isdir(d) and len(os.listdir(d)) >= 2 * n:
            continue
        os.makedirs(d, exist_ok=True)
        rng = np.random.default_rng(0 if split == "train" else 1)
        for i in range(n):
            tex = smooth_texture(rng, 1, H, W)[0]
            z0 = float(rng.uniform(1.5, 4.0))
            slope = float(rng.uniform(-0.8, 0.8))
            depth_m = plane_depth(1, H, W, z0=z0, slope=slope)[0]
            shade = np.clip(depth_m / 5.0, 0.05, 1.0)
            img = np.clip((0.3 * tex + 0.7 * shade[..., None]) * 255, 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(d, f"rgb_{i:05d}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            cv2.imwrite(os.path.join(d, f"depth_{i:05d}.png"), (depth_m * 1000).astype(np.uint16))
        print(f"nyu fixture {split}: {n} samples", flush=True)


def vo_config(out_root: str):
    from deep_visual_slam_torch.utils.config import load_config

    return load_config(overrides={
        "Directory": {
            "exp_name": "parity-vo",
            "data_dir": os.path.join(out_root, "data") + "/",
            "log_dir": os.path.join(out_root, "tb"),
            "weights": os.path.join(out_root, "weights"),
            "results": os.path.join(out_root, "results"),
        },
        "Dataset": {"redwood": {"mono": False}, "synthetic": {"mono": True, "length": 1024}},
        "Train": {"img_h": 192, "img_w": 256, "batch_size": 8, "epoch": 3, "valid_freq": 10,
                  "save_freq": 1, "num_workers": 4, "init_lr": 1e-4},
        "Experiment": {"num_devices": 1},
    })


def depth_config(out_root: str, fixture_root: str, epochs: int = 3):
    from deep_visual_slam_torch.utils.config import load_config

    cfg = load_config(overrides={
        "Directory": {
            "exp_name": "parity-depth",
            "data_dir": fixture_root + "/",
            "log_dir": os.path.join(out_root, "tb"),
            "weights": os.path.join(out_root, "weights"),
            "results": os.path.join(out_root, "results"),
        },
        "Train": {"img_h": 192, "img_w": 256, "batch_size": 8, "epoch": epochs,
                  "valid_freq": 10, "save_freq": 5, "num_workers": 4, "init_lr": 1e-4},
        "Experiment": {"num_devices": 1},
    })
    cfg["Dataset"] = {"nyu_depth_v2": True, "redwood_depth": False}
    return cfg


def _intrinsic4(redwood_root: str) -> np.ndarray:
    K = np.eye(4)
    K[:3, :3] = np.load(os.path.join(redwood_root, "intrinsic.npy"))
    return K


def slam_eval(vo_ckpt: str, redwood_root: str, out: str, global_ba: bool = False,
              device=None) -> dict:
    """``MonoVO`` with ``vo_ckpt``'s networks (a VO trainer checkpoint
    directory or a params-only file), BA off and on, over the Redwood
    scenes, uint8 frames end to end: does the SLAM loop beat its own
    odometry? Written to ``<out>/slam_fixture.json`` and returned."""
    from deep_visual_slam_torch.data.base import read_image_u8
    from deep_visual_slam_torch.eval import ate_rmse, rpe
    from deep_visual_slam_torch.slam import MonoVO, Networks

    K = _intrinsic4(redwood_root)
    nn = Networks.from_checkpoint(vo_ckpt, device=device)
    out_rec = {"vo_ckpt": vo_ckpt, "per_scene": {}, "mean": {}}
    for scene in SCENES:
        sdir = os.path.join(redwood_root, "test", scene)
        with open(os.path.join(sdir, f"{scene}.json")) as f:
            nodes = json.load(f)["nodes"]
        gt_wc = np.array([np.array(n["pose"]).reshape(4, 4, order="F") for n in nodes])
        files = sorted(glob.glob(os.path.join(sdir, "image", "*.jpg")))
        frames = [read_image_u8(fp, H, W) for fp in files]
        res = {}
        for name, opt in (("odometry", False), ("windowed_ba", True)):
            vo = MonoVO(K, image_shape=(H, W), networks=nn, device=nn.device)
            for fr in frames:
                vo.process_frame(fr, optimize=opt)
            if opt and global_ba and len(vo.mp.keyframes) >= 2:
                vo.mp.global_bundle_adjustment(K)
            traj = vo.trajectory()
            _, _, stats = ate_rmse(traj, gt_wc, align=True)
            r = rpe(traj, gt_wc, delta=1)
            res[name] = {
                "ate_rmse": round(stats["ate_rmse"], 6),
                "rpe_pos_mean": round(r["rpe_pos_mean"], 6),
                "rpe_rot_mean_deg": round(r["rpe_rot_mean_deg"], 6),
                "keyframes": len([f for f in vo.mp.frames if f.anchor is f]),
            }
            print(f"{scene} {name}: {res[name]}", flush=True)
        out_rec["per_scene"][scene] = res
    for name in ("odometry", "windowed_ba"):
        for key in ("ate_rmse", "rpe_pos_mean", "rpe_rot_mean_deg"):
            out_rec["mean"].setdefault(name, {})[key] = round(float(np.mean(
                [s[name][key] for s in out_rec["per_scene"].values()])), 6)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "slam_fixture.json"), "w") as f:
        json.dump(out_rec, f, indent=1)
    return out_rec


def _states(*models):
    return [{k: v.detach().cpu() for k, v in m.state_dict().items()} for m in models]


def _close(trainer) -> None:
    trainer.writer.close()
    trainer.ckpt.close()


def main(argv=None) -> dict:
    """The harness; returns the merged record it writes."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="results/parity")
    ap.add_argument("--redwood_root", default=None, help="real Redwood tree (skips the fixture)")
    ap.add_argument("--nyu_root", default=None)
    ap.add_argument("--stages", nargs="*",
                    default=["data", "train_vo", "warmstart", "train_depth", "eval"],
                    help="any of: data train_vo warmstart train_depth eval slam "
                    "(slam needs --vo_ckpt)")
    ap.add_argument("--vo_ckpt", default=None,
                    help="a VO trainer checkpoint directory or params-only file for the "
                    "'slam' stage (and 'eval' without train_vo)")
    ap.add_argument("--depth_epochs", type=int, default=3,
                    help="train_depth epochs (use ~25 for the convergence record)")
    ap.add_argument("--depth_ckpt", default=None,
                    help="a depth trainer checkpoint directory for the depth eval (skips "
                    "train_depth)")
    ap.add_argument("--slam_global_ba", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)
    if "slam" in args.stages and not args.vo_ckpt:
        ap.error("--stages slam requires --vo_ckpt")
    device = resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    redwood_root = args.redwood_root or os.path.join(args.out, "fixture", "redwood")
    nyu_root = args.nyu_root or os.path.join(args.out, "fixture")
    provenance = (f"synthetic fixture scenes (framework renderer), {W}x{H}"
                  if args.redwood_root is None else args.redwood_root)
    if "data" in args.stages and args.redwood_root is None:
        make_redwood_fixture(redwood_root, device)
        make_nyu_fixture(nyu_root)

    results = {"provenance": provenance,
               "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
               "timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}

    vo_states = None
    if "train_vo" in args.stages:
        from deep_visual_slam_torch.training.vo_trainer import Trainer

        t0 = time.time()
        trainer = Trainer(vo_config(args.out), device=device, use_mesh=False)
        trainer.train()
        vo_states = _states(trainer.state.depth_model, trainer.state.pose_model)
        results["vo_train_seconds"] = round(time.time() - t0, 1)
        results["vo_train_steps"] = int(trainer.state.step)
        _close(trainer)

    if "warmstart" in args.stages and vo_states is not None:
        # Loading the just-trained networks through Train.pretrained_weights
        # must start from a lower loss than random weights.
        from deep_visual_slam_torch.data.loader import device_prefetch
        from deep_visual_slam_torch.training.vo_trainer import Trainer

        paths = {}
        for name, sd in zip(("depth", "pose"), vo_states):
            paths[name] = os.path.join(args.out, f"{name}_warm.pth")
            torch.save(sd, paths[name])

        def first_loss(extra):
            cfg = vo_config(args.out)
            cfg["Directory"]["weights"] = os.path.join(args.out, "tmp_w")
            cfg["Train"].update(extra)
            tr = Trainer(cfg, device=device, use_mesh=False)
            tr.state.depth_model.eval()  # the eval step's frozen BatchNorm
            tr.state.pose_model.eval()
            batch = next(iter(device_prefetch(tr.data_loader.train_loader, device)))
            _, losses = tr.eval_step(batch, torch.Generator(device=device).manual_seed(0))
            _close(tr)
            shutil.rmtree(os.path.join(args.out, "tmp_w"), ignore_errors=True)
            return float(losses["loss"])

        loss_random = first_loss({})
        loss_warm = first_loss({"pretrained_weights": paths})
        results["warmstart"] = {"first_batch_loss_random_init": loss_random,
                                "first_batch_loss_pretrained": loss_warm}
        print(f"warmstart: random {loss_random:.4f} vs pretrained {loss_warm:.4f}")

    if "slam" in args.stages:
        results["slam_fixture"] = slam_eval(args.vo_ckpt, redwood_root, args.out,
                                            global_ba=args.slam_global_ba, device=device)

    depth_state = None
    if "train_depth" in args.stages:
        from deep_visual_slam_torch.training.depth_trainer import Trainer as DepthTrainer

        t0 = time.time()
        dtrainer = DepthTrainer(depth_config(args.out, nyu_root, epochs=args.depth_epochs),
                                device=device, use_mesh=False)
        dtrainer.train()
        depth_state = _states(dtrainer.state.depth_model)[0]
        results["depth_train_seconds"] = round(time.time() - t0, 1)
        results["depth_train_epochs"] = args.depth_epochs
        _close(dtrainer)

    if "eval" in args.stages:
        from deep_visual_slam_torch.utils.checkpoint import load_network_states, network_state

        # The trajectory evaluation uses this run's PoseNet or --vo_ckpt's;
        # with neither it is skipped, so that a random PoseNet's numbers
        # never replace recorded ones in the merge below.
        pose_state = None
        if vo_states is not None:
            pose_state = vo_states[1]
        elif args.vo_ckpt:
            tree, step = load_network_states(args.vo_ckpt)
            print(f"eval: trajectory eval on {args.vo_ckpt} @ step {step}")
            pose_state = network_state(tree, "pose")
            results["eval_vo_ckpt"] = f"{args.vo_ckpt} @ step {step}"
        if pose_state is not None:
            from deep_visual_slam_torch.eval.redwood_eval import RedwoodEvaluator, make_pose_fn
            from deep_visual_slam_torch.models import PoseNet

            pose_model = PoseNet()
            pose_model.load_state_dict(pose_state)
            evaluator = RedwoodEvaluator(make_pose_fn(pose_model, device=device), redwood_root,
                                         image_size=(H, W))
            results["redwood"] = evaluator.evaluate(
                SCENES, output_dir=os.path.join(args.out, "redwood_eval"))
            # make_pose_fn runs PoseNet in fp32 (cuDNN's convolutions in TF32
            # on the card, PyTorch's default); the JAX script's ran bf16.
            tf32 = device.type == "cuda" and torch.backends.cudnn.allow_tf32
            results["redwood_pose_dtype"] = "float32" + (" (cuDNN TF32)" if tf32 else "")

        if depth_state is None and args.depth_ckpt:
            tree, dstep = load_network_states(args.depth_ckpt)
            print(f"eval: depth eval on {args.depth_ckpt} @ step {dstep}")
            depth_state = network_state(tree, "depth")
            results["eval_depth_ckpt"] = f"{args.depth_ckpt} @ step {dstep}"
        if depth_state is not None:
            from deep_visual_slam_torch.data.nyu import DepthLoader
            from deep_visual_slam_torch.eval_depth_cli import evaluate
            from deep_visual_slam_torch.models import DepthNet

            t = depth_config(args.out, nyu_root)["Train"]
            model = DepthNet()
            model.load_state_dict(depth_state)
            dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
            _, metrics = evaluate(model, DepthLoader(depth_config(args.out, nyu_root)).valid_loader,
                                  t["min_depth"], t["max_depth"], dtype, device)
            results["depth"] = {k: float(v) for k, v in metrics.items()}

    # Merge over an earlier run, so that stages can run apart.
    out_path = os.path.join(args.out, "parity_results.json")
    if os.path.exists(out_path):
        with open(out_path) as f:
            merged = json.load(f)
        merged.update(results)
        results = merged
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2, default=float)
    print(json.dumps(results, indent=2, default=float))
    print(f"\nwritten: {out_path}")
    return results


if __name__ == "__main__":
    main()
