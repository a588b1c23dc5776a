"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card, ``nvcc`` (on PATH,
under ``$CUDA_HOME`` or ``/usr/local/cuda``) and ``nvidia-smi``; it imports
nothing of JAX. Phases, each printed on lines of its own; any failure ends
the run with a non-zero exit code and no result line:

1. The card: its name and power limit (``nvidia-smi``), the TF32 settings,
   and the build of every kernel from ``deep_visual_slam_torch/csrc``.
2. Kernel K1 (the SSIM+L1 reprojection map) against its plain PyTorch
   version on the card, at the step's [16, 480, 640, 3], a ragged
   [2, 37, 53, 3], a [2, 17, 33, 3] whose last tile of the kernels is one
   pixel wide and high, an all-zero image (SSIM denominator C1*C2) and
   ``smooth_texture`` images at [2, 480, 640, 3]: max abs difference,
   median times and the memory bound.
3. K1's backward kernel against the plain version's autograd at the same
   five inputs: dL/dpred and dL/dtarget, median times and the bound.
4. Serving: ``Networks`` at 480x640, B=1, bf16 on 20 synthetic frames
   through ``depth``, ``pose`` and ``step``.
5. Evaluation: the eval step, first at a small size in fp32 against the
   same step on the CPU, then ``make_vo_eval_step`` at the config's
   B=16 x 480x640 in bf16, with K1's launch count per step.
6. Training: one train step at a small size in fp32 against the same step
   on the CPU (losses, the gradient of every parameter, updated weights),
   then ``make_vo_train_step`` at the config's B=16 x 480x640 in bf16 for 4
   steps (10 K1 forward and 8 backward launches a step) and one
   ``make_stereo_train_step`` step (5 and 4), which must leave PoseNet as
   it was.
7. SLAM serving: ``MonoVO`` (KLT frontend, windowed photometric BA at
   levels (2, 1)), which launches no kernel of the port's own. (a) At
   96x128 in fp32 on an oracle-initialized sequence, the card against the
   CPU. (b) At 480x640, 60 frames of seeds 100 and 101 from an oracle
   initialization, without and with BA, against the JAX package's numbers
   (taken on a CPU, ``SLAM_REFERENCE``): the translation RMSE and the
   aligned ATE within rtol 1e-4 without BA, and within 1e-5 m with BA after
   30 frames; over 60 frames BA must move them as it moves JAX's (it raises them on seed 100,
   lowers them on seed 101). (c) At 480x640, ``num_kf=7``, ``max_points=256``,
   bf16 networks and no oracle on a slow sweep: ms per frame by kind, ms
   per BA solve, tracks alive, keyframes, translation RMSE.
8. Global BA over the whole keyframe history (``Map.global_bundle_adjustment``,
   levels (2, 1), 21 iterations) and the BA ablation
   (``deep_visual_slam_torch.ba_ablation``), which launch no kernel of the
   port's own. (a) On phase 7a's runs, whose keyframes outgrew the window of
   4, the card against the CPU: the same keyframes, their poses after global
   BA within ``GLOBAL_SMALL_ATOL``. (b) On phase 7b's frames, seeds 100 and
   101, ``run_once``/``evaluate`` of the ``windowed_plus_global_ba``
   configuration against the JAX package's numbers (``BA_ABLATION_REFERENCE``):
   over 30 frames the ATE and the keyframe ATE within 1e-5 m; over 60 frames
   global BA must move the keyframe ATE from phase 7b's windowed run as it
   moves JAX's. (c) One global solve at the 60-keyframe F bucket (64), at
   480x640: wall ms (median of 5), device ms, launches and busy share under
   ``torch.profiler``, no synchronising call, device memory high-water.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Full fp32 wherever the port computes in fp32 (the kernel comparisons and
# the small-input reference check); the bf16 phases run under autocast and
# are not affected. cuDNN's default would run fp32 convolutions in TF32.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# K1 against its plain version: both are fp32, the kernel sums the nine
# taps in the plain version's order and is built without FMA contraction,
# so they differ only where PyTorch's channel mean and its own fused
# arithmetic round otherwise: a few ulp of values in [0, 1].
K1_TOL = 1e-5
# Device memory rate and fp32 (non-tensor-core) rate by card, from NVIDIA's
# data sheets, for the least time the card could take for K1's work.
CARD_RATES = {  # name fragment: (bytes/s, fp32 FLOP/s)
    "H100 80GB HBM3": (3.35e12, 67e12),
    "H100 SXM": (3.35e12, 67e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100 PCIe": (2.0e12, 51e12),
    "H200": (4.8e12, 67e12),
}
# fp32 operations K1 does per pixel: per channel 9 taps x 8 for the five
# box sums, then moments, SSIM, clamp and L1 (33); the channel means and
# the blend once per pixel (5).
K1_OPS_PER_CHANNEL = 9 * 8 + 33
K1_OPS_PER_PIXEL = 5
# K1's backward against the plain version's autograd: fp32 both, sums in
# other orders (the plain reflect-padding backward adds with atomics), the
# window moments' cancellation amplifies a last-bit difference up to ~1e2:
# max abs difference within 2e-5 of the largest gradient.
K1_BWD_RTOL = 2e-5
# fp32 operations of K1's backward per channel-pixel: the window sums and
# SSIM as in the forward (9 x 8 + 33), the chain rule to the three window
# coefficients (30), the 3x3 gather with multiplicities (9 x 6) and the
# final combination with the L1 term (6); per pixel the scaling of g (5).
K1_BWD_OPS_PER_CHANNEL = 9 * 8 + 33 + 30 + 9 * 6 + 6
K1_BWD_OPS_PER_PIXEL = 5
# The train step on the card against the CPU at 2x64x96 fp32: losses rtol
# 1e-4 and the gradient norm 1e-3 (fp32 sums in other orders). The
# gradient within 1e-2 of its 2-norm, and each parameter's within 1e-1 of
# its own: fp32 rounding decides near-ties (auto-mask minima, ReLU kinks of
# nearly constant BatchNorm channels) one pixel or channel at a time, which
# moves single leaves by a few percent (tests/test_torch_train_step.py),
# while a wrong gradient on a leaf is off by 1 or more. BatchNorm statistics
# rtol 1e-4, atol 1e-5. The updated weights only show that the update was
# applied: a first Adam step moves each by at most lr, so atol 2.5e-4.
TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL = 1e-4, 1e-3
TRAIN_GRAD_RTOL, TRAIN_GRAD_LEAF_RTOL = 1e-2, 1e-1
TRAIN_WEIGHT_ATOL, TRAIN_STATS_RTOL, TRAIN_STATS_ATOL = 2.5e-4, 1e-4, 1e-5
# The SLAM loop at 96x128 in fp32 on the card against the CPU (phase 7a):
# the same keyframes, and camera poses within 1e-4 (the CPU port agrees with
# the JAX loop to 2.5e-7; the card sums in other orders, and the LM solves
# and the pose chain carry that along).
SLAM_SMALL_ATOL = 1e-4
# The JAX package's SLAM loop on the same 480x640 frames (phase 7b), from
#   JAX_PLATFORMS=cpu python scripts/slam_reference.py --size 480 640 \
#       --frames FRAMES --seed SEED
# on a CPU: the unaligned translation RMSE of the camera centres against GT
# and the ATE RMSE after a sim(3) Umeyama alignment (the BA ablation's
# metric), in metres, and the keyframe count. The first 30 frames of a
# sequence are the 30-frame sequence (the renders and the oracle's draws run
# frame by frame), so one 60-frame run gives both readings. On seed 100 the
# JAX package's windowed BA raises both metrics over 60 frames (its BA
# ablation recorded the aligned ATE falling from 0.013544 to 0.011697 there
# at the time; the first number still holds); on seed 101 it lowers both,
# and so must the port's.
SLAM_REFERENCE = {
    100: {
        30: {"windowed_ba": {"translation_rmse": 0.017707589665498166,
                             "ate_rmse": 0.006839735422733904}, "keyframes": 30},
        60: {
            "no_ba": {"translation_rmse": 0.025024774648370787,
                      "ate_rmse": 0.013543948244046733},
            "windowed_ba": {"translation_rmse": 0.0312581205865517,
                            "ate_rmse": 0.014577868205919395},
            "keyframes": 60,
        },
    },
    101: {
        30: {"windowed_ba": {"translation_rmse": 0.006700996334501043,
                             "ate_rmse": 0.0035823184114559255}, "keyframes": 30},
        60: {
            "no_ba": {"translation_rmse": 0.05536580215268624,
                      "ate_rmse": 0.017282478078937364},
            "windowed_ba": {"translation_rmse": 0.02639569286734769,
                            "ate_rmse": 0.011402612251374147},
            "keyframes": 60,
        },
    },
}
# Without BA the poses are the oracle's chain: the RMSEs agree to 1e-4 over
# 60 frames. With BA, over the first 30 frames the port follows JAX to the
# last bits the LM solves amplify: the port on a CPU lands within 1.2e-6 m of
# JAX's metrics (both on a CPU), so the card is held within 1e-5 m, against
# moves of 2.7-36 mm that BA makes there. Later the tracker's chaos takes
# over: LK chains each track from frame to frame, and fp32 sums taken in
# other orders move a track by 1e-3 px over 30 frames, 0.2 px over 47 and
# then flip keypoints and LM decisions (the port against JAX, both on a CPU,
# seed 101), so over 60 frames only the sign of BA's move is held: on seed
# 100 BA must raise both metrics, on seed 101 lower both.
SLAM_NO_BA_RTOL = 1e-4
SLAM_BA_30_ATOL = 1e-5
SLAM_SERVE_FRAMES = 40
# Global BA at 96x128 in fp32 (phase 8a), the card against the CPU: the
# keyframe poses after the solve within 1e-5, as the CPU port is held to JAX
# on a 14-frame run (tests/test_torch_slam.py). On an H100 the two agreed to
# 2.49e-07 while global BA moved the poses by 2.21e-03 (two runs, the same
# readings): the limit sits ~40x above the one and ~200x below the other.
GLOBAL_SMALL_ATOL = 1e-5
# The JAX package's BA ablation on phase 7b's frames (phase 8b), from
#   JAX_PLATFORMS=cpu python scripts/ba_ablation.py --init oracle \
#       --frames FRAMES --seeds 100 101 --out_json <a path outside the repo>
# on a CPU: the ATE RMSE after a sim(3) alignment and that of the keyframe
# subset, in metres, rounded to 6 digits by the script. Its windowed_ba ATE
# over 30 frames equals SLAM_REFERENCE's to those digits: the ablation's
# networks are bf16 and slam_reference.py's fp32, but with the oracle's
# depth and odometry they feed nothing into the loop but their (unused)
# outputs, and neither run predicts uncertainty.
BA_ABLATION_REFERENCE = {
    100: {
        30: {"windowed_ba": {"ate_rmse": 0.00684, "kf_ate_rmse": 0.00684},
             "windowed_plus_global_ba": {"ate_rmse": 0.006723, "kf_ate_rmse": 0.006723}},
        60: {"windowed_ba": {"ate_rmse": 0.014578, "kf_ate_rmse": 0.014578},
             "windowed_plus_global_ba": {"ate_rmse": 0.010763, "kf_ate_rmse": 0.010763}},
    },
    101: {
        30: {"windowed_ba": {"ate_rmse": 0.003582, "kf_ate_rmse": 0.003582},
             "windowed_plus_global_ba": {"ate_rmse": 0.004343, "kf_ate_rmse": 0.004343}},
        60: {"windowed_ba": {"ate_rmse": 0.011403, "kf_ate_rmse": 0.011403},
             "windowed_plus_global_ba": {"ate_rmse": 0.011381, "kf_ate_rmse": 0.011381}},
    },
}
# Over 30 frames the port on a CPU lands on JAX's rounded numbers to the
# last digit (1e-6 m), so the card is held within 1e-5 m, against global
# BA's moves of 0.12 and 0.76 mm there (seeds 100 and 101). Over 60 frames
# the loop is chaotic (phase 7b): only the sign of global BA's move.
GLOBAL_30_ATOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Time per call of ``fn`` on the card: ``reps`` calls back to back
    between one pair of CUDA events, divided by ``reps``; the median of five
    such runs after three warm calls. The host queues the calls ahead of the
    card, so its dispatch is hidden wherever a call keeps the card busy for
    longer than the host takes to launch it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def phase_card():
    from deep_visual_slam_torch.utils import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print("phase 1: card")
    print(smi)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}"
    )
    rates = [v for k, v in CARD_RATES.items() if k in name]
    check(bool(rates), f"no memory/fp32 rates on record for {name!r}")
    seconds = cuda_build.build_all()
    print(f"built {sorted(cuda_build.SOURCES)} in {seconds:.2f} s")
    return rates[0], smi


def k1_inputs():
    """The K1 checks' inputs: the step's shape, a ragged shape and one whose
    last 32 x 16 tile of the kernels is one column wide and one row high,
    the all-zero image, and a pair of band-limited textures (the synthetic
    data's), whose smooth windows make SSIM's ``Sxx/9 - mu^2`` cancel most."""
    from deep_visual_slam_torch.data import smooth_texture

    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, device="cuda", generator=g)

    smooth = smooth_texture(np.random.default_rng(2), 4, 480, 640)
    smooth = torch.from_numpy(np.ascontiguousarray(smooth)).to("cuda")
    return {
        "random [16,480,640,3]": (rand(16, 480, 640, 3), rand(16, 480, 640, 3)),
        "ragged [2,37,53,3]": (rand(2, 37, 53, 3), rand(2, 37, 53, 3)),
        "tile edges [2,17,33,3]": (rand(2, 17, 33, 3), rand(2, 17, 33, 3)),
        "zeros [2,48,64,3]": (
            torch.zeros((2, 48, 64, 3), device="cuda"),
            torch.zeros((2, 48, 64, 3), device="cuda"),
        ),
        "smooth_texture [2,480,640,3]": (smooth[:2], smooth[2:]),
    }


def phase_k1(rates):
    from deep_visual_slam_torch.ops import photometric_cuda as k1

    print("phase 2: K1 reprojection_loss against its plain version")
    cases = k1_inputs()
    max_err = 0.0
    for label, (pred, target) in cases.items():
        out = k1.reprojection_loss(pred, target, 0.85)
        torch.cuda.synchronize()
        ref = k1.reprojection_loss_plain(pred, target, 0.85)
        check(out.shape == ref.shape == pred.shape[:3] + (1,), f"K1 shape {label}")
        err = (out - ref).abs().max().item()
        print(f"  {label}: max |kernel - plain| = {err:.3e} (tolerance {K1_TOL:.0e})")
        check(err <= K1_TOL, f"K1 {label} within {K1_TOL}")
        max_err = max(max_err, err)

    pred, target = cases["random [16,480,640,3]"]
    # The kernel's means multiply by fl(1/9), as it takes PyTorch's CUDA
    # division of a tensor by a Python scalar to do: held on this card.
    quotient = pred / 9.0
    inv9 = (torch.tensor(1.0) / 9.0).to("cuda")
    check(torch.equal(quotient, pred * inv9), "x / 9.0 is x * fl(1/9) on the card")
    rounded = (pred.double() / 9.0).float()
    print(f"  x / 9.0 equals x * fl(1/9) on all {pred.numel()} values; it differs "
          f"from the correctly rounded quotient on {int((quotient != rounded).sum())}")
    B, H, W, C = pred.shape
    ms = cuda_ms(lambda: k1.reprojection_loss(pred, target, 0.85), 50)
    plain_ms = cuda_ms(lambda: k1.reprojection_loss_plain(pred, target, 0.85), 10)
    nbytes = 2 * pred.numel() * 4 + B * H * W * 4
    ops = B * H * W * (K1_OPS_PER_CHANNEL * C + K1_OPS_PER_PIXEL)
    bytes_ms, ops_ms = nbytes / rates[0] * 1e3, ops / rates[1] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"  [16,480,640,3]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
        "(per call, 50 and 10 calls back to back, median of 5); bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at {rates[0] / 1e12:.2f} TB/s; "
        f"{ops / 1e9:.2f} GFLOP fp32 takes {ops_ms:.4f} ms); no single "
        "PyTorch call computes this function, so no library yardstick"
    )
    return {
        "name": "reprojection_loss",
        "route": "cuda",
        "source": "deep_visual_slam_torch/csrc/reprojection.cu",
        "replaces": "deep_visual_slam_tpu/ops/pallas/photometric_pallas.py:41",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def phase_k1_backward(rates):
    from deep_visual_slam_torch.ops import photometric_cuda as k1

    print("phase 3: K1 backward against the plain version's autograd")
    gen = torch.Generator(device="cuda").manual_seed(1)
    max_err = 0.0
    for label, (pred, target) in k1_inputs().items():
        g = 0.5 + torch.rand(pred.shape[:3] + (1,), device="cuda", generator=gen)
        grads = []
        for fn in (k1.reprojection_loss, k1.reprojection_loss_plain):
            p, t = pred.clone().requires_grad_(), target.clone().requires_grad_()
            fn(p, t, 0.85).backward(g)
            torch.cuda.synchronize()
            grads.append((p.grad, t.grad))
        for name, got, want in zip(("dpred", "dtarget"), *grads):
            check(got.shape == want.shape == pred.shape, f"K1 bwd {name} shape {label}")
            check(bool(torch.isfinite(got).all()), f"K1 bwd {name} finite {label}")
            err = (got - want).abs().max().item()
            tol = K1_BWD_RTOL * want.abs().max().item()
            print(f"  {label} {name}: max |kernel - plain| = {err:.3e} "
                  f"(tolerance {tol:.3e} = {K1_BWD_RTOL:.0e} x max |plain|)")
            check(err <= tol, f"K1 bwd {label} {name} within {tol:.3e}")
            max_err = max(max_err, err)

    pred, target = k1_inputs()["random [16,480,640,3]"]
    B, H, W, C = pred.shape
    g = 0.5 + torch.rand((B, H, W, 1), device="cuda", generator=gen)
    ms = cuda_ms(lambda: k1.reprojection_loss_backward(pred, target, g, 0.85), 50)
    p = pred.clone().requires_grad_()
    out = k1.reprojection_loss_plain(p, target, 0.85)
    plain_ms = cuda_ms(
        lambda: torch.autograd.grad(out, p, g, retain_graph=True), 10
    )
    nbytes = 3 * pred.numel() * 4 + B * H * W * 4  # pred, target, g in; dpred out
    ops = B * H * W * (K1_BWD_OPS_PER_CHANNEL * C + K1_BWD_OPS_PER_PIXEL)
    bytes_ms, ops_ms = nbytes / rates[0] * 1e3, ops / rates[1] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"  [16,480,640,3] dL/dpred: kernel {ms:.4f} ms, plain autograd "
        f"backward {plain_ms:.4f} ms (per call, 50 and 10 calls back to back, "
        f"median of 5); bound "
        f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at {rates[0] / 1e12:.2f} "
        f"TB/s; {ops / 1e9:.2f} GFLOP fp32 takes {ops_ms:.4f} ms); no single "
        "PyTorch call computes this gradient, so no library yardstick"
    )
    return {
        "name": "reprojection_loss_backward",
        "route": "cuda",
        "source": "deep_visual_slam_torch/csrc/reprojection.cu",
        "replaces": "deep_visual_slam_tpu/ops/pallas/photometric_pallas.py:136",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }


def phase_serving(k1):
    from deep_visual_slam_torch.data import smooth_texture
    from deep_visual_slam_torch.slam import Networks

    print("phase 4: serving, Networks at 480x640, B=1, bf16, 20 frames")
    H, W = 480, 640
    frames = smooth_texture(np.random.default_rng(1), 20, H, W)
    frames = (frames * 255).round().astype(np.uint8)
    nets = Networks(dtype=torch.bfloat16, seed=0)
    k1.launches = 0
    depth = nets.depth(frames[0])
    T = nets.pose(frames[0], frames[1])
    for d, what in ((depth, "depth"), (T, "pose")):
        check(np.isfinite(d).all(), f"{what} finite")
    check(depth.shape == (H, W) and T.shape == (4, 4), "depth/pose shapes")
    nets.step(frames[0], frames[1])  # warm
    per_frame, translations = [], []
    for i in range(1, 21):
        start = time.perf_counter()
        depth, T = nets.step(frames[i - 1], frames[i % 20])
        per_frame.append((time.perf_counter() - start) * 1e3)
        check(depth.shape == (H, W) and T.shape == (4, 4), "step shapes")
        check(np.isfinite(depth).all() and np.isfinite(T).all(), "step finite")
        check(0.1 <= depth.min() and depth.max() <= 10.0, "depth in [0.1, 10]")
        translations.append(np.abs(T[:3, 3]).max())
    # The pose head scales its output by 0.01: random weights give
    # translations of that order, not of metres.
    t_max = max(translations)
    check(0 < t_max < 0.05, f"|translation| {t_max:.2e} of the 0.01 scale")
    print(
        f"  step: {statistics.median(per_frame):.3f} ms/frame median "
        f"({statistics.mean(per_frame):.3f} mean) over 20 frames, host clock "
        f"with the result on the host; max |t| {t_max:.2e}; K1 launches "
        f"{k1.launches} (serving runs no kernel)"
    )


def phase_eval(k1, k1_ms, config):
    from deep_visual_slam_torch.data import synthetic_vo_batch
    from deep_visual_slam_torch.training import (
        VOLossConfig,
        init_vo_models,
        make_vo_eval_step,
    )

    print("phase 5: evaluation step")
    train = config["Train"]
    cfg = VOLossConfig.from_config(config)
    seed = train["seed"]

    def models():
        return init_vo_models(seed, predict_uncertainty=cfg.uncertainty)

    # Small input, fp32: the card (kernel K1, cuDNN, CUDA grid_sample)
    # against the same step on the CPU (plain versions) with the same
    # weights, batch and tie-break noise.
    batch, _ = synthetic_vo_batch(seed, 2, 64, 96, device="cpu")
    noise = [torch.randn(2, 64, 96, 2, generator=torch.Generator().manual_seed(s))
             for s in range(cfg.num_scales)]
    results = []
    for device in ("cpu", "cuda"):
        step = make_vo_eval_step(*models(), cfg, torch.float32, device=device)
        keep, losses = step(batch, noise=noise)
        results.append((keep, losses))
    (kc, lc), (kg, lg) = results
    worst = 0.0
    for k in lc:
        rel = abs(lg[k].item() - lc[k].item()) / abs(lc[k].item())
        worst = max(worst, rel)
    for k in kc:
        err = (kg[k].cpu() - kc[k]).abs().max().item()
        check(err <= 1e-4 + 1e-4 * kc[k].abs().max().item(), f"small {k}: {err:.2e}")
    check(worst <= 1e-4, f"small losses within rtol 1e-4 (worst {worst:.2e})")
    print(f"  2x64x96 fp32, card vs CPU: losses within rtol {worst:.2e} (<= 1e-4)")

    B, H, W = train["batch_size"], train["img_h"], train["img_w"]
    dtype = getattr(torch, train["compute_dtype"])
    step = make_vo_eval_step(*models(), cfg, dtype)
    batch, _ = synthetic_vo_batch(seed, B, H, W)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_steps = 4
    k1.launches = k1.backward_launches = 0
    times = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        start = time.perf_counter()
        keep, losses = step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        check(all(torch.isfinite(v).all() for v in losses.values()), "losses finite")
        check(keep["disp_0"].shape == (B, H, W, 1), "disp_0 shape")
        check(k1.launches == 10 * (i + 1), f"K1 launches {k1.launches} after {i + 1} steps")
    launches = k1.launches
    check(k1.backward_launches == 0, "no K1 backward in the eval step")
    step_ms = statistics.median(times[1:])
    print(
        f"  B={B} {H}x{W} {train['compute_dtype']}: {step_ms:.2f} ms/step "
        f"(median of {n_steps - 1} after a warm step, host clock); loss "
        f"{losses['loss'].item():.5f}; K1 launches {launches} in {n_steps} "
        f"steps = 10 per step; K1 share ~ 10 x {k1_ms:.4f} ms / step = "
        f"{10 * k1_ms / step_ms:.1%}"
    )
    return launches


def _weights(model):
    """Every parameter and BatchNorm statistic of ``model``, on the CPU."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def phase_train(k1, k1_ms, k1_bwd_ms, config):
    from deep_visual_slam_torch.data import synthetic_stereo_batch, synthetic_vo_batch
    from deep_visual_slam_torch.training import (
        TrainState,
        VOLossConfig,
        init_vo_models,
        make_stereo_train_step,
        make_vo_train_step,
    )

    print("phase 6: train step")
    train = config["Train"]
    cfg = VOLossConfig.from_config(config)
    seed = train["seed"]

    def start():
        # The JAX trainer's optimizer: Adam, polynomial decay to 0.
        depth, pose = init_vo_models(seed, predict_uncertainty=cfg.uncertainty)
        return TrainState.create(
            depth, pose, train["init_lr"], total_steps=100,
            beta1=train.get("beta1", 0.9),
        )

    # Small input, fp32: one step on the card (K1 forward and backward,
    # cuDNN, CUDA grid_sample, torch.optim) against the same step on the
    # CPU (plain versions) with the same weights, batch and noise.
    batch, _ = synthetic_vo_batch(seed, 2, 64, 96, device="cpu")
    noise = [torch.randn(2, 64, 96, 2, generator=torch.Generator().manual_seed(s))
             for s in range(cfg.num_scales)]
    results = []
    for device in ("cpu", "cuda"):
        state = start()
        step = make_vo_train_step(
            state.depth_model, state.pose_model, cfg, torch.float32, device=device
        )
        losses = step(state, batch, noise=noise)
        weights, grads = {}, {}
        for name, model in (("depth", state.depth_model), ("pose", state.pose_model)):
            weights.update({f"{name}.{k}": v for k, v in _weights(model).items()})
            grads.update({f"{name}.{k}": p.grad.detach().cpu()
                          for k, p in model.named_parameters()})
        results.append(({k: v.item() for k, v in losses.items()}, weights, grads))
    (lc, wc, gc), (lg, wg, gg) = results
    worst_loss = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc if k != "grad_norm")
    rel_norm = abs(lg["grad_norm"] - lc["grad_norm"]) / lc["grad_norm"]
    sq_err = sq_want = worst_leaf = 0.0
    for k, want in gc.items():
        err, scale = (gg[k] - want).norm().item(), want.norm().item()
        worst_leaf = max(worst_leaf, err / scale)
        sq_err, sq_want = sq_err + err**2, sq_want + scale**2
    rel_grad = (sq_err / sq_want) ** 0.5
    worst_w = worst_s = 0.0
    for k, v in wc.items():
        err = (wg[k] - v).abs()
        if k.endswith(("running_mean", "running_var")):
            worst_s = max(worst_s, (err / (TRAIN_STATS_ATOL + TRAIN_STATS_RTOL * v.abs()))
                          .max().item())
        else:
            worst_w = max(worst_w, err.max().item())
    print(
        f"  2x64x96 fp32, card vs CPU: losses within rtol {worst_loss:.2e} "
        f"(<= {TRAIN_LOSS_RTOL:.0e}), grad_norm {lg['grad_norm']:.6f} vs "
        f"{lc['grad_norm']:.6f}, rtol {rel_norm:.2e} (<= {TRAIN_GRAD_NORM_RTOL:.0e}); "
        f"gradient within {rel_grad:.2e} of its 2-norm (<= {TRAIN_GRAD_RTOL:.0e}), "
        f"worst of {len(gc)} parameters within {worst_leaf:.2e} of its own "
        f"(<= {TRAIN_GRAD_LEAF_RTOL:.0e}); updated weights within atol "
        f"{worst_w:.2e} (<= {TRAIN_WEIGHT_ATOL:.1e}); BatchNorm statistics at "
        f"{worst_s:.2f} of their tolerance"
    )
    check(worst_loss <= TRAIN_LOSS_RTOL, "small train losses")
    check(rel_norm <= TRAIN_GRAD_NORM_RTOL, "small train grad_norm")
    check(rel_grad <= TRAIN_GRAD_RTOL, "small train gradient")
    check(worst_leaf <= TRAIN_GRAD_LEAF_RTOL, "small train gradient of each parameter")
    check(worst_w <= TRAIN_WEIGHT_ATOL, "small train updated weights")
    check(worst_s <= 1.0, "small train BatchNorm statistics")

    B, H, W = train["batch_size"], train["img_h"], train["img_w"]
    dtype = getattr(torch, train["compute_dtype"])
    state = start()
    step = make_vo_train_step(
        state.depth_model, state.pose_model, cfg, dtype,
        remat=train.get("remat", False),
        device_augment=train.get("device_augment", False),
    )
    batch, _ = synthetic_vo_batch(seed, B, H, W)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    before = {"depth": _weights(state.depth_model), "pose": _weights(state.pose_model)}
    n_steps = 4
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.backward_launches = 0
    times, loss_curve = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        start_t = time.perf_counter()
        losses = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start_t) * 1e3)
        check(all(bool(torch.isfinite(v)) for v in losses.values()), "train losses finite")
        check(k1.launches == 10 * (i + 1) and k1.backward_launches == 8 * (i + 1),
              f"K1 launches {k1.launches} forward, {k1.backward_launches} "
              f"backward after {i + 1} train steps")
        loss_curve.append(losses["loss"].item())
    train_launches = (k1.launches, k1.backward_launches)
    for name, model in (("depth", state.depth_model), ("pose", state.pose_model)):
        after = _weights(model)
        still = [k for k, v in before[name].items()
                 if not k.endswith(("running_mean", "running_var"))
                 and torch.equal(after[k], v)]
        check(not still, f"{name} parameters that did not move: {still[:3]}")
    step_ms = statistics.median(times[1:])
    print(
        f"  B={B} {H}x{W} {train['compute_dtype']}: {step_ms:.2f} ms/step "
        f"(median of {n_steps - 1} after a warm step, host clock; first step "
        f"{times[0]:.1f} ms); loss {' -> '.join(f'{l:.5f}' for l in loss_curve)}; "
        f"grad_norm {losses['grad_norm'].item():.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K1 launches "
        f"{train_launches[0]} forward, {train_launches[1]} backward in {n_steps} "
        f"steps = 10 and 8 per step; K1 share ~ (10 x {k1_ms:.4f} + 8 x "
        f"{k1_bwd_ms:.4f}) ms / step = {(10 * k1_ms + 8 * k1_bwd_ms) / step_ms:.1%}; "
        "all parameters of both networks moved"
    )

    # One stereo step on the same state: PoseNet must not move.
    stereo = make_stereo_train_step(state.depth_model, cfg, dtype)
    sbatch, _ = synthetic_stereo_batch(seed, B, H, W)
    pose_params = list(state.pose_model.parameters())
    pose_before = [p.detach().clone() for p in pose_params]
    moments_before = [{k: v.clone() for k, v in state.optimizer.state[p].items()}
                      for p in pose_params]
    depth_before = _weights(state.depth_model)
    k1.launches = k1.backward_launches = 0
    torch.cuda.synchronize()
    start_t = time.perf_counter()
    losses = stereo(state, sbatch, gen)
    torch.cuda.synchronize()
    stereo_ms = (time.perf_counter() - start_t) * 1e3
    stereo_launches = (k1.launches, k1.backward_launches)
    check(stereo_launches == (5, 4), f"K1 launches {stereo_launches} in a stereo step")
    check(all(bool(torch.isfinite(v)) for v in losses.values()), "stereo losses finite")
    for p, old, moments in zip(pose_params, pose_before, moments_before):
        check(torch.equal(p, old), "PoseNet parameter moved in a stereo step")
        for k, v in state.optimizer.state[p].items():
            if k == "step":
                check(v.item() == moments[k].item() + 1, "Adam count advanced")
            else:
                check(torch.equal(v, moments[k]), f"PoseNet Adam {k} moved")
    depth_after = _weights(state.depth_model)
    check(any(not torch.equal(depth_after[k], v) for k, v in depth_before.items()),
          "DepthNet moved in a stereo step")
    print(
        f"  stereo B={B} {H}x{W} {train['compute_dtype']}: {stereo_ms:.2f} ms "
        f"(one step, host clock); loss {losses['loss'].item():.5f}; K1 launches "
        f"{stereo_launches[0]} forward, {stereo_launches[1]} backward; PoseNet "
        "parameters and Adam moments unchanged, its Adam count advanced"
    )
    return train_launches, stereo_launches


def _slam_run(vo, frames, oracle=None, optimize=True, log=None):
    """Every frame through ``vo.process_frame``; with ``log``, appends
    (host ms, keyframe?, tracks alive) per frame. Returns (trajectory T_wc,
    keyframe ids)."""
    for i, frame in enumerate(frames):
        kw = {} if oracle is None else dict(oracle_depth=oracle[0][i], oracle_rel=oracle[1][i])
        n_kf = vo.n_keyframes
        start = time.perf_counter()
        vo.process_frame(frame, optimize=optimize, **kw)
        ms = (time.perf_counter() - start) * 1e3
        if log is not None:
            log.append((ms, vo.n_keyframes > n_kf, int(vo.klt.alive.sum())))
    traj = vo.trajectory()
    check(np.isfinite(traj).all(), "SLAM trajectory finite")
    return traj, sorted(f.id for f in vo.mp.frames if f.anchor is f)


def phase_slam(k1):
    from deep_visual_slam_torch.data import make_oracle_inits, synthetic_multidepth_sequence
    from deep_visual_slam_torch.eval import ate_rmse
    from deep_visual_slam_torch.slam import MonoVO, Networks

    print("phase 7: SLAM serving, MonoVO (KLT frontend, windowed BA at levels (2, 1))")
    k1.launches = k1.backward_launches = 0
    start_phase = time.perf_counter()

    # (a) 96x128 fp32, oracle initialization: the card against the CPU.
    frames, K, gt, depths = synthetic_multidepth_sequence(
        10, 96, 128, seed=3, step_translation=0.02, step_rotation=0.004
    )
    oracle = make_oracle_inits(gt, depths, 3, 0.3, 0.005, 0.0)
    runs, small_vos = {}, {}
    for device in ("cpu", "cuda"):
        nets = Networks(dtype=torch.float32, seed=0, device=device)
        vo = MonoVO(K, networks=nets, image_shape=(96, 128), num_kf=4, max_points=64,
                    device=device)
        runs[device] = _slam_run(vo, frames, oracle)
        small_vos[device] = vo
    kept = {"small": (K, small_vos), "seeds": {}}
    (traj_c, kf_c), (traj_g, kf_g) = runs["cpu"], runs["cuda"]
    err = float(np.abs(traj_g - traj_c).max())
    print(f"  (a) 96x128 fp32, 10 frames, oracle init: keyframes {kf_g} on the card, "
          f"{kf_c} on the CPU; poses within {err:.2e} (tolerance {SLAM_SMALL_ATOL:.0e})")
    check(kf_g == kf_c, "SLAM keyframes on the card and the CPU")
    check(err <= SLAM_SMALL_ATOL, f"SLAM poses on the card and the CPU within {SLAM_SMALL_ATOL}")

    # (b) 480x640, 60 frames, oracle initialization: without and with BA,
    # each against the JAX package's numbers on the same frames; the run with
    # BA is read after 30 frames as well.
    H, W = 480, 640
    nets = Networks(dtype=torch.bfloat16, seed=0)

    def metrics(traj, gt_wc):
        return {"translation_rmse": ate_rmse(traj, gt_wc[: len(traj)], align=False)[0],
                "ate_rmse": ate_rmse(traj, gt_wc[: len(traj)])[0]}

    for seed, refs in SLAM_REFERENCE.items():
        frames, K, gt, depths = synthetic_multidepth_sequence(
            60, H, W, seed=seed, step_translation=0.02, step_rotation=0.004
        )
        depths, rels = make_oracle_inits(gt, depths, seed, 0.3, 0.005, 0.0)
        gt_wc = np.linalg.inv(np.asarray(gt, np.float64))
        got = {30: {}, 60: {}}
        vo = MonoVO(K, networks=nets, image_shape=(H, W))
        traj, kfs = _slam_run(vo, frames[:30], (depths[:30], rels[:30]))
        got[30]["windowed_ba"], got[30]["keyframes"] = metrics(traj, gt_wc), len(kfs)
        windowed_30 = (traj, kfs)
        traj, kfs = _slam_run(vo, frames[30:], (depths[30:], rels[30:]))
        got[60]["windowed_ba"], got[60]["keyframes"] = metrics(traj, gt_wc), len(kfs)
        kept["seeds"][seed] = dict(frames=frames, K=K, gt=gt, oracle=(depths, rels), vo=vo,
                                   windowed={30: windowed_30, 60: (traj, kfs)})
        traj, kfs = _slam_run(MonoVO(K, networks=nets, image_shape=(H, W)), frames,
                              (depths, rels), optimize=False)
        got[60]["no_ba"] = metrics(traj, gt_wc)
        check(len(kfs) == got[60]["keyframes"], "keyframes without BA as with it")
        r30, g30, r60, g60 = refs[30], got[30], refs[60], got[60]
        print(
            f"  (b) 480x640, seed {seed}, oracle init (0.3 deg, 0.005 m), metres, the card "
            f"(the JAX package): translation RMSE without BA over 60 frames "
            f"{g60['no_ba']['translation_rmse']:.6f} ({r60['no_ba']['translation_rmse']:.6f}); "
            f"with windowed BA over 30 frames {g30['windowed_ba']['translation_rmse']:.8f} "
            f"({r30['windowed_ba']['translation_rmse']:.8f}), over 60 "
            f"{g60['windowed_ba']['translation_rmse']:.6f} "
            f"({r60['windowed_ba']['translation_rmse']:.6f}); ATE after sim(3) alignment "
            f"{g60['no_ba']['ate_rmse']:.6f} ({r60['no_ba']['ate_rmse']:.6f}); "
            f"{g30['windowed_ba']['ate_rmse']:.8f} ({r30['windowed_ba']['ate_rmse']:.8f}); "
            f"{g60['windowed_ba']['ate_rmse']:.6f} ({r60['windowed_ba']['ate_rmse']:.6f}); "
            f"keyframes {g30['keyframes']} and {g60['keyframes']} "
            f"({r30['keyframes']} and {r60['keyframes']}). Tolerance: rtol "
            f"{SLAM_NO_BA_RTOL} without BA, {SLAM_BA_30_ATOL} m with BA over 30 frames; over "
            "60 the sign of BA's move"
        )
        for n in (30, 60):
            check(got[n]["keyframes"] == refs[n]["keyframes"], f"{n} frames: keyframes as in JAX")
        for metric in ("translation_rmse", "ate_rmse"):
            have, want = g60["no_ba"][metric], r60["no_ba"][metric]
            check(abs(have - want) <= SLAM_NO_BA_RTOL * want,
                  f"seed {seed} no BA {metric} {have:.8f} within rtol {SLAM_NO_BA_RTOL} of "
                  f"JAX's {want:.8f}")
            have, want = g30["windowed_ba"][metric], r30["windowed_ba"][metric]
            check(abs(have - want) <= SLAM_BA_30_ATOL,
                  f"seed {seed} 30 frames with BA {metric} {have:.8f} within "
                  f"{SLAM_BA_30_ATOL} m of JAX's {want:.8f}")
            ref_move = r60["windowed_ba"][metric] - r60["no_ba"][metric]
            moved = g60["windowed_ba"][metric] - g60["no_ba"][metric]
            check(moved * ref_move > 0,
                  f"seed {seed}: windowed BA moves the {metric} over 60 frames as in JAX")

    # (c) Serving: 480x640 uint8 frames, bf16 networks, no oracle, a slow
    # sweep; a short warm-up run first.
    frames, K, gt, _ = synthetic_multidepth_sequence(
        SLAM_SERVE_FRAMES, H, W, seed=101, step_translation=0.003, step_rotation=0.0006
    )
    frames = (frames * 255).round().astype(np.uint8)
    gt_wc = np.linalg.inv(np.asarray(gt, np.float64))
    _slam_run(MonoVO(K, networks=nets, image_shape=(H, W)), frames[:8])
    torch.cuda.synchronize()
    log = []
    vo = MonoVO(K, networks=nets, image_shape=(H, W))
    traj, kfs = _slam_run(vo, frames, log=log)
    traj_no_ba, _ = _slam_run(MonoVO(K, networks=nets, image_shape=(H, W)), frames, optimize=False)
    # Frame 0 is left out: its keyframe runs no BA. A non-keyframe right
    # after a keyframe waits for that keyframe's pipelined BA.
    kinds = {"keyframe": [], "non-keyframe": [], "non-keyframe after a keyframe": []}
    for i in range(1, len(log)):
        if log[i][1]:
            kinds["keyframe"].append(log[i][0])
        else:
            kinds["non-keyframe"].append(log[i][0])
            if log[i - 1][1]:
                kinds["non-keyframe after a keyframe"].append(log[i][0])
    alive = [a for _, _, a in log[1:]]
    check(bool(kinds["keyframe"] and kinds["non-keyframe"]),
          "the serving run has keyframes and non-keyframes")
    check(min(alive) >= 24, f"tracks alive on every frame (min {min(alive)})")

    window = vo.mp.keyframes[-vo.mp.num_kf:]
    built = vo.mp._build_problem(K, window, vo.mp.max_points, pad_frames=vo.mp.num_kf)
    check(built is not None, "tracks shared by the last window's keyframes")
    problem = built[0]
    solve_ms, queue_ms = [], []
    for i in range(6):
        torch.cuda.synchronize()
        start = time.perf_counter()
        # The solve must queue without waiting for the card (the pipelined
        # BA overlaps the next frame): any synchronising call raises here.
        torch.cuda.set_sync_debug_mode("error" if i == 0 else "default")
        poses, depths_ba, _ = vo.mp.solve(problem, len(window))
        torch.cuda.set_sync_debug_mode("default")
        queue_ms.append((time.perf_counter() - start) * 1e3)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - start) * 1e3)
    check(bool(torch.isfinite(poses).all() and torch.isfinite(depths_ba).all()), "BA finite")
    # The same for the tracker: pyramid and LK queue without waiting.
    from deep_visual_slam_torch.ops.klt import track_points

    img = vo.nn.to_device(frames[-1])  # an upload from pageable memory waits
    torch.cuda.set_sync_debug_mode("error")
    pyr = vo.klt._pyramid(img)
    track_points(vo.klt._pyr, pyr, vo.klt._uv_dev, vo.klt._alive_dev)
    torch.cuda.set_sync_debug_mode("default")
    med = {k: statistics.median(v) if v else float("nan") for k, v in kinds.items()}
    slam_launches = (k1.launches, k1.backward_launches)
    print(
        f"  (c) 480x640 uint8, bf16 networks, {SLAM_SERVE_FRAMES} frames of a slow sweep "
        "(0.003 m, 0.0006 rad a step), num_kf=7, max_points=256: ms/frame, host clock, "
        f"median: keyframe {med['keyframe']:.2f} (x{len(kinds['keyframe'])}), non-keyframe "
        f"{med['non-keyframe']:.2f} (x{len(kinds['non-keyframe'])}; right after a keyframe "
        f"{med['non-keyframe after a keyframe']:.2f}, "
        f"x{len(kinds['non-keyframe after a keyframe'])}); BA solve "
        f"{statistics.median(solve_ms[1:]):.2f} ms (window of {len(window)}, median of 5 "
        f"after one, synchronised; {statistics.median(queue_ms[1:]):.2f} ms of it to queue, "
        f"no synchronising call in it nor in the tracker's); tracks alive mean {statistics.mean(alive):.1f}, min "
        f"{min(alive)} of 256; {len(kfs)} keyframes; translation RMSE "
        f"{ate_rmse(traj, gt_wc, align=False)[0]:.4f} m with BA, "
        f"{ate_rmse(traj_no_ba, gt_wc, align=False)[0]:.4f} m without (random networks); "
        "K1 launches "
        f"{slam_launches[0]} forward, {slam_launches[1]} backward (the loop runs none); "
        f"phase {time.perf_counter() - start_phase:.1f} s"
    )
    check(slam_launches == (0, 0), "the SLAM loop launches no K1")
    kept["nets"] = nets
    return slam_launches, kept


def _kf_poses(vo):
    """(ids, [n, 4, 4] T_cw) of every keyframe, marginalized ones included."""
    kfs = [f for f in vo.mp.frames if f.anchor is f]
    return [f.id for f in kfs], np.stack([f.pose for f in kfs])


def phase_global_ba(k1, kept, card):
    from deep_visual_slam_torch.ba_ablation import evaluate, run_once
    from deep_visual_slam_torch.profile_slice import device_profile

    print("phase 8: global BA over the whole keyframe history, and the BA ablation")
    k1.launches = k1.backward_launches = 0
    start_phase = time.perf_counter()

    # (a) 96x128 fp32: global BA on phase 7a's runs, the card against the CPU.
    K, vos = kept["small"]
    got = {}
    for device, vo in vos.items():
        ids, before = _kf_poses(vo)
        check(vo.mp.global_bundle_adjustment(K), f"global BA ran ({device})")
        got[device] = (ids, before, _kf_poses(vo)[1], len(ids) - len(vo.mp.keyframes))
    (ids_c, before_c, after_c, marg_c), (ids_g, _, after_g, marg_g) = got["cpu"], got["cuda"]
    err = float(np.abs(after_g - after_c).max())
    moved = float(np.abs(after_c - before_c).max())
    print(f"  (a) 96x128 fp32, phase 7a's 10 frames, num_kf=4: keyframes {ids_g} on the card "
          f"({marg_g} marginalized out of the window), {ids_c} on the CPU ({marg_c}); global BA "
          f"moves them by up to {moved:.2e}; card and CPU within {err:.2e} (tolerance "
          f"{GLOBAL_SMALL_ATOL:.0e})")
    check(ids_g == ids_c and marg_g == marg_c, "global BA keyframes on the card and the CPU")
    check(marg_c >= 1, "keyframes marginalized out of the window")
    check(moved > 10 * GLOBAL_SMALL_ATOL, "global BA moved the keyframes beyond the tolerance")
    check(err <= GLOBAL_SMALL_ATOL, f"global BA poses on the card and the CPU within "
          f"{GLOBAL_SMALL_ATOL}")

    # (b) 480x640: the ablation's windowed_plus_global_ba against JAX's.
    nets = kept["nets"]
    for seed, s in kept["seeds"].items():
        frames, K, gt, (depths, rels) = s["frames"], s["K"], s["gt"], s["oracle"]
        ref = BA_ABLATION_REFERENCE[seed]
        line = []
        for n in (30, 60):
            traj, kf_ids, secs = run_once(lambda: nets, frames[:n], K, True, True,
                                          oracle=(depths[:n], rels[:n]))
            glob = evaluate(traj, gt[:n], kf_ids)
            traj_w, kf_ids_w = s["windowed"][n]
            win = evaluate(traj_w, gt[:n], kf_ids_w)
            want, want_win = ref[n]["windowed_plus_global_ba"], ref[n]["windowed_ba"]
            line.append(
                f"{n} frames: ATE {glob['ate_rmse']:.6f} ({want['ate_rmse']:.6f}), keyframe "
                f"ATE {glob['kf_ate_rmse']:.6f} ({want['kf_ate_rmse']:.6f}) from windowed "
                f"{win['kf_ate_rmse']:.6f} ({want_win['kf_ate_rmse']:.6f}), {secs:.1f} s"
            )
            if n == 30:
                for key in ("ate_rmse", "kf_ate_rmse"):
                    check(abs(glob[key] - want[key]) <= GLOBAL_30_ATOL,
                          f"seed {seed} 30 frames windowed+global {key} {glob[key]:.6f} within "
                          f"{GLOBAL_30_ATOL} m of JAX's {want[key]:.6f}")
            else:
                moved = glob["kf_ate_rmse"] - win["kf_ate_rmse"]
                ref_move = want["kf_ate_rmse"] - want_win["kf_ate_rmse"]
                check(moved * ref_move > 0, f"seed {seed}: global BA moves the keyframe ATE "
                      f"over 60 frames as JAX's does ({moved:+.6f} against {ref_move:+.6f})")
        print(f"  (b) 480x640, seed {seed}, oracle init, windowed+global BA, metres, the card "
              f"(the JAX package): " + "; ".join(line) + f". Tolerance {GLOBAL_30_ATOL} m "
              "over 30 frames; over 60 the sign of global BA's move")

    # (c) One global solve at the 60-keyframe bucket, 480x640.
    vo = kept["seeds"][100]["vo"]
    built = vo.mp.build_global_problem(kept["seeds"][100]["K"])
    check(built is not None, "the 60-frame history shares tracks")
    problem, kfs, points = built
    F, P = problem.poses.shape[0], problem.depths.shape[0]
    check(F == 64, f"60 keyframes pad to the F bucket 64 (got {len(kfs)} in {F})")
    memory = {}
    for label, images in (("fp32", problem.images),
                          ("uint8", (problem.images * 255).round().to(torch.uint8))):
        prob = problem._replace(images=images)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.set_sync_debug_mode("error")
        poses, depths_ba, diag = vo.mp.solve_global(prob, len(kfs))
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        memory[label] = (images.numel() * images.element_size(),
                         torch.cuda.max_memory_allocated() - base)
        check(bool(torch.isfinite(poses).all() and torch.isfinite(depths_ba).all()),
              f"global BA finite ({label})")
        check(float(diag["chi2"]) < float(diag["chi2_history"][0]), f"global BA lowered chi2 "
              f"({label})")
    wall = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        vo.mp.solve_global(problem, len(kfs))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - start) * 1e3)
    prof = device_profile(lambda: vo.mp.solve_global(problem, len(kfs)), reps=3)
    print(
        f"  (c) {card}: one global solve, {len(kfs)} keyframes (F bucket {F}), "
        f"{len(points)} tracks (P bucket {P}, {P * 8} edges), 480x640 fp32 stack, levels "
        f"(2, 1) x 10 iterations: {statistics.median(wall):.2f} ms wall (median of 5, "
        f"synchronised; {min(wall):.2f}-{max(wall):.2f}); under torch.profiler "
        f"{prof['device_ms']:.3f} ms device in {prof['launches']} kernels and copies, busy "
        f"share {prof['device_ms'] / prof['wall_ms']:.1%} (wall {prof['wall_ms']:.2f} ms, 3 "
        f"solves); no synchronising call in the solve (fp32 and uint8 stacks); device memory "
        f"high-water above what was allocated before: "
        + ", ".join(f"{k} {v[1] / 2**30:.3f} GiB (stack {v[0] / 2**30:.3f} GiB)"
                    for k, v in memory.items())
    )
    launches = (k1.launches, k1.backward_launches)
    check(launches == (0, 0), "global BA and the ablation launch no K1")
    print(f"  K1 launches {launches[0]} forward, {launches[1]} backward (the path runs none); "
          f"phase {time.perf_counter() - start_phase:.1f} s")
    return launches


def main() -> int:
    if not (ROOT / "deep_visual_slam_torch" / "csrc" / "reprojection.cu").is_file():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke run needs a "
              "CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from deep_visual_slam_torch.ops.photometric_cuda import reprojection_loss
    from deep_visual_slam_torch.utils.config import load_config

    config = load_config(ROOT / "configs" / "vo.yaml")
    start = time.perf_counter()
    rates, card = phase_card()
    k1_row = phase_k1(rates)
    bwd_row = phase_k1_backward(rates)
    phase_serving(reprojection_loss)
    eval_launches = phase_eval(reprojection_loss, k1_row["ms"], config)
    (train_fwd, train_bwd), (stereo_fwd, stereo_bwd) = phase_train(
        reprojection_loss, k1_row["ms"], bwd_row["ms"], config
    )
    (slam_fwd, slam_bwd), kept = phase_slam(reprojection_loss)
    global_fwd, global_bwd = phase_global_ba(reprojection_loss, kept, card)
    # Each main path ran with the counts set to 0 just before it.
    k1_row["launches"] = eval_launches + train_fwd + stereo_fwd + slam_fwd + global_fwd
    k1_row["launches_by_path"] = {
        "eval": eval_launches, "train": train_fwd, "stereo": stereo_fwd, "slam": slam_fwd,
        "global_ba": global_fwd,
    }
    bwd_row["launches"] = train_bwd + stereo_bwd + slam_bwd + global_bwd
    bwd_row["launches_by_path"] = {
        "eval": 0, "train": train_bwd, "stereo": stereo_bwd, "slam": slam_bwd,
        "global_ba": global_bwd,
    }
    for row in (k1_row, bwd_row):
        check(row["launches"] > 0, f"{row['name']} launched on the main path")
    print(f"total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": [k1_row, bwd_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
