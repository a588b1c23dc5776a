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
9. The VO trainer (``training/vo_trainer.py``) at the full width of
   ``configs/vo_fixture_640.yaml`` (ResNet-18 networks, 480x640, B=8, bf16,
   device jitter, uint8 batches), on phase 7b's renders packed as scenes
   (seed 100's 60 frames to train, seed 101's to validate) with the
   synthetic stereo stream interleaved. (a) One epoch (6 mono steps) and
   one validation through ``Trainer.train``: K1 launches per mono, stereo
   and validation step (10 + 8, 5 + 4 and 10), finite losses and
   ``EvalTrajectory`` metrics, checkpoint save ms and bytes, device memory
   high-water. (b) A second run interrupted in its 4th step and a new
   ``Trainer`` on its directory: it resumes at the mid-epoch checkpoint
   (epoch, step in the epoch, update count, learning rate) and runs the
   remaining steps, whose losses must agree with (a)'s within
   ``RESUME_RTOL`` (the card's step is not deterministic). (c) ``Networks.from_checkpoint`` of (a)'s directory
   against (a)'s models on one frame, and ``ba_ablation --vo_ckpt`` over 30
   frames of seed 100. (d) ms per trainer iteration with the loader (an
   epoch of the resumed trainer, CUDA events at each step, no host
   synchronisation), frames/s, and the same step fed from a batch held on
   the card, timed the same way.
10. Supervised depth at the full width of ``configs/depth.yaml`` (ResNet-18
   DepthNet, B=64, 480x640, bf16, AdamW), which launches no kernel of the
   port's own. (a) One ``make_depth_train_step`` step at 2x64x96 in fp32,
   the card against the CPU (losses, the gradient of every parameter, the
   updated weights, phase 6's tolerances). (b) The depth ``Trainer``, cut
   to one epoch, on an in-memory ``DepthSampleDataset`` (192 train and 128
   valid samples over a pool of 16 textured slanted planes, depth in mm):
   3 train steps, a validation of 2 through ``DepthMetrics``, the
   checkpoint; finite losses and metrics, no K1 launch; a second
   ``Trainer`` on the same directory resumes at epoch 2 with the weights
   and optimizer state equal bit for bit. (c) ``eval_depth_cli.evaluate``
   on the checkpoint and the valid loader against ``Trainer.validate``'s
   metrics. (d) ms per train step and per validation step on batches held
   on the card, images/s, device memory high-water.
11. ``export_vo_inference`` at B=1 x 480x640 (uint8 in), the networks in
   fp32 and then in bf16: saved, loaded and run against the eager models
   on the same frames, ms/frame of each; the ResNet-50 DepthNet and
   ``TwoEncoderPoseNet`` on the card against the CPU at 2x64x96 fp32 and one
   480x640 bf16 forward each for its time and memory.
12. RAFT, FlowPoseNet and the Redwood evaluation, fp32 (TF32 off). (a)
   Kernel K2, the on-demand windowed correlation lookup, against its plain
   version and the dense route at SmallRAFT's B=16 [16, 60, 80, 128], r=3,
   BasicRAFT's B=1 D=256, r=4, and a case whose fourth level is 1x1, with
   targets up to 12 px off the grid: max abs difference, ms of K2 (with
   those targets, a smooth flow and zero flow), of the plain version, of
   the dense route and of its lookup alone, the bound; at SmallRAFT's shape
   also fmap1's rows off their 16-byte alignment (the kernel's scalar
   form). (b) SmallRAFT and BasicRAFT (``memory_efficient``) on the card
   against the CPU at 128x160, 3 iterations. (c) SmallRAFT at 480x640, 12
   iterations, B=1 and B=16, and BasicRAFT at B=1, dense and by the card's
   default route (K2): the two routes' final flows, ms per forward, K2
   launches, peak memory. (d) The Redwood
   evaluator over two 480x640 scenes of 40 of phase 7b's frames (served from
   memory, poses as column-major PoseGraphs): ``PoseNet`` with phase 9's
   trained weights through ``eval_redwood_cli.evaluate_redwood``, and
   ``FlowPoseNet`` (SmallRAFT through K2, 12 iterations) through
   ``make_pose_fn`` at B=16: finite results, the CSV's columns, seconds a
   scene and pairs/s; then one 96x128 scene on the card against the CPU,
   and a fault (the weights rounded to bf16) that the comparison must see.

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import shutil
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
# Phase 9b: a resumed trainer's losses against the uninterrupted run's.
# ``torch.use_deterministic_algorithms(True)`` refuses the train step on the
# card (grid_sample's backward has no deterministic CUDA form; the reflection
# padding's backward also adds with atomics), so two runs of the same steps
# differ in the last bits of their gradients, and Adam's first updates,
# ~lr * sign(g), carry a flipped sign of a near-zero gradient into the
# weights. Measured on an H100 (NVIDIA H100 80GB HBM3, 700 W), in two runs:
# the two trainers' first 3 mono and 2 stereo steps 6.16e-3 and 4.39e-3
# apart (relative, per loss), the resumed steps 9.23e-3 and 1.53e-2 from the
# uninterrupted run's. A resume that gets it wrong moves them far more (on
# the CPU at 96x128 in bf16, where a resumed run equals the uninterrupted
# one exactly: a fresh generator state 1.5e-1, a restart of the epoch
# 2.1e-1). The tolerance sits ~3x above the largest reading and ~3x below
# those.
RESUME_RTOL = 5e-2
# Phase 9c: the networks read from the checkpoint against the trainer's own
# models on the same frame, same device and dtype: the same weights through
# the same kernels, so equal (depth rtol, pose atol; measured 0 and 0).
READER_DEPTH_RTOL, READER_POSE_ATOL = 0.0, 0.0
# Phase 10: 3 train steps and 2 validation steps of B=64 over a pool of 16
# distinct samples (seeded). The evaluation CLI's function against
# Trainer.validate's metrics: the same weights through the same network on
# the same batches, so equal up to the order of the float64 sums, 1e-6
# (measured 0 on an NVIDIA H100 80GB HBM3, 700 W, in two runs).
DEPTH_SEED, DEPTH_POOL = 7, 16
DEPTH_CLI_RTOL = 1e-6
# Phase 11: the loaded export against the eager models in the same dtype
# (fp32, then bf16) on the same frames. The exported graph runs the same
# operators, some decomposed (BatchNorm in inference), so it may round
# otherwise: depth within 1e-4 relative, T within 1e-5 (a pose of
# 0.01-scaled outputs); measured 0 and 0 in both dtypes (NVIDIA H100 80GB
# HBM3, 700 W). The ResNet-50 DepthNet and TwoEncoderPoseNet, card against
# CPU in fp32 at 64x96, within the CPU parity tests' 1e-4 against JAX
# (measured 6.0e-7 and 9.3e-10).
EXPORT_SEED = 11
EXPORT_DEPTH_RTOL, EXPORT_T_ATOL = 1e-4, 1e-5
SMALL_NET_ATOL = 1e-4
# Phase 12: kernel K2 against the plain lazy lookup and the dense route, fp32
# both: the kernel dots fmap1 with the integer-grid pixels and blends the
# dots, the plain version blends fmap2 and then dots, in other orders of
# summation: a few ulp of correlations up to ~5 (4.6e-5 measured at D = 128
# on an NVIDIA H100 80GB HBM3, 700 W); a transposed or shifted tap is off by
# O(1).
K2_TOL = 1e-4
# RAFT on the card against the CPU at 128x160 fp32, 3 iterations (TF32 off):
# cuDNN sums the convolutions in other orders; the CPU port is held to JAX
# within 1e-4 px (tests/test_torch_raft.py).
RAFT_CARD_ATOL = 1e-3
# The dense and memory-efficient routes' final flows at 480x640 after 12
# iterations: the lookups differ by rounding and the GRU carries it along;
# the JAX package holds its two routes at 5e-3 px (tests/test_raft.py:89).
RAFT_ROUTE_ATOL = 5e-3
# The Redwood evaluator on one 96x128 scene, the card against the CPU, fp32
# (the card's default lookup, K2, against the CPU's dense one: 1.6e-9 apart
# in the poses on the CPU). The pose networks' relative poses [4, 4] within
# 1e-6: the networks sum their convolutions in other orders, and the
# rotation entries near 1 round to fp32 (6.0e-8 and 8.2e-10 measured in two
# runs on an NVIDIA H100 80GB HBM3, 700 W). The metrics computed from the
# positions (ATE, RPE translation, scales, KITTI translation) within 1e-4
# relative (4.7e-7 in the run that printed them all). The rotation errors
# arccos((tr R - 1) / 2) are held through the poses: near identity their
# slope has no bound, and a change e of the rotation entries moves them by
# up to sqrt(6 e) rad, so they are held to what the pose tolerance allows
# (0.14 deg; 1.4e-3 deg measured). A fault that the comparison must see,
# which the phase runs on the CPU: the network's weights rounded to bf16
# (7.5e-6 and 1.8e-5 in the poses, 4.6e-4 and 3.4e-3 relative in the
# position metrics, with random weights at this size on the CPU).
REDWOOD_POSE_ATOL = 1e-6
REDWOOD_METRIC_RTOL = 1e-4
REDWOOD_ROT_ATOL_DEG = math.degrees(math.sqrt(6 * REDWOOD_POSE_ATOL))
ROTATION_KEYS = ("rpe_rot_mean_deg", "rpe_rot_median_deg", "rpe_rot_std_deg",
                 "kitti_r_rel_deg_per_100m")
REDWOOD_FRAMES = 40


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


def _step_agreement(results):
    """One train step on the CPU and on the card, ``results`` = [(losses,
    weights, grads)] for each: the worst relative loss difference (the
    gradient norm aside), the gradient's difference relative to its 2-norm,
    the worst parameter's relative to its own, the largest difference of an
    updated weight, and the worst BatchNorm statistic as a share of its
    tolerance."""
    (lc, wc, gc), (lg, wg, gg) = results
    worst_loss = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc if k != "grad_norm")
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
    return worst_loss, rel_grad, worst_leaf, worst_w, worst_s


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
    worst_loss, rel_grad, worst_leaf, worst_w, worst_s = _step_agreement(results)
    rel_norm = abs(lg["grad_norm"] - lc["grad_norm"]) / lc["grad_norm"]
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


def _instrument(trainer, k1, log, stop_at=None):
    """Wrap ``trainer``'s steps: each call appends (kind, K1 forward and
    backward launches in it, its losses left on the card, the learning rate
    after it); each mono step first records a CUDA event (``log["marks"]``).
    With ``stop_at`` the mono step of that number raises before it runs."""
    mono, stereo, evaluate = trainer.train_step, trainer.stereo_step, trainer.eval_step

    def wrap(kind, fn):
        def call(*args):
            if kind == "mono":
                if stop_at is not None and sum(r[0] == "mono" for r in log["steps"]) + 1 == stop_at:
                    raise KeyboardInterrupt("phase 9b: interrupted")
                mark = torch.cuda.Event(enable_timing=True)
                mark.record()
                log["marks"].append(mark)
            before = (k1.launches, k1.backward_launches)
            out = fn(*args)
            losses = out[1] if kind == "eval" else out
            log["steps"].append((
                kind, (k1.launches - before[0], k1.backward_launches - before[1]),
                {k: v.detach().clone() for k, v in losses.items()},
                trainer.state.optimizer.param_groups[0]["lr"],
            ))
            return out
        return call

    trainer.train_step = wrap("mono", mono)
    trainer.eval_step = wrap("eval", evaluate)
    if stereo is not None:
        trainer.stereo_step = wrap("stereo", stereo)


def _losses(log, kind):
    return [{k: v.item() for k, v in r[2].items()} for r in log["steps"] if r[0] == kind]


def _max_rel(a, b):
    """The largest relative difference between two lists of loss dicts."""
    return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12) for x, y in zip(a, b) for k in y)


def phase_trainer(k1, kept, card):
    from deep_visual_slam_torch import ba_ablation
    from deep_visual_slam_torch.data.loader import device_prefetch
    from deep_visual_slam_torch.data.packed import pack_scene
    from deep_visual_slam_torch.ops import disp_to_depth, transformation_from_parameters
    from deep_visual_slam_torch.slam import Networks
    from deep_visual_slam_torch.training.vo_trainer import Trainer
    from deep_visual_slam_torch.utils.config import load_config

    print("phase 9: the VO trainer at configs/vo_fixture_640.yaml, its checkpoint, resume "
          "and readers")
    start_phase = time.perf_counter()
    root = ROOT / "build" / "phase9"
    shutil.rmtree(root, ignore_errors=True)
    for fold, seed in (("train", 100), ("valid", 101)):
        s = kept["seeds"][seed]
        pack_scene(str(root / "packed" / fold / f"seed_{seed}"),
                   (np.clip(s["frames"], 0, 1) * 255).astype(np.uint8), s["K"],
                   poses=np.linalg.inv(np.asarray(s["gt"], np.float64)).astype(np.float32))

    def config(run):
        return load_config(ROOT / "configs" / "vo_fixture_640.yaml", overrides={
            "Directory": {"data_dir": f"{root}/data/", "log_dir": f"{root}/{run}/tb",
                          "weights": f"{root}/{run}/weights",
                          "results": f"{root}/{run}/results"},
            "Dataset": {"packed": {"mono": True, "root": str(root / "packed")},
                        "synthetic": {"mono": False, "stereo": True, "length": 16}},
            "Train": {"epoch": 1, "valid_freq": 1, "save_every_steps": 3},
        })

    # (a) One epoch and one validation, the counts set to 0 just before.
    a = Trainer(config("a"))
    t = a.config["Train"]
    B, H, W = t["batch_size"], t["img_h"], t["img_w"]
    check((a.steps_per_epoch, a.total_updates) == (6, 8),
          f"6 mono and 2 stereo updates an epoch (got {a.steps_per_epoch}, {a.total_updates})")
    log_a = {"steps": [], "marks": []}
    _instrument(a, k1, log_a)
    saves, metrics = [], {}
    save, validate = a.ckpt.save, a.validate

    def timed_save(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(*args, **kw)
        saves.append(((time.perf_counter() - t0) * 1e3, Path(path).stat().st_size))
        return path

    a.ckpt.save = timed_save
    a.validate = lambda epoch: metrics.update(validate(epoch)) or metrics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.backward_launches = 0
    t0 = time.perf_counter()
    a.train()
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches = (k1.launches, k1.backward_launches)
    peak = torch.cuda.max_memory_allocated()
    kinds = [r[0] for r in log_a["steps"]]
    check(kinds == ["mono", "stereo"] * 2 + ["mono"] * 4 + ["eval"] * 7,
          f"6 mono steps, a stereo step after each of the first two, 7 validation steps: {kinds}")
    per_kind = {kind: sorted({r[1] for r in log_a["steps"] if r[0] == kind})
                for kind in ("mono", "stereo", "eval")}
    check(per_kind == {"mono": [(10, 8)], "stereo": [(5, 4)], "eval": [(10, 0)]},
          f"K1 launches per mono, stereo and validation step: {per_kind}")
    check(launches == (6 * 10 + 2 * 5 + 7 * 10, 6 * 8 + 2 * 4), f"K1 launches {launches}")
    for r in log_a["steps"]:
        check(all(bool(torch.isfinite(v)) for v in r[2].values()), f"{r[0]} losses finite")
    traj = {k: v for k, v in metrics.items() if k.startswith("valid/") and "loss" not in k}
    check("valid/ate_rmse" in traj and all(np.isfinite(v) for v in traj.values()),
          f"validation EvalTrajectory metrics finite: {traj}")
    mono_a = _losses(log_a, "mono")
    curve = " -> ".join("{:.5f}".format(m["loss"]) for m in mono_a)
    print(
        f"  (a) {card}: B={B} {H}x{W} {t['compute_dtype']}, device jitter, uint8 batches; "
        f"train scene seed 100 (60 frames, 54 snippets), valid scene seed 101 (58), stereo "
        f"stream of 16 pairs; one epoch and one validation in {wall_a:.1f} s (first step "
        f"included); mono loss {curve}; K1 launches "
        f"{launches[0]} forward, {launches[1]} backward = 10 + 8 per mono step (6), 5 + 4 per "
        f"stereo step (2), 10 per validation step (7); validation loss "
        f"{metrics['valid/loss']:.5f}, EvalTrajectory "
        + ", ".join(f"{k[6:]} {v:.6f}" for k, v in sorted(traj.items()))
        + f"; checkpoint saves {', '.join(f'{ms:.1f} ms' for ms, _ in saves)} "
        f"(synchronised), {saves[0][1] / 2**20:.1f} MiB each; device memory high-water "
        f"{peak / 2**30:.2f} GiB"
    )

    # (b) Interrupted in the 4th mono step, then resumed by a new Trainer.
    b = Trainer(config("b"))
    log_b = {"steps": [], "marks": []}
    _instrument(b, k1, log_b, stop_at=4)
    try:
        b.train()
        check(False, "the second run was interrupted")
    except KeyboardInterrupt:
        pass
    c = Trainer(config("b"))
    lr_a = [r[3] for r in log_a["steps"] if r[0] == "mono"]
    resumed = (c.start_epoch, c.resume_step_in_epoch, c.state.step)
    check(resumed == (1, 3, 5), f"resumed at epoch 1, step 3 in it, update 5 (got {resumed})")
    check(c.state.schedule(c.state.step) == lr_a[3],
          "the resumed learning rate is the uninterrupted run's at its 4th step")
    log_c = {"steps": [], "marks": []}
    _instrument(c, k1, log_c)
    c.train()
    kinds = [r[0] for r in log_c["steps"]]
    check(kinds == ["mono"] * 3 + ["eval"] * 7, f"the resumed run's steps: {kinds}")
    spread = _max_rel(_losses(log_b, "mono") + _losses(log_b, "stereo"),
                      mono_a[:3] + _losses(log_a, "stereo"))
    resume_err = _max_rel(_losses(log_c, "mono"), mono_a[3:])
    print(
        f"  (b) interrupted in its 4th mono step; a new Trainer resumed at epoch 1, step 3 "
        f"in it, update {resumed[2]} (lr {lr_a[3]:.6e}), ran the last 3 mono steps: "
        f"losses within {resume_err:.2e} of (a)'s relative (tolerance {RESUME_RTOL:.0e}); the "
        f"two runs' first 3 mono and 2 stereo steps differ by {spread:.2e}"
    )
    check(resume_err <= RESUME_RTOL, f"resumed losses within {RESUME_RTOL} of the "
          "uninterrupted run's")
    check(c.state.step == a.state.step == 8, "both runs ended at update 8")

    # (c) The readers: Networks.from_checkpoint and ba_ablation --vo_ckpt.
    ckpt_dir = a.ckpt.directory
    nets = Networks.from_checkpoint(ckpt_dir)
    check(nets.predict_uncertainty is False, "no uncertainty head in the checkpoint")
    frames = kept["seeds"][100]["frames"]
    prev, cur = ((frames[i] * 255).round().astype(np.uint8) for i in (0, 1))
    depth, T = nets.step(prev, cur)
    a.state.depth_model.eval()
    a.state.pose_model.eval()
    with torch.inference_mode(), torch.autocast(nets.device.type, torch.bfloat16):
        img = [torch.from_numpy(f).to(nets.device)[None].float() / 255.0 for f in (prev, cur)]
        want_depth = disp_to_depth(a.state.depth_model(img[1])[("disp", 0)], 0.1, 10.0)[1]
        aa, tt = a.state.pose_model(torch.cat(img, dim=-1))
    want_T = transformation_from_parameters(aa[:, 0, 0], tt[:, 0, 0])
    want_depth = want_depth[0, ..., 0].float().cpu().numpy()
    want_T = want_T[0].cpu().numpy().astype(np.float64)
    depth_err = float(np.max(np.abs(depth - want_depth) / want_depth))
    pose_err = float(np.abs(T - want_T).max())
    check(depth_err <= READER_DEPTH_RTOL and pose_err <= READER_POSE_ATOL,
          f"Networks.from_checkpoint against the trainer's models: depth {depth_err:.2e}, "
          f"pose {pose_err:.2e}")
    out_json = root / "ablation.json"
    t0 = time.perf_counter()
    ba_ablation.main(["--vo_ckpt", ckpt_dir, "--init", "net", "--frames", "30", "--seeds",
                      "100", "--size", str(H), str(W), "--out_json", str(out_json)])
    record = json.loads(out_json.read_text())
    scene = record["per_scene"]["100"]
    check(record["provenance"]["weights"] == ckpt_dir and record["provenance"]["device"] != "cpu",
          "the ablation ran on the card with the checkpoint's networks")
    check(all(np.isfinite(m["ate_rmse"]) and np.isfinite(m["kf_ate_rmse"])
              for m in scene.values()), "ablation ATEs finite")
    print(
        f"  (c) Networks.from_checkpoint (update {c.state.step}) against the trainer's models "
        f"on seed 100's frames 0-1, bf16: depth within {depth_err:.2e} relative, pose within "
        f"{pose_err:.2e} (tolerance {READER_DEPTH_RTOL}, {READER_POSE_ATOL}); ba_ablation "
        f"--vo_ckpt --init net, 30 frames of seed 100, in {time.perf_counter() - t0:.1f} s: "
        + "; ".join(f"{k} ATE {m['ate_rmse']:.6f} keyframe ATE {m['kf_ate_rmse']:.6f} "
                    f"({m['keyframes']} keyframes)" for k, m in scene.items())
    )

    # (d) The trainer's loop with the loader, timed on the card: an epoch of
    # the resumed trainer, a CUDA event at each mono step and one at its end.
    c.save_every_steps = 0
    log_d = {"steps": [], "marks": []}
    _instrument(c, k1, log_d)
    c.train_epoch(2)
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    marks = log_d["marks"] + [end]
    iters = [m0.elapsed_time(m1) for m0, m1 in zip(marks, marks[1:])]
    mono_only = iters[2:]  # the first two iterations carry a stereo step
    iter_ms = statistics.median(mono_only)
    batch = next(iter(device_prefetch(c.data_loader.train_loader)))
    resident_ms = cuda_ms(lambda: c.train_step(c.state, batch, c.generator), reps=3)
    print(
        f"  (d) {card}: trainer iterations with the loader (CUDA events, one epoch of the "
        f"resumed trainer): {', '.join(f'{x:.2f}' for x in iters)} ms (the first two with "
        f"their stereo step); mono-only median {iter_ms:.2f} ms = {1e3 * B / iter_ms:.1f} "
        f"frames/s; the same step on a batch held on the card {resident_ms:.2f} ms (3 back "
        f"to back between CUDA events, median of 5): the loader's share "
        f"{max(iter_ms - resident_ms, 0.0) / iter_ms:.1%}"
    )
    # Phase 12's Redwood evaluation reads the trained networks back.
    kept["vo_weights"] = {name: {k: v.detach().cpu() for k, v in model.state_dict().items()}
                          for name, model in (("depth", a.state.depth_model),
                                              ("pose", a.state.pose_model))}
    shutil.rmtree(root, ignore_errors=True)
    print(f"  phase {time.perf_counter() - start_phase:.1f} s")
    return launches


def _randomize_bn(model, seed):
    """BatchNorm running statistics of ``model`` drawn from ``seed`` (so that
    eval-mode normalization is not the identity)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_var"):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
            elif k.endswith("running_mean"):
                v.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)))
    return model


def _depth_datasets(height, width, train_n, valid_n):
    """Phase 10's in-memory data: ``train_n`` and ``valid_n`` samples over a
    pool of ``DEPTH_POOL`` textured slanted planes (``smooth_texture`` over
    ``plane_depth`` with a drawn distance and slope, depth in millimetres
    as uint16, as NYU's PNGs hold it), indexed modulo the pool."""
    from deep_visual_slam_torch.data.base import DepthSampleDataset
    from deep_visual_slam_torch.data.synthetic import plane_depth, smooth_texture

    class PoolDepthDataset(DepthSampleDataset):
        def __init__(self, n, is_train, pool):
            super().__init__(n, (height, width), 10.0, is_train, is_train)
            self.pool = pool

        def _load(self, idx):
            return self.pool[idx % len(self.pool)]

    rng = np.random.default_rng(DEPTH_SEED)
    pool = []
    for _ in range(DEPTH_POOL):
        image = smooth_texture(rng, 1, height, width)[0]
        depth = plane_depth(1, height, width, z0=rng.uniform(1.0, 6.0),
                            slope=rng.uniform(-1.0, 1.0))[0]
        pool.append((image, np.round(depth * 1000.0).astype(np.uint16)))
    return PoolDepthDataset(train_n, True, pool), PoolDepthDataset(valid_n, False, pool)


def phase_depth(k1, card):
    from deep_visual_slam_torch.data.loader import collate, device_prefetch
    from deep_visual_slam_torch.data.nyu import DepthLoader
    from deep_visual_slam_torch.eval_depth_cli import evaluate, load_depth_weights
    from deep_visual_slam_torch.training import (
        DepthLossConfig,
        TrainState,
        init_depth_model,
        make_depth_train_step,
    )
    from deep_visual_slam_torch.training.depth_trainer import Trainer
    from deep_visual_slam_torch.utils.config import load_config

    print("phase 10: supervised depth at configs/depth.yaml: the train step, the Trainer, "
          "its checkpoint, resume and evaluation")
    start_phase = time.perf_counter()
    root = ROOT / "build" / "phase10"
    shutil.rmtree(root, ignore_errors=True)

    def config(run):
        return load_config(ROOT / "configs" / "depth.yaml", overrides={
            "Directory": {"log_dir": f"{root}/{run}/tb", "weights": f"{root}/{run}/weights",
                          "results": f"{root}/{run}/results", "data_dir": f"{root}/data"},
            "Train": {"epoch": 1, "valid_freq": 1, "save_freq": 1},
        })

    cfg_a = config("a")
    t = cfg_a["Train"]
    cfg = DepthLossConfig.from_config(cfg_a)

    # (a) Small input, fp32: one step on the card against the CPU.
    small, _ = _depth_datasets(64, 96, 2, 0)
    batch = collate([small.__getitem__(i, np.random.default_rng(i)) for i in range(2)])
    results = []
    for device in ("cpu", "cuda"):
        model = init_depth_model(t["seed"])
        state = TrainState.create(model, None, t["init_lr"], 100, beta1=t["beta1"],
                                  weight_decay=t["weight_decay"])
        losses = make_depth_train_step(model, cfg, torch.float32, device=device)(state, batch)
        results.append(({k: v.item() for k, v in losses.items()},
                        {f"depth.{k}": v for k, v in _weights(model).items()},
                        {f"depth.{k}": p.grad.detach().cpu()
                         for k, p in model.named_parameters()}))
    worst_loss, rel_grad, worst_leaf, worst_w, worst_s = _step_agreement(results)
    print(
        f"  (a) 2x64x96 fp32, card vs CPU, one step (SILog + smoothness, AdamW): losses "
        f"within rtol {worst_loss:.2e} (<= {TRAIN_LOSS_RTOL:.0e}); gradient within "
        f"{rel_grad:.2e} of its 2-norm (<= {TRAIN_GRAD_RTOL:.0e}), worst of "
        f"{len(results[0][2])} parameters within {worst_leaf:.2e} of its own (<= "
        f"{TRAIN_GRAD_LEAF_RTOL:.0e}); updated weights within atol {worst_w:.2e} (<= "
        f"{TRAIN_WEIGHT_ATOL:.1e}); BatchNorm statistics at {worst_s:.2f} of their tolerance"
    )
    check(worst_loss <= TRAIN_LOSS_RTOL, "small depth losses")
    check(rel_grad <= TRAIN_GRAD_RTOL, "small depth gradient")
    check(worst_leaf <= TRAIN_GRAD_LEAF_RTOL, "small depth gradient of each parameter")
    check(worst_w <= TRAIN_WEIGHT_ATOL, "small depth updated weights")
    check(worst_s <= 1.0, "small depth BatchNorm statistics")

    # (b) The Trainer at full width, one epoch of 3 steps and a validation
    # of 2, the counts set to 0 just before.
    B, H, W = t["batch_size"], t["img_h"], t["img_w"]
    t0 = time.perf_counter()
    train_ds, valid_ds = _depth_datasets(H, W, 3 * B, 2 * B)
    loader = DepthLoader(cfg_a, train_ds, valid_ds)
    data_s = time.perf_counter() - t0
    a = Trainer(cfg_a, data_loader=loader)
    check(a.steps_per_epoch == 3, f"3 steps an epoch (got {a.steps_per_epoch})")
    log, metrics, saves = [], {}, []
    train_step, eval_step, validate, save = a.train_step, a.eval_step, a.validate, a.ckpt.save

    def recorded_train(state, batch):
        losses = train_step(state, batch)
        log.append(("train", {k: v.detach().clone() for k, v in losses.items()}))
        return losses

    def recorded_eval(batch):
        losses, depth = eval_step(batch)
        log.append(("eval", {k: v.clone() for k, v in losses.items()}))
        check(depth.shape == (B, H, W, 1), f"validation depth shape {tuple(depth.shape)}")
        return losses, depth

    def timed_save(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save(*args, **kw)
        saves.append(((time.perf_counter() - t0) * 1e3, Path(path).stat().st_size))
        return path

    a.train_step, a.eval_step, a.ckpt.save = recorded_train, recorded_eval, timed_save
    a.validate = lambda epoch: metrics.update(validate(epoch)) or metrics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.backward_launches = 0
    t0 = time.perf_counter()
    a.train()
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches = (k1.launches, k1.backward_launches)
    peak_b = torch.cuda.max_memory_allocated()
    check(launches == (0, 0), f"the depth path launches no K1 (got {launches})")
    check([kind for kind, _ in log] == ["train"] * 3 + ["eval"] * 2,
          f"3 train and 2 validation steps: {[kind for kind, _ in log]}")
    for kind, losses in log:
        check(all(bool(torch.isfinite(v)) for v in losses.values()), f"{kind} losses finite")
    check(len(metrics) == 10 and all(np.isfinite(v) for v in metrics.values()),
          f"validation loss and DepthMetrics finite: {metrics}")
    check(a.ckpt.latest_step() == 3 and len(saves) == 1, "the epoch's checkpoint written")
    curve = " -> ".join(f"{losses['loss'].item():.5f}" for kind, losses in log if kind == "train")
    print(
        f"  (b) {card}: Trainer at B={B} {H}x{W} {t['compute_dtype']} (ResNet-18 DepthNet, "
        f"AdamW lr {t['init_lr']} wd {t['weight_decay']}), {len(train_ds)} train samples (3 "
        f"steps) and {len(valid_ds)} valid (2 steps) over a pool of {DEPTH_POOL} planes "
        f"(made in {data_s:.1f} s); one epoch and a validation in {wall_a:.1f} s (first step "
        f"included); loss {curve}; validation "
        + ", ".join(f"{k[6:]} {v:.5f}" for k, v in metrics.items())
        + f"; checkpoint {saves[0][0]:.1f} ms (synchronised), {saves[0][1] / 2**20:.1f} MiB; "
        f"device memory high-water {peak_b / 2**30:.2f} GiB; K1 launches {launches[0]} "
        f"forward, {launches[1]} backward"
    )

    # The resume: a second Trainer on the same directory.
    resumed = Trainer(cfg_a, data_loader=loader)
    check((resumed.start_epoch, resumed.state.step) == (2, 3),
          f"resumed at epoch 2, update 3 (got {resumed.start_epoch}, {resumed.state.step})")
    want = a.state.depth_model.state_dict()
    diff = [k for k, v in resumed.state.depth_model.state_dict().items()
            if not torch.equal(v, want[k])]
    opt_a = a.state.optimizer.state_dict()
    opt_r = resumed.state.optimizer.state_dict()
    opt_diff = [(i, k) for i, s in opt_a["state"].items() for k, v in s.items()
                if not torch.equal(opt_r["state"][i][k].cpu(), v.cpu())]
    check(not diff and not opt_diff and opt_r["param_groups"] == opt_a["param_groups"],
          f"resumed weights and optimizer state equal bit for bit (differ: {diff[:3]}, "
          f"{opt_diff[:3]})")
    print(f"  resume: a new Trainer on the same directory starts at epoch 2, update 3; its "
          f"{len(want)} weights and statistics and the AdamW state of "
          f"{len(opt_a['state'])} parameters equal the trainer's bit for bit")

    # (c) The evaluation CLI's function on the checkpoint and valid loader.
    model = init_depth_model(0)
    load_depth_weights(model, a.ckpt.directory)
    n, cli = evaluate(model, loader.valid_loader, cfg.min_depth, cfg.max_depth,
                      getattr(torch, t["compute_dtype"]))
    cli_err = max(abs(cli[k] - metrics[f"valid/{k}"]) / max(abs(metrics[f"valid/{k}"]), 1e-12)
                  for k in cli)
    check(n == 2 * B, f"the CLI evaluated {n} samples")
    check(cli_err <= DEPTH_CLI_RTOL, f"eval_depth_cli's metrics against validate's: {cli_err:.2e}")
    print(f"  (c) eval_depth_cli.evaluate on the checkpoint and the valid loader: {n} samples, "
          f"metrics within {cli_err:.2e} of Trainer.validate's relative (tolerance "
          f"{DEPTH_CLI_RTOL:.0e})")

    # (d) The step and the validation step on batches held on the card.
    batch = next(iter(device_prefetch(loader.train_loader)))
    vbatch = next(iter(device_prefetch(loader.valid_loader)))
    a.train_step, a.eval_step = train_step, eval_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a.state.depth_model.train()
    step_ms = cuda_ms(lambda: a.train_step(a.state, batch), reps=3)
    peak_step = torch.cuda.max_memory_allocated()
    a.state.depth_model.eval()
    valid_ms = cuda_ms(lambda: a.eval_step(vbatch), reps=3)
    print(
        f"  (d) {card}: depth train step B={B} {H}x{W} {t['compute_dtype']} on a batch held "
        f"on the card {step_ms:.2f} ms (3 back to back between CUDA events, median of 5) = "
        f"{1e3 * B / step_ms:.1f} images/s; validation step {valid_ms:.2f} ms; device memory "
        f"high-water of the steps {peak_step / 2**30:.2f} GiB"
    )
    shutil.rmtree(root, ignore_errors=True)
    print(f"  phase {time.perf_counter() - start_phase:.1f} s")
    return launches


def phase_export(k1, card):
    from deep_visual_slam_torch.data import synthetic_vo_batch
    from deep_visual_slam_torch.models import DepthNet, TwoEncoderPoseNet
    from deep_visual_slam_torch.training import init_vo_models
    from deep_visual_slam_torch.utils.export import (
        export_vo_inference,
        load_exported,
        make_vo_inference_fn,
    )

    print("phase 11: the VO inference export, the ResNet-50 DepthNet and TwoEncoderPoseNet")
    start_phase = time.perf_counter()
    root = ROOT / "build" / "phase11"
    shutil.rmtree(root, ignore_errors=True)
    H, W = 480, 640
    depth, pose = (_randomize_bn(m, s) for m, s in zip(init_vo_models(EXPORT_SEED), (1, 2)))
    k1.launches = k1.backward_launches = 0
    batch, _ = synthetic_vo_batch(EXPORT_SEED, 1, H, W)
    frame, prev = ((batch[k] * 255).round().to(torch.uint8)
                   for k in ("target_image", "source_left"))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        path = export_vo_inference(depth, pose, str(root / f"vo_{name}.pt2"), (H, W),
                                   batch=1, compute_dtype=dtype)
        export_s = time.perf_counter() - t0
        loaded = load_exported(path)
        eager = make_vo_inference_fn(depth, pose, compute_dtype=dtype)
        with torch.inference_mode():
            got = loaded(frame, prev)
            want = eager(frame, prev)
            check([tuple(x.shape) for x in got] == [(1, H, W), (1, 4, 4), (1, H, W, 1)]
                  and all(x.dtype == torch.float32 for x in got),
                  f"exported outputs {[(tuple(x.shape), x.dtype) for x in got]}")
            depth_err = ((got[0] - want[0]).abs() / want[0]).max().item()
            T_err = (got[1] - want[1]).abs().max().item()
            disp_err = (got[2] - want[2]).abs().max().item()
            loaded_ms = cuda_ms(lambda: loaded(frame, prev), reps=20)
            eager_ms = cuda_ms(lambda: eager(frame, prev), reps=20)
        check(depth_err <= EXPORT_DEPTH_RTOL and T_err <= EXPORT_T_ATOL,
              f"the loaded {name} export against the eager models: depth {depth_err:.2e}, "
              f"T {T_err:.2e}")
        print(
            f"  {card}: export_vo_inference at B=1 {H}x{W} uint8, networks in {name}, in "
            f"{export_s:.1f} s, {Path(path).stat().st_size / 2**20:.1f} MiB; loaded and run "
            f"against the eager models in {name} on the same frames: depth within "
            f"{depth_err:.2e} relative (<= {EXPORT_DEPTH_RTOL:.0e}), T within {T_err:.2e} (<= "
            f"{EXPORT_T_ATOL:.0e}), disparity within {disp_err:.2e}; {loaded_ms:.3f} ms/frame "
            f"loaded against {eager_ms:.3f} eager (20 back to back between CUDA events, "
            f"median of 5)"
        )

    rng = np.random.default_rng(EXPORT_SEED)
    g = torch.Generator().manual_seed(EXPORT_SEED)
    for name, net, channels in (("ResNet-50 DepthNet", DepthNet(50, generator=g), 3),
                                ("TwoEncoderPoseNet", TwoEncoderPoseNet(generator=g), 6)):
        net = _randomize_bn(net, 3).eval()
        x = torch.from_numpy(rng.uniform(size=(2, 64, 96, channels)).astype(np.float32))
        with torch.inference_mode():
            outs = []
            for device in ("cpu", "cuda"):
                out = net.to(device)(x.to(device))
                outs.append([v.cpu() for v in (out.values() if isinstance(out, dict) else out)])
            err = max((a - b).abs().max().item() for a, b in zip(*outs))
            check(err <= SMALL_NET_ATOL, f"{name} card vs CPU: {err:.2e}")
            xb = torch.rand(1, H, W, channels, device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with torch.autocast("cuda", torch.bfloat16):
                ms = cuda_ms(lambda: net(xb), reps=5)
            peak = torch.cuda.max_memory_allocated()
        print(f"  {name}: 2x64x96 fp32 card vs CPU within {err:.2e} (<= {SMALL_NET_ATOL:.0e}); "
              f"B=1 {H}x{W} bf16 forward {ms:.3f} ms (5 back to back, median of 5), device "
              f"memory high-water {peak / 2**30:.2f} GiB")
    launches = (k1.launches, k1.backward_launches)
    check(launches == (0, 0), f"export and networks launch no K1 (got {launches})")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  phase {time.perf_counter() - start_phase:.1f} s")


def _k2_case(B, H, W, D, radius, seed):
    """Kernel K2's inputs at a RAFT shape: fmap1, the 4 pooled fmap2 levels,
    fmap2 and ``coords_grid + U(-12, 12)``, so that taps leave the map."""
    from deep_visual_slam_torch.models.raft import coords_grid
    from deep_visual_slam_torch.ops.correlation import build_corr_pyramid

    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn((B, H, W, D), device="cuda", generator=g)
    f2 = torch.randn((B, H, W, D), device="cuda", generator=g)
    coords = coords_grid(B, H, W, "cuda") + 24 * torch.rand(
        (B, H, W, 2), device="cuda", generator=g) - 12
    return f1, f2, build_corr_pyramid(f1, f2, 4, memory_efficient=True)[2], coords


def k2_work(f1, levels, coords, radius):
    """(bytes, fp32 operations) of the lookup on these inputs: each input
    read once and the output written once; the dots of each window's
    in-range integer-grid pixels (2D each) and 7 a tap for the blend."""
    B, H1, W1, D = f1.shape
    taps = (2 * radius + 1) ** 2
    nbytes = 4 * (f1.numel() + coords.numel() + sum(t.numel() for t in levels)
                  + B * H1 * W1 * len(levels) * taps)
    side = torch.arange(-radius, radius + 2, device=coords.device)
    dots = 0
    for i, level in enumerate(levels):
        hl, wl = level.shape[1:3]
        c = coords / 2**i
        counts = []
        for axis, n in ((0, wl), (1, hl)):
            if n == 1:  # every tap on index 0: in range
                counts.append(torch.full(c.shape[:3], float(side.numel()), device=c.device))
            else:
                idx = torch.floor(c[..., axis]).unsqueeze(-1) + side
                counts.append(((idx >= 0) & (idx < n)).sum(-1).float())
        dots += int((counts[0] * counts[1]).sum().item())
    ops = 2 * D * dots + 7 * B * H1 * W1 * len(levels) * taps
    return nbytes, ops


def _redwood_tree(root, scenes):
    """A Redwood test fold under ``root``: per scene an ``image`` folder of
    empty placeholder files (the frames are served from memory) and the
    camera-to-world poses as a column-major PoseGraph. Returns the
    path -> uint8 frame map for ``read_image``."""
    served = {}
    for name, (frames, gt_cw) in scenes.items():
        scene_dir = root / "test" / name
        (scene_dir / "image").mkdir(parents=True)
        nodes = []
        for i, (frame, T_cw) in enumerate(zip(frames, gt_cw)):
            path = scene_dir / "image" / f"{i:06d}.jpg"
            path.touch()
            served[str(path)] = frame
            T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
            nodes.append({"pose": T_wc.flatten(order="F").tolist()})
        (scene_dir / f"{name}.json").write_text(json.dumps({"nodes": nodes}))

    def read_image(path, height, width):
        frame = served[path]
        check(frame.shape == (height, width, 3) and frame.dtype == np.uint8,
              f"served frame {frame.shape} {frame.dtype}")
        return frame

    return read_image


def _recorded(pose_fn, store):
    """``pose_fn``, keeping each of its outputs in ``store``."""
    def fn(pairs):
        store.append(pose_fn(pairs))
        return store[-1]
    return fn


def _redwood_diffs(got, want, poses_got, poses_want):
    """How two runs of the evaluator (lists of result dicts over the same
    scenes, and their relative poses) differ: the poses' max abs
    difference, (key, value) of the largest relative difference over the
    keys computed from positions, and (key, value) of the largest absolute
    difference over :data:`ROTATION_KEYS`."""
    check([r.keys() for r in got] == [r.keys() for r in want], "the same result keys")
    rel, rot = [], []
    for a, b in zip(got, want):
        for k, v in b.items():
            if k in ROTATION_KEYS:
                rot.append((k, abs(a[k] - v)))
            elif k != "scene":
                rel.append((k, abs(a[k] - v) / max(abs(v), 1e-9)))
    pose = float(np.abs(np.asarray(poses_got) - np.asarray(poses_want)).max())
    return pose, max(rel, key=lambda d: d[1]), max(rot, key=lambda d: d[1])


def _redwood_agree(pose, rel, rot) -> bool:
    return (pose <= REDWOOD_POSE_ATOL and rel[1] <= REDWOOD_METRIC_RTOL
            and rot[1] <= REDWOOD_ROT_ATOL_DEG)


def _describe(pose, rel, rot) -> str:
    return (f"poses within {pose:.2e}, position metrics within {rel[1]:.2e} relative (the "
            f"largest {rel[0]}), rotation errors within {rot[1]:.2e} deg (the largest {rot[0]})")


def phase_raft(k1, rates, card, kept):
    from deep_visual_slam_torch.data import synthetic_multidepth_sequence
    from deep_visual_slam_torch.eval.redwood_eval import (
        CSV_COLUMNS,
        RedwoodEvaluator,
        make_pose_fn,
    )
    from deep_visual_slam_torch.eval_redwood_cli import evaluate_redwood, load_pose_weights
    from deep_visual_slam_torch.models import BasicRAFT, FlowPoseNet, PoseNet, SmallRAFT
    from deep_visual_slam_torch.models.raft import coords_grid
    from deep_visual_slam_torch.ops import correlation
    from deep_visual_slam_torch.ops import correlation_cuda as k2
    from deep_visual_slam_torch.utils.checkpoint import save_params_only

    print("phase 12: RAFT, FlowPoseNet and the Redwood evaluation")
    start_phase = time.perf_counter()
    root = ROOT / "build" / "phase12"
    shutil.rmtree(root, ignore_errors=True)
    lookup = k2.windowed_correlation

    # (a) K2 against the plain lazy lookup and the dense route.
    max_err, row = 0.0, None
    for label, shape in (("SmallRAFT B=16", (16, 60, 80, 128, 3)),
                         ("BasicRAFT B=1", (1, 60, 80, 256, 4)),
                         ("a 1x1 fourth level", (2, 9, 13, 16, 3))):
        B, H1, W1, D, r = shape
        f1, f2, levels, coords = _k2_case(B, H1, W1, D, r, seed=len(label))
        with torch.no_grad():
            out = lookup(f1, levels, coords, r)
            torch.cuda.synchronize()
            plain = correlation.lookup_lazy_plain(f1, levels, coords, r)
            dense = correlation.corr_pyramid_lookup(
                correlation.build_corr_pyramid(f1, f2, 4), coords, r)
        err = (out - plain).abs().max().item()
        err_dense = (out - dense).abs().max().item()
        check(err <= K2_TOL and err_dense <= K2_TOL,
              f"K2 {label}: {err:.2e} from the plain lookup, {err_dense:.2e} from the dense")
        max_err = max(max_err, err, err_dense)
        sizes = ", ".join(f"{t.shape[1]}x{t.shape[2]}" for t in levels)
        msg = (f"  (a) {label} [{B},{H1},{W1},{D}] r={r}, levels {sizes}: max |K2 - plain| "
               f"{err:.3e}, |K2 - dense| {err_dense:.3e} (tolerance {K2_TOL:.0e}; values up "
               f"to {plain.abs().max().item():.2f})")
        if B == 1 or B == 16:
            with torch.no_grad():
                ms = cuda_ms(lambda: lookup(f1, levels, coords, r), 20)
                plain_ms = cuda_ms(
                    lambda: correlation.lookup_lazy_plain(f1, levels, coords, r), 2)
                dense_ms = cuda_ms(lambda: correlation.corr_pyramid_lookup(
                    correlation.build_corr_pyramid(f1, f2, 4), coords, r), 5)
                pyramid = correlation.build_corr_pyramid(f1, f2, 4)
                lookup_ms = cuda_ms(
                    lambda: correlation.corr_pyramid_lookup(pyramid, coords, r), 5)
                del pyramid
                # A smooth flow (one shift for every pixel), as RAFT's
                # targets are, and zero flow: neighbouring windows overlap.
                grid = coords_grid(B, H1, W1, "cuda")
                smooth_ms, zero_ms = (
                    cuda_ms(lambda c=c: lookup(f1, levels, c, r), 20)
                    for c in (grid + torch.tensor([3.3, -2.7], device="cuda"), grid))
            nbytes, ops = k2_work(f1, levels, coords, r)
            bytes_ms, ops_ms = nbytes / rates[0] * 1e3, ops / rates[1] * 1e3
            msg += (f"; {card}: K2 {ms:.4f} ms ({smooth_ms:.4f} ms with a smooth flow, "
                    f"{zero_ms:.4f} ms with zero flow), plain {plain_ms:.4f} ms, dense route "
                    f"(pyramid and lookup) {dense_ms:.4f} ms, its lookup alone {lookup_ms:.4f} "
                    f"ms (20, 2, 5 and 5 calls back to back between CUDA events, median of 5); "
                    f"bound {max(bytes_ms, ops_ms):.4f} ms ({nbytes / 1e6:.1f} MB at "
                    f"{rates[0] / 1e12:.2f} TB/s takes {bytes_ms:.4f}; {ops / 1e9:.3f} GFLOP "
                    f"fp32 {ops_ms:.4f})")
            if B == 16:
                # fmap1's rows one float off their 16-byte alignment: the
                # kernel's scalar form.
                f1_off = torch.empty(f1.numel() + 1, device="cuda")[1:].view(f1.shape)
                f1_off.copy_(f1)
                with torch.no_grad():
                    err_off = (lookup(f1_off, levels, coords, r) - plain).abs().max().item()
                    off_ms = cuda_ms(lambda: lookup(f1_off, levels, coords, r), 20)
                check(err_off <= K2_TOL, f"K2 {label}, unaligned rows: {err_off:.2e}")
                max_err = max(max_err, err_off)
                msg += (f"; fmap1's rows off their 16-byte alignment (the scalar form): "
                        f"max |K2 - plain| {err_off:.3e}, {off_ms:.4f} ms")
                del f1_off
                row = {
                    "name": "windowed_correlation",
                    "route": "cuda",
                    "source": "deep_visual_slam_torch/csrc/correlation.cu",
                    "replaces": "deep_visual_slam_tpu/ops/pallas/correlation.py:111",
                    "launches": None,
                    "max_abs_err": None,
                    "ms": ms,
                    "plain_ms": plain_ms,
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "library_ms": dense_ms,
                }
        print(msg)
        del f1, f2, levels, coords, out, plain, dense
    row["max_abs_err"] = max_err
    torch.cuda.empty_cache()

    gen = np.random.default_rng(12)

    # (b) SmallRAFT and BasicRAFT, the card against the CPU, 128x160 fp32.
    x1, x2 = (torch.from_numpy(gen.uniform(size=(1, 128, 160, 3)).astype(np.float32))
              for _ in range(2))
    for name, make in (("SmallRAFT", SmallRAFT), ("BasicRAFT", BasicRAFT)):
        model = _randomize_bn(make(iters=3, memory_efficient=True,
                                   generator=torch.Generator().manual_seed(1)), 2).eval()
        with torch.no_grad():
            cpu = model(x1, x2)
            gpu = model.to("cuda")(x1.cuda(), x2.cuda())
        err = max((a - b.cpu()).abs().max().item() for a, b in zip(cpu, gpu))
        check(err <= RAFT_CARD_ATOL, f"{name} card against CPU: {err:.2e}")
        print(f"  (b) {name} 1x128x160 fp32, iters=3, memory_efficient: every flow on the card "
              f"within {err:.2e} px of the CPU's (tolerance {RAFT_CARD_ATOL:.0e}; flows up to "
              f"{max(f.abs().max().item() for f in cpu):.2f} px)")

    # (c) RAFT at 480x640, 12 iterations, dense and by the card's default
    # route (K2): the RAFT main path, its counts set to 0 just before it.
    k1.launches = k1.backward_launches = 0
    lookup.launches = 0
    H, W = 480, 640
    frames = kept["seeds"][100]["frames"]
    for name, make, batches in (("SmallRAFT", SmallRAFT, (1, 16)), ("BasicRAFT", BasicRAFT, (1,))):
        dense = _randomize_bn(make(iters=12, memory_efficient=False,
                                   generator=torch.Generator().manual_seed(3)), 4).eval().cuda()
        lazy = make(iters=12).eval().cuda()  # the card's default: K2
        lazy.load_state_dict(dense.state_dict())
        for B in batches:
            a = torch.from_numpy(frames[:B].astype(np.float32)).cuda()
            b = torch.from_numpy(frames[1 : B + 1].astype(np.float32)).cuda()
            flows, stats = {}, []
            for route, model in (("dense", dense), ("memory_efficient", lazy)):
                before = lookup.launches
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                with torch.inference_mode():
                    flows[route] = model(a, b)[-1]
                    ms = cuda_ms(lambda: model(a, b), 2)
                peak = (torch.cuda.max_memory_allocated() - base) / 2**30
                stats.append(f"{route} {ms:.2f} ms/forward ({1e3 * B / ms:.1f} pairs/s), "
                             f"{lookup.launches - before} K2 launches, peak "
                             f"{peak:.2f} GiB above the inputs")
            f_d, f_l = flows["dense"], flows["memory_efficient"]
            check(bool(torch.isfinite(f_d).all()) and f_d.shape == (B, H, W, 2),
                  f"{name} B={B} flows finite, [B, H, W, 2]")
            err = (f_d - f_l).abs().max().item()
            check(err <= RAFT_ROUTE_ATOL, f"{name} B={B}: the two routes within {err:.2e}")
            print(f"  (c) {card}: {name} B={B} {H}x{W} fp32, 12 iterations, on phase 7b's "
                  f"frames: final flows of the two routes within {err:.2e} px (tolerance "
                  f"{RAFT_ROUTE_ATOL:.0e}; flows up to {f_d.abs().max().item():.2f} px); "
                  + "; ".join(stats) + " (2 back to back between CUDA events, median of 5)")
            del a, b, flows, f_d, f_l
        del dense, lazy
        torch.cuda.empty_cache()
    raft_launches = lookup.launches
    check(raft_launches > 0, "K2 launched on the RAFT path")
    check((k1.launches, k1.backward_launches) == (0, 0), "RAFT launches no K1")

    # (d) The Redwood evaluator: PoseNet through the CLI's function, and
    # FlowPoseNet (RAFT through K2, the card's default) through make_pose_fn,
    # over two 480x640 scenes of 40 frames of phase 7b's renders: the
    # Redwood main path, its counts set to 0 just before it.
    k1.launches = k1.backward_launches = 0
    lookup.launches = 0
    scenes = {name: ((np.clip(kept["seeds"][seed]["frames"][:REDWOOD_FRAMES], 0, 1) * 255)
                     .round().astype(np.uint8), kept["seeds"][seed]["gt"][:REDWOOD_FRAMES])
              for name, seed in (("apartment", 100), ("bedroom", 101))}
    read_image = _redwood_tree(root, scenes)
    pose = PoseNet(generator=torch.Generator().manual_seed(0))
    weights = kept.get("vo_weights")
    if weights is not None:  # the pose network phase 9's trainer wrote
        save_params_only(weights, str(root / "vo_weights.pt"))
        load_pose_weights(pose, str(root / "vo_weights.pt"))
    flow_pose = FlowPoseNet(generator=torch.Generator().manual_seed(5))
    timings = []
    for name, net in (("PoseNet", pose), ("FlowPoseNet", flow_pose)):
        out = root / name
        t0 = time.perf_counter()
        if net is pose:
            results = evaluate_redwood(net, str(root), (H, W), str(out), scenes=tuple(scenes),
                                       read_image=read_image)
        else:
            results = RedwoodEvaluator(make_pose_fn(net), str(root), (H, W),
                                       read_image=read_image).evaluate(tuple(scenes), str(out))
        seconds = time.perf_counter() - t0
        pairs = sum(r["num_pairs"] for r in results)
        check(len(results) == 2 and pairs == 2 * (REDWOOD_FRAMES - 1), f"{name}: both scenes")
        check(all(np.isfinite(v) for r in results for k, v in r.items() if k != "scene"),
              f"{name}: every result finite")
        for scene in scenes:
            with open(out / f"{scene}_pairs.csv") as f:
                header = f.readline().strip().split(",")
            check(tuple(header) == CSV_COLUMNS, f"{name} CSV columns {header}")
        timings.append(f"{name} {seconds / 2:.2f} s a scene, {pairs / seconds:.1f} pairs/s")
        print(f"  (d) {card}: {name} over 2 scenes x {REDWOOD_FRAMES} frames at {H}x{W} "
              f"(B=16 chunks): " + "; ".join(
                  f"{r['scene']} ATE {r['ate_rmse']:.4f} m (reference Umeyama "
                  f"{r['ate_rmse_reference_umeyama']:.4f}), RPE {r['rpe_pos_mean']:.4f} m / "
                  f"{r['rpe_rot_mean_deg']:.3f} deg, scale {r['scale_factor']:.3f}"
                  for r in results)
              + f"; {seconds / 2:.2f} s a scene, {pairs / seconds:.1f} pairs/s (host clock, "
              f"frames from memory)")
    redwood_launches = lookup.launches
    check(redwood_launches > 0, "K2 launched on the Redwood path")
    check((k1.launches, k1.backward_launches) == (0, 0), "Redwood launches no K1")

    # One 96x128 scene on the card and on the CPU, both pose networks in fp32.
    small, _, gt, _ = synthetic_multidepth_sequence(10, 96, 128, seed=7)
    small_root = root / "small"
    read_small = _redwood_tree(
        small_root, {"loft": ((np.clip(small, 0, 1) * 255).round().astype(np.uint8), gt)})
    for name, net in (("PoseNet", pose), ("FlowPoseNet", flow_pose)):
        runs, poses = [], []
        for device in ("cuda", "cpu"):
            runs.append(RedwoodEvaluator(_recorded(make_pose_fn(net, device=device), poses),
                                         str(small_root), (96, 128),
                                         read_image=read_small).evaluate(("loft",)))
        faulty = copy.deepcopy(net)  # on the CPU, where the last run left it
        with torch.no_grad():
            for p in faulty.parameters():
                p.copy_(p.bfloat16().float())
        runs.append(RedwoodEvaluator(_recorded(make_pose_fn(faulty, device="cpu"), poses),
                                     str(small_root), (96, 128),
                                     read_image=read_small).evaluate(("loft",)))
        net.to("cuda")
        on_card = _redwood_diffs(runs[0], runs[1], poses[0], poses[1])
        fault = _redwood_diffs(runs[2], runs[1], poses[2], poses[1])
        print(f"  (d) {name}, one 96x128 scene of 10 frames, the card against the CPU: "
              f"{_describe(*on_card)} (tolerances {REDWOOD_POSE_ATOL:.0e}, "
              f"{REDWOOD_METRIC_RTOL:.0e}, {REDWOOD_ROT_ATOL_DEG:.3f} deg); the weights rounded "
              f"to bf16 on the CPU: {_describe(*fault)}")
        check(_redwood_agree(*on_card), f"{name} results, card against CPU")
        check(not _redwood_agree(*fault), f"{name}: the comparison misses a bf16-weight fault")
    shutil.rmtree(root, ignore_errors=True)
    print(f"  K2 launches: RAFT {raft_launches}, Redwood {redwood_launches}; "
          f"phase {time.perf_counter() - start_phase:.1f} s")
    return row, raft_launches, redwood_launches


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
    trainer_fwd, trainer_bwd = phase_trainer(reprojection_loss, kept, card)
    depth_fwd, depth_bwd = phase_depth(reprojection_loss, card)
    phase_export(reprojection_loss, card)
    k2_row, raft_k2, redwood_k2 = phase_raft(reprojection_loss, rates, card, kept)
    # Each main path ran with the counts set to 0 just before it.
    k1_row["launches_by_path"] = {
        "eval": eval_launches, "train": train_fwd, "stereo": stereo_fwd, "slam": slam_fwd,
        "global_ba": global_fwd, "trainer": trainer_fwd, "depth": depth_fwd,
        "raft": 0, "redwood": 0,
    }
    bwd_row["launches_by_path"] = {
        "eval": 0, "train": train_bwd, "stereo": stereo_bwd, "slam": slam_bwd,
        "global_ba": global_bwd, "trainer": trainer_bwd, "depth": depth_bwd,
        "raft": 0, "redwood": 0,
    }
    k2_row["launches_by_path"] = {"raft": raft_k2, "redwood": redwood_k2}
    rows = [k1_row, bwd_row, k2_row]
    for row in rows:
        row["launches"] = sum(row["launches_by_path"].values())
        check(row["launches"] > 0, f"{row['name']} launched on the main path")
    print(f"total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
