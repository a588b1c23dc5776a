"""Where the device time goes in the slice's paths, on one CUDA card.

    python3 -m deep_visual_slam_torch.profile_slice

Runs ``make_vo_train_step`` and ``make_vo_eval_step`` at the
``configs/vo.yaml`` size (B=16, 480x640, bf16), ``Networks.step`` at B=1 and
the SLAM loop (``MonoVO`` at 480x640 with bf16 networks, ``num_kf=7``,
``max_points=256``, BA levels (2, 1)) under ``torch.profiler``, after
warm-up, with random weights from the config's seed. The SLAM keyframes
are the uint8 frames of a fast ``synthetic_multidepth_sequence`` sweep,
each made a keyframe (with its windowed BA) by a ``min_tracks`` bar above
the track table's size; then the BA solve of the last window alone; then
non-keyframes: the last frame fed again with an identity odometry
(``oracle_rel``), a static camera; then the rest of the sweep as
keyframes and the global BA solve over the whole keyframe history (~60
keyframes, the F bucket 64).

For each path it prints the wall time per step (host clock, synchronised,
over steps run without the profiler, whose tracing slows the host), the
summed device time of all kernels per step and the kernel launches per step
(profiled steps; annotation ranges such as ``Optimizer.step`` are not
kernels and are left out), the busy share (device over wall time; the rest
is the card waiting on the host), and the kernels with the most device
time, in groups and by kernel. Fails if the profiler records no device time.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deep_visual_slam_torch.data import (
    smooth_texture,
    synthetic_multidepth_sequence,
    synthetic_vo_batch,
)
from deep_visual_slam_torch.slam import MonoVO, Networks
from deep_visual_slam_torch.training import (
    TrainState,
    VOLossConfig,
    init_vo_models,
    make_vo_eval_step,
    make_vo_train_step,
)
from deep_visual_slam_torch.utils.config import load_config

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "vo.yaml"
# Kernel-name fragments of the groups whose device time is summed.
GROUPS = {
    "K1 reprojection_loss_kernel": ("reprojection_loss_kernel",),
    "K1 reprojection_grad_kernel": ("reprojection_grad_kernel",),
    "Adam (foreach)": ("multi_tensor_apply",),
    "cuDNN convolution": ("xmma_fprop", "xmma_dgrad", "xmma_wgrad", "cudnn", "convolve_"),
    "grid_sample": ("grid_sampler",),
    "torch.cat": ("CatArray",),
    "index / gather / scatter": ("index", "gather", "scatter"),
    "cuBLAS / cuSOLVER": ("xmma_gemm", "gemv", "potrf", "potrs", "trsm", "cublas", "cusolver"),
}


def device_profile(fn, reps: int) -> dict:
    """Two warm calls of ``fn``, then ``reps`` calls timed on the host clock
    and ``reps`` more under ``torch.profiler``, each group ended by a
    synchronise. Returns the per-call ``wall_ms``, ``profiled_ms`` (wall
    under the profiler), ``device_ms`` (the summed time of the kernels and
    copies), ``launches`` and ``rows`` ((device us, count, name) per
    kernel, per call); raises if the profiler recorded no device time."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - start) * 1e6 / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        profiled_us = (time.perf_counter() - start) * 1e6 / reps
    rows = [  # device-side events only: the kernels and memcpys
        (e.self_device_time_total / reps, e.count // reps, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation
    ]
    device_us = sum(r[0] for r in rows)
    if device_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return {
        "wall_ms": wall_us / 1e3, "profiled_ms": profiled_us / 1e3,
        "device_ms": device_us / 1e3, "launches": sum(r[1] for r in rows), "rows": rows,
    }


def _profile(label: str, fn, reps: int, top: int = 12) -> None:
    p = device_profile(fn, reps)
    rows, device_us = p["rows"], p["device_ms"] * 1e3
    print(
        f"{label}: {p['wall_ms']:.3f} ms/step wall ({p['profiled_ms']:.3f} "
        f"under the profiler), {p['device_ms']:.3f} ms device in {p['launches']} "
        f"kernels and copies, busy share {p['device_ms'] / p['wall_ms']:.1%} ({reps} steps each)"
    )
    for group, keys in GROUPS.items():
        us = sum(r[0] for r in rows if any(k in r[2] for k in keys))
        print(f"  {group}: {us / 1e3:.3f} ms, {us / device_us:.1%} of device time")
    for us, count, name in sorted(rows, reverse=True)[:top]:
        print(f"  {us / 1e3:8.3f} ms {us / device_us:6.1%} x{count:<4d} {name[:90]}")


def main() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__)
    config = load_config(CONFIG)
    train = config["Train"]
    cfg = VOLossConfig.from_config(config)
    dtype = getattr(torch, train["compute_dtype"])
    size = (f"B={train['batch_size']} {train['img_h']}x{train['img_w']} "
            f"{train['compute_dtype']}")
    batch, _ = synthetic_vo_batch(
        train["seed"], train["batch_size"], train["img_h"], train["img_w"]
    )
    noise_gen = torch.Generator(device="cuda").manual_seed(train["seed"])

    depth, pose = init_vo_models(train["seed"], predict_uncertainty=cfg.uncertainty)
    state = TrainState.create(depth, pose, train["init_lr"], total_steps=100)
    train_step = make_vo_train_step(
        depth, pose, cfg, dtype, remat=train.get("remat", False),
        device_augment=train.get("device_augment", False),
    )
    _profile(f"train step {size}", lambda: train_step(state, batch, noise_gen), reps=5)

    step = make_vo_eval_step(
        *init_vo_models(train["seed"], predict_uncertainty=cfg.uncertainty), cfg, dtype
    )
    _profile(f"eval step {size}", lambda: step(batch, noise_gen), reps=5)

    frames = smooth_texture(np.random.default_rng(1), 2, train["img_h"], train["img_w"])
    frames = (frames * 255).round().astype(np.uint8)
    nets = Networks(dtype=getattr(torch, train["compute_dtype"]), seed=0)
    _profile("Networks.step B=1", lambda: nets.step(frames[0], frames[1]), reps=20)
    _profile_slam(nets)


def _profile_slam(nets: Networks) -> None:
    H, W = 480, 640
    # A fast sweep (0.02 m, 0.004 rad a step).
    frames, K, _, _ = synthetic_multidepth_sequence(
        64, H, W, seed=100, step_translation=0.02, step_rotation=0.004
    )
    frames = (frames * 255).round().astype(np.uint8)
    sweep, rest = frames[:26], frames[26:]
    vo = MonoVO(K, networks=nets)
    for frame in sweep[:4]:
        vo.process_frame(frame)
    size = "480x640 uint8, bf16 networks, num_kf=7, max_points=256"
    queue = iter(sweep[4:])

    def keyframe():
        n = vo.n_keyframes
        vo.process_frame(next(queue))
        if vo.n_keyframes == n:
            raise RuntimeError("a frame of the fast sweep was not a keyframe")

    # Fewer live tracks than min_tracks forces a keyframe: with the bar
    # above the table's size every frame is one, whatever its score.
    min_tracks, vo.klt.min_tracks = vo.klt.min_tracks, vo.klt.P + 1
    _profile(f"SLAM keyframe {size}", keyframe, reps=10)
    vo.klt.min_tracks = min_tracks
    window = vo.mp.keyframes[-vo.mp.num_kf:]
    built = vo.mp._build_problem(K, window, vo.mp.max_points, pad_frames=vo.mp.num_kf)
    if built is None:
        raise RuntimeError("the last window's keyframes share no track")
    _profile(f"BA solve, window of {len(window)}, levels (2, 1) x 6 iterations",
             lambda: vo.mp.solve(built[0], len(window)), reps=10)

    # The last frame again with an identity odometry: a static camera, no
    # keyframe.
    still = np.eye(4)

    def non_keyframe():
        n = vo.n_keyframes
        vo.process_frame(sweep[-1], oracle_rel=still)
        if vo.n_keyframes != n:
            raise RuntimeError("a static frame became a keyframe")

    _profile(f"SLAM non-keyframe {size}", non_keyframe, reps=20)

    # The rest of the sweep as keyframes, then global BA over all of them.
    vo.klt.min_tracks = vo.klt.P + 1
    for frame in rest:
        vo.process_frame(frame)
    built = vo.mp.build_global_problem(K)
    if built is None:
        raise RuntimeError("the keyframe history shares no track")
    problem, kfs, points = built
    F, P = problem.poses.shape[0], problem.depths.shape[0]
    _profile(f"global BA solve, {len(kfs)} keyframes (F bucket {F}), {len(points)} tracks "
             f"(P bucket {P}), uint8 stack, levels (2, 1) x 10 iterations",
             lambda: vo.mp.solve_global(problem, len(kfs)), reps=5)


if __name__ == "__main__":
    main()
