"""Where the device time goes in the slice's paths, on one CUDA card.

    python3 -m deep_visual_slam_torch.profile_slice

Runs ``make_vo_train_step`` and ``make_vo_eval_step`` at the
``configs/vo.yaml`` size (B=16, 480x640, bf16), ``make_depth_train_step``
at the ``configs/depth.yaml`` size (B=64, 480x640, bf16, a
``synthetic_depth_batch`` held on the card), the trainer's step at the
``configs/vo_fixture_640.yaml`` size (B=8, 480x640, bf16, device jitter,
uint8 batches) fed by its loader from a packed scene (60 frames of a plane
sweep, rendered on the card and packed under ``build/``) and from a batch
held on the card, ``Networks.step`` at B=1 and
the SLAM loop (``MonoVO`` at 480x640 with bf16 networks, ``num_kf=7``,
``max_points=256``, BA levels (2, 1)) under ``torch.profiler``, after
warm-up, with random weights from the config's seed. The SLAM keyframes
are the uint8 frames of a fast ``synthetic_multidepth_sequence`` sweep,
each made a keyframe (with its windowed BA) by a ``min_tracks`` bar above
the track table's size; then the BA solve of the last window alone; then
non-keyframes: the last frame fed again with an identity odometry
(``oracle_rel``), a static camera; then the rest of the sweep as
keyframes and the global BA solve over the whole keyframe history (~60
keyframes, the F bucket 64). Then SmallRAFT's forward at 480x640 in fp32
with 12 iterations on ``smooth_texture`` frames, at B=1 and B=16, by the
dense route and through kernel K2 (``memory_efficient``). Last,
Depth-Anything-V2's forward (``vits`` and ``vitl``, random weights) at B=1
in bf16 at 518x518 and 490x644, and the ``configs/vo.yaml`` train step
under DDP at world size 1 (NCCL, BatchNorm synced) beside the unwrapped
one. Then the ORB path: ``extract_features`` (ORB, 3000 features, 8
levels) of a 480x640 frame, and ``MonoVO(frontend="orb")`` over the fast
sweep's uint8 frames, each frame made a keyframe (with its windowed BA),
then each made a non-keyframe, by the keyframe score computed and its
decision overridden. ``--only`` names the paths to run (``train``,
``eval``, ``depth``, ``trainer``, ``networks``, ``slam``, ``raft``,
``depth_anything``, ``ddp``, ``orb``).

For each path it prints the wall time per step (host clock, synchronised,
over steps run without the profiler, whose tracing slows the host), the
summed device time of all kernels per step and the kernel launches per step
(profiled steps; annotation ranges such as ``Optimizer.step`` are not
kernels and are left out), the busy share (device over wall time; the rest
is the card waiting on the host), and the kernels with the most device
time, in groups and by kernel. Fails if the profiler records no device time.
"""

from __future__ import annotations

import argparse
import shutil
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deep_visual_slam_torch.data import (
    device_prefetch,
    pack_scene,
    smooth_texture,
    synthetic_depth_batch,
    synthetic_multidepth_sequence,
    synthetic_slam_sequence,
    synthetic_vo_batch,
)
from deep_visual_slam_torch.models import SmallRAFT
from deep_visual_slam_torch.slam import MonoVO, Networks
from deep_visual_slam_torch.training import (
    DepthLossConfig,
    TrainState,
    VOLossConfig,
    init_depth_model,
    init_vo_models,
    make_depth_train_step,
    make_vo_eval_step,
    make_vo_train_step,
)
from deep_visual_slam_torch.training.vo_trainer import Trainer
from deep_visual_slam_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs" / "vo.yaml"
FIXTURE = ROOT / "configs" / "vo_fixture_640.yaml"
DEPTH = ROOT / "configs" / "depth.yaml"
# Kernel-name fragments of the groups whose device time is summed.
GROUPS = {
    "K1 reprojection_loss_kernel": ("reprojection_loss_kernel",),
    "K1 reprojection_grad_kernel": ("reprojection_grad_kernel",),
    "K2 corr_lookup kernels": ("corr_lookup_kernel", "corr_lookup_tiled_kernel"),
    "Adam (foreach)": ("multi_tensor_apply",),
    "cuDNN convolution": ("xmma_fprop", "xmma_dgrad", "xmma_wgrad", "cudnn", "convolve_"),
    "grid_sample": ("grid_sampler",),
    "torch.cat": ("CatArray",),
    "index / gather / scatter": ("index", "gather", "scatter"),
    "cuBLAS / cuSOLVER": ("xmma_gemm", "gemv", "potrf", "potrs", "trsm", "cublas", "cusolver",
                          "nvjet", "gemm"),
    "attention (SDPA)": ("flash", "fmha", "attention"),
    "LayerNorm": ("layer_norm",),
    "BatchNorm": ("batch_norm", "bn_fw", "bn_bw"),
    "NCCL": ("nccl",),
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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", choices=sorted(PATHS), default=sorted(PATHS),
                        help="the paths to profile (default: all)")
    args = parser.parse_args(argv)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__)
    for name in PATHS:
        if name in args.only:
            PATHS[name]()


def _vo_setup():
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
    return config, train, cfg, dtype, size, batch, noise_gen


def _profile_train(mesh=None, label="train step") -> None:
    config, train, cfg, dtype, size, batch, noise_gen = _vo_setup()
    depth, pose = init_vo_models(train["seed"], predict_uncertainty=cfg.uncertainty)
    state = TrainState.create(depth, pose, train["init_lr"], total_steps=100)
    train_step = make_vo_train_step(
        depth, pose, cfg, dtype, remat=train.get("remat", False),
        device_augment=train.get("device_augment", False), mesh=mesh,
    )
    _profile(f"{label} {size}", lambda: train_step(state, batch, noise_gen), reps=5)


def _profile_eval() -> None:
    config, train, cfg, dtype, size, batch, noise_gen = _vo_setup()
    step = make_vo_eval_step(
        *init_vo_models(train["seed"], predict_uncertainty=cfg.uncertainty), cfg, dtype
    )
    _profile(f"eval step {size}", lambda: step(batch, noise_gen), reps=5)


def _profile_ddp() -> None:
    """The train step unwrapped, then under DDP at world size 1."""
    import socket

    import torch.distributed as dist

    from deep_visual_slam_torch.parallel import init_distributed, make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    init_distributed(f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        _profile_train()
        _profile_train(make_mesh("cuda"), "train step under DDP (world size 1, NCCL)")
    finally:
        dist.destroy_process_group()


def _profile_networks_and_slam() -> None:
    train = load_config(CONFIG)["Train"]
    frames = smooth_texture(np.random.default_rng(1), 2, train["img_h"], train["img_w"])
    frames = (frames * 255).round().astype(np.uint8)
    nets = Networks(dtype=getattr(torch, train["compute_dtype"]), seed=0)
    _profile("Networks.step B=1", lambda: nets.step(frames[0], frames[1]), reps=20)
    _profile_slam(nets)


def _profile_depth_anything() -> None:
    from deep_visual_slam_torch.models import DepthAnythingV2

    for encoder in ("vits", "vitl"):
        torch.manual_seed(0)
        model = DepthAnythingV2(encoder).eval().cuda()
        for H, W in ((518, 518), (490, 644)):
            x = torch.rand(1, 3, H, W, device="cuda")

            def forward():
                with torch.inference_mode(), torch.autocast("cuda", torch.bfloat16):
                    model(x)

            _profile(f"Depth-Anything-V2 {encoder} B=1 {H}x{W} bf16", forward, reps=10)
        del model


def _profile_raft() -> None:
    frames = torch.from_numpy(np.ascontiguousarray(
        smooth_texture(np.random.default_rng(3), 17, 480, 640), dtype=np.float32)).cuda()
    for memory_efficient in (False, True):
        model = SmallRAFT(memory_efficient=memory_efficient,
                          generator=torch.Generator().manual_seed(0)).eval().cuda()
        for B in (1, 16):
            a, b = frames[:B], frames[1 : B + 1]
            with torch.inference_mode():
                _profile(f"SmallRAFT forward B={B} 480x640 fp32, 12 iterations, "
                         f"{'memory-efficient (K2)' if memory_efficient else 'dense'}",
                         lambda: model(a, b), reps=3)


def _profile_depth() -> None:
    config = load_config(DEPTH)
    t = config["Train"]
    model = init_depth_model(t["seed"])
    state = TrainState.create(model, None, t["init_lr"], total_steps=100, beta1=t["beta1"],
                              weight_decay=t["weight_decay"])
    step = make_depth_train_step(model, DepthLossConfig.from_config(config),
                                 getattr(torch, t["compute_dtype"]))
    batch = synthetic_depth_batch(t["seed"], t["batch_size"], t["img_h"], t["img_w"],
                                  t["max_depth"])
    _profile(f"depth train step B={t['batch_size']} {t['img_h']}x{t['img_w']} "
             f"{t['compute_dtype']} (configs/depth.yaml)", lambda: step(state, batch), reps=5)


def _profile_trainer() -> None:
    root = ROOT / "build" / "profile_trainer"
    shutil.rmtree(root, ignore_errors=True)
    config = load_config(FIXTURE, overrides={
        "Directory": {"data_dir": f"{root}/data/", "log_dir": f"{root}/tb",
                      "weights": f"{root}/weights", "results": f"{root}/results"},
        "Dataset": {"packed": {"mono": True, "root": f"{root}/packed"}},
    })
    t = config["Train"]
    frames, K, gt = synthetic_slam_sequence(
        60, t["img_h"], t["img_w"], seed=1000, step_translation=0.02, step_rotation=0.004
    )
    pack_scene(f"{root}/packed/train/scene_000", (frames * 255).round().astype(np.uint8), K,
               poses=np.linalg.inv(gt.astype(np.float64)).astype(np.float32))
    trainer = Trainer(config)

    def epochs():
        while True:
            yield from trainer.data_loader.train_loader

    batches = device_prefetch(epochs())
    step, state, gen = trainer.train_step, trainer.state, trainer.generator
    size = (f"B={t['batch_size']} {t['img_h']}x{t['img_w']} {t['compute_dtype']}, "
            f"device jitter, uint8 batches")
    _profile(f"trainer step with its loader (packed scene, {t['num_workers']} threads) {size}",
             lambda: step(state, next(batches), gen), reps=5)
    batch = next(batches)
    _profile(f"trainer step on a batch held on the card {size}",
             lambda: step(state, batch, gen), reps=5)
    shutil.rmtree(root)


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


def _profile_orb() -> None:
    from deep_visual_slam_torch.slam.frontend import extract_features

    train = load_config(CONFIG)["Train"]
    H, W = 480, 640
    frames, K, _, _ = synthetic_multidepth_sequence(
        16, H, W, seed=100, step_translation=0.02, step_rotation=0.004
    )
    frames = (frames * 255).round().astype(np.uint8)
    _profile(f"ORB extract_features {H}x{W} uint8 (upload, gray, ORB, copy back)",
             lambda: extract_features(frames[0]), reps=10)
    nets = Networks(dtype=getattr(torch, train["compute_dtype"]), seed=0)
    vo = MonoVO(K, networks=nets, frontend="orb")
    size = f"{H}x{W} uint8, bf16 networks, num_kf=7, max_points=256"
    feed = iter(frames[i % len(frames)] for i in range(10 ** 6))
    for _ in range(4):
        vo.process_frame(next(feed))
    score = vo.mp.check_key_frame
    decision = {"keyframe": True}

    def forced(frame, match_from_prev=None):
        score(frame, match_from_prev)
        return decision["keyframe"]

    vo.mp.check_key_frame = forced

    def step(want_keyframe):
        def run():
            n = vo.n_keyframes
            vo.process_frame(next(feed))
            if (vo.n_keyframes > n) != want_keyframe:
                raise RuntimeError("the keyframe decision was not the forced one")
        return run

    _profile(f"ORB SLAM keyframe {size}", step(True), reps=10)
    decision["keyframe"] = False
    _profile(f"ORB SLAM non-keyframe {size}", step(False), reps=10)


PATHS = {
    "train": _profile_train,
    "eval": _profile_eval,
    "depth": _profile_depth,
    "trainer": _profile_trainer,
    "networks": _profile_networks_and_slam,
    "raft": _profile_raft,
    "depth_anything": _profile_depth_anything,
    "ddp": _profile_ddp,
    "orb": _profile_orb,
}


if __name__ == "__main__":
    main()
