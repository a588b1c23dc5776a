"""Where the device time goes in the slice's two paths, on one CUDA card.

    python3 -m deep_visual_slam_torch.profile_slice

Runs ``make_vo_eval_step`` at the ``configs/vo.yaml`` size (B=16,
480x640, bf16) and ``Networks.step`` at B=1 under ``torch.profiler``, after
warm-up, with random weights from the config's seed. For each path it
prints the wall time per step (host clock, synchronised), the summed
device time of all kernels and its share of the wall time (the busy share;
the rest is the card waiting on the host), and the kernels with the most
device time, in groups and by kernel. Fails if the profiler records no
device time.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from deep_visual_slam_torch.data import smooth_texture, synthetic_vo_batch
from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.slam import Networks
from deep_visual_slam_torch.training import VOLossConfig, make_vo_eval_step
from deep_visual_slam_torch.utils.config import load_config

CONFIG = Path(__file__).resolve().parents[1] / "configs" / "vo.yaml"
# Kernel-name fragments of the groups whose device time is summed.
GROUPS = {
    "K1 reprojection_loss_kernel": ("reprojection_loss_kernel",),
    "cuDNN convolution": ("xmma", "cudnn", "convolve_"),
    "grid_sample": ("grid_sampler",),
    "torch.cat": ("CatArray",),
}


def _profile(label: str, fn, reps: int, top: int = 12) -> None:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6 / reps
    rows = [  # device-side events only: the kernels and memcpys
        (e.self_device_time_total / reps, e.count // reps, e.key)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    device_us = sum(r[0] for r in rows)
    if device_us <= 0:
        raise RuntimeError(f"{label}: the profiler recorded no device time")
    print(
        f"{label}: {wall_us / 1e3:.3f} ms/step wall, {device_us / 1e3:.3f} ms "
        f"device, busy share {device_us / wall_us:.1%} ({reps} steps)"
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
    g = torch.Generator().manual_seed(train["seed"])
    step = make_vo_eval_step(
        DepthNet(predict_uncertainty=cfg.uncertainty, generator=g),
        PoseNet(generator=g), cfg, getattr(torch, train["compute_dtype"]),
    )
    batch, _ = synthetic_vo_batch(
        train["seed"], train["batch_size"], train["img_h"], train["img_w"]
    )
    noise_gen = torch.Generator(device="cuda").manual_seed(train["seed"])
    _profile(
        f"eval step B={train['batch_size']} {train['img_h']}x{train['img_w']} "
        f"{train['compute_dtype']}",
        lambda: step(batch, noise_gen), reps=5,
    )

    frames = smooth_texture(np.random.default_rng(1), 2, train["img_h"], train["img_w"])
    frames = (frames * 255).round().astype(np.uint8)
    nets = Networks(dtype=getattr(torch, train["compute_dtype"]), seed=0)
    _profile("Networks.step B=1", lambda: nets.step(frames[0], frames[1]), reps=20)


if __name__ == "__main__":
    main()
