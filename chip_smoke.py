"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It needs one CUDA card, ``nvcc`` (on PATH,
under ``$CUDA_HOME`` or ``/usr/local/cuda``) and ``nvidia-smi``; it imports
nothing of JAX. Phases, each printed on lines of its own; any failure ends
the run with a non-zero exit code and no result line:

1. The card: its name and power limit (``nvidia-smi``), the TF32 settings,
   and the build of every kernel from ``deep_visual_slam_torch/csrc``.
2. Kernel K1 (the SSIM+L1 reprojection map) against its plain PyTorch
   version on the card, at the eval step's [16, 480, 640, 3], a ragged
   [2, 37, 53, 3] and an all-zero image (SSIM denominator C1*C2): max abs
   difference, median times and the memory bound.
3. Serving: ``Networks`` at 480x640, B=1, bf16 on 20 synthetic frames
   through ``depth``, ``pose`` and ``step``.
4. Evaluation: the eval step, first at a small size in fp32 against the
   same step on the CPU, then ``make_vo_eval_step`` at the config's
   B=16 x 480x640 in bf16, with K1's launch count per step.

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


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Median of ``reps`` warm runs of ``fn``, each timed by CUDA events."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
    return rates[0]


def phase_k1(rates):
    from deep_visual_slam_torch.ops import photometric_cuda as k1

    print("phase 2: K1 reprojection_loss against its plain version")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = {
        "random [16,480,640,3]": (
            torch.rand((16, 480, 640, 3), device="cuda", generator=g),
            torch.rand((16, 480, 640, 3), device="cuda", generator=g),
        ),
        "ragged [2,37,53,3]": (
            torch.rand((2, 37, 53, 3), device="cuda", generator=g),
            torch.rand((2, 37, 53, 3), device="cuda", generator=g),
        ),
        "zeros [2,48,64,3]": (
            torch.zeros((2, 48, 64, 3), device="cuda"),
            torch.zeros((2, 48, 64, 3), device="cuda"),
        ),
    }
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
    B, H, W, C = pred.shape
    ms = cuda_ms(lambda: k1.reprojection_loss(pred, target, 0.85), 50)
    plain_ms = cuda_ms(lambda: k1.reprojection_loss_plain(pred, target, 0.85), 10)
    nbytes = 2 * pred.numel() * 4 + B * H * W * 4
    ops = B * H * W * (K1_OPS_PER_CHANNEL * C + K1_OPS_PER_PIXEL)
    bytes_ms, ops_ms = nbytes / rates[0] * 1e3, ops / rates[1] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(
        f"  [16,480,640,3]: kernel {ms:.4f} ms (median of 50), plain "
        f"{plain_ms:.4f} ms (median of 10); bound {bound_ms:.4f} ms "
        f"({nbytes / 1e6:.1f} MB at {rates[0] / 1e12:.2f} TB/s; "
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


def phase_serving(k1):
    from deep_visual_slam_torch.data import smooth_texture
    from deep_visual_slam_torch.slam import Networks

    print("phase 3: serving, Networks at 480x640, B=1, bf16, 20 frames")
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


def phase_eval(k1, k1_ms):
    from deep_visual_slam_torch.data import synthetic_vo_batch
    from deep_visual_slam_torch.models import DepthNet, PoseNet
    from deep_visual_slam_torch.training import VOLossConfig, make_vo_eval_step
    from deep_visual_slam_torch.utils.config import load_config

    print("phase 4: evaluation step")
    config = load_config(ROOT / "configs" / "vo.yaml")
    train = config["Train"]
    cfg = VOLossConfig.from_config(config)
    seed = train["seed"]

    def models():
        g = torch.Generator().manual_seed(seed)
        return (
            DepthNet(predict_uncertainty=cfg.uncertainty, generator=g),
            PoseNet(generator=g),
        )

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
    k1.launches = 0
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
    step_ms = statistics.median(times[1:])
    print(
        f"  B={B} {H}x{W} {train['compute_dtype']}: {step_ms:.2f} ms/step "
        f"(median of {n_steps - 1} after a warm step, host clock); loss "
        f"{losses['loss'].item():.5f}; K1 launches {launches} in {n_steps} "
        f"steps = 10 per step; K1 share ~ 10 x {k1_ms:.4f} ms / step = "
        f"{10 * k1_ms / step_ms:.1%}"
    )
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

    start = time.perf_counter()
    rates = phase_card()
    k1_row = phase_k1(rates)
    phase_serving(reprojection_loss)
    k1_row["launches"] = phase_eval(reprojection_loss, k1_row["ms"])
    check(k1_row["launches"] > 0, "K1 launched on the main path")
    print(f"total {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": [k1_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
