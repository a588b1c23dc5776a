"""Where kernel K2's time goes: the committed kernel against copies of it with
one part taken out, timed on the same inputs on the card.

    python3 scripts/k2_ablation.py

Run it from the root of a checkout on a machine with a CUDA card and nvcc.
It builds ``deep_visual_slam_torch/csrc/correlation.cu`` and four variants
of it into ``build/k2_ablation/`` (one nvcc each, all started together),
each a text patch of the committed source that fails loudly when the source
no longer holds the patched lines:

- ``no products``: the tiled form's three tensor-core products a pair of
  tiles replaced by one add of their fragments, so that the loads and the
  splits stay;
- ``one product``: head x head only (plain TF32 rounding: its error shows);
- ``no staging``: the stage loop skipped (prologue, product store and blend
  only);
- ``per-pixel``: every tile takes the per-pixel form (the tiled form's gain).

Each runs at SmallRAFT's B=16 lookup (fmap1 [16, 60, 80, 128] fp32, 4
pooled levels, r = 3) on zero flow, a smooth flow (one shift) and +-12 px
random targets: max |out - plain lookup| and ms a call (20 launches back to
back between CUDA events, median of 5, after 3 warm calls). The card's name
and power limit come first. The variants' outputs are wrong by design
except the committed kernel's and ``per-pixel``'s.
"""

from __future__ import annotations

import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from deep_visual_slam_torch.models.raft import coords_grid  # noqa: E402
from deep_visual_slam_torch.ops import correlation  # noqa: E402
from deep_visual_slam_torch.utils import cuda_build  # noqa: E402

SOURCE = ROOT / "deep_visual_slam_torch" / "csrc" / "correlation.cu"
OUT = ROOT / "build" / "k2_ablation"
PRODUCTS = """#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          if (mine >> (mm * kNT) & 1) mma_tf32(acc[mm][j], alo[mm], bhi);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          if (mine >> (mm * kNT) & 1) mma_tf32(acc[mm][j], ahi[mm], blo);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          if (mine >> (mm * kNT) & 1) mma_tf32(acc[mm][j], ahi[mm], bhi);"""
VARIANTS = {
    "committed": [],
    "no products": [(PRODUCTS, """#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          if (mine >> (mm * kNT) & 1)
            acc[mm][j][0] += __uint_as_float((alo[mm][0] ^ ahi[mm][1] ^ alo[mm][2] ^
                                              ahi[mm][3]) + (bhi[0] ^ blo[1]));""")],
    "one product": [(PRODUCTS, """#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          if (mine >> (mm * kNT) & 1) mma_tf32(acc[mm][j], ahi[mm], bhi);""")],
    "no staging": [("""  load_chunk(0, smem);
  for (int ch = 0; ch < kChunks; ++ch) {""", """  for (int ch = 0; ch < 0; ++ch) {""")],
    "per-pixel": [("  if (bw > kMaxU || bh > kMaxU || bw * bh > kMaxU) {", "  if (true) {")],
}


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    source = SOURCE.read_text()
    procs = []
    for name, patches in VARIANTS.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: the patched lines are not in {SOURCE}")
            text = text.replace(old, new)
        stem = name.replace(" ", "_").replace("-", "_")
        src, lib = OUT / f"{stem}.cu", OUT / f"{stem}.so"
        src.write_text(text)
        cmd = [cuda_build.cuda_tool("nvcc"), *cuda_build.COMMON_FLAGS, "-o", str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    entries = {}
    for name, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(lib)).corr_lookup_forward
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def lookup(fn, f1, levels, coords, radius) -> torch.Tensor:
    B, H1, W1, D = f1.shape
    L = len(levels)
    out = torch.empty((B, H1, W1, L * (2 * radius + 1) ** 2), device=f1.device)
    ptrs = (ctypes.c_longlong * L)(*[t.data_ptr() for t in levels])
    hw = (ctypes.c_int * (2 * L))(*[n for t in levels for n in t.shape[1:3]])
    err = fn(f1.data_ptr(), coords.data_ptr(), out.data_ptr(), ctypes.addressof(ptrs),
             ctypes.addressof(hw), L, B, H1, W1, D, radius, 1.0 / math.sqrt(D),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ablation needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    entries = build()
    B, H, W, D, r = 16, 60, 80, 128, 3
    g = torch.Generator(device="cuda").manual_seed(0)
    f1 = torch.randn((B, H, W, D), device="cuda", generator=g)
    f2 = torch.randn((B, H, W, D), device="cuda", generator=g)
    levels = correlation.build_corr_pyramid(f1, f2, 4, memory_efficient=True)[2]
    grid = coords_grid(B, H, W, "cuda")
    inputs = {
        "zero flow": grid,
        "smooth flow": grid + torch.tensor([3.3, -2.7], device="cuda"),
        "random targets": grid + 24 * torch.rand((B, H, W, 2), device="cuda", generator=g) - 12,
    }
    with torch.no_grad():
        plain = {k: correlation.lookup_lazy_plain(f1, levels, c, r) for k, c in inputs.items()}
        for name, fn in entries.items():
            cells = []
            for k, c in inputs.items():
                err = (lookup(fn, f1, levels, c, r) - plain[k]).abs().max().item()
                ms = cuda_ms(lambda fn=fn, c=c: lookup(fn, f1, levels, c, r))
                cells.append(f"{k} {ms:.4f} ms (max err {err:.1e})")
            print(f"{name}: " + "; ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
