"""FP32 instruction counts of kernel K1 from its SASS, and the issue floor
they imply at the train step's [16, 480, 640, 3]; or kernel K2's resources
and its memory, shuffle and tensor-core instructions.

    python3 -m deep_visual_slam_torch.sass_report [--source correlation.cu]

With ``--source correlation.cu`` it builds K2's library and prints, for each
instantiation (the per-pixel ``corr_lookup_kernel`` and the tiled
``corr_lookup_tiled_kernel`` for r = 3, 4 and D = 128, 256), its resources
(``cuobjdump -res-usage``: registers, shared memory, stack) and its
instructions: all of them, FP32, local loads and stores (LDL, STL: spills,
or an array the compiler put on the stack), global loads (LDG), the
asynchronous copies to shared memory (LDGSTS, cp.async), shared-memory
loads and stores (LDS, STS), shuffles (SHFL) and tensor-core products
(HMMA, the m16n8k8 TF32 mma.sync). The rest of this docstring is K1's
report (the default).

Builds ``csrc/reprojection.cu`` as the port builds it, disassembles the
library with ``cuobjdump -sass`` and prints, for each kernel function, its
resources (``cuobjdump -res-usage``: registers, stack and local memory, so
spills show) and, for the C = 3 kernels, its FP32 instructions (FADD, FMUL,
FFMA, FMNMX, FSETP, FSEL, FSET, FCHK; MUFU apart) and all its instructions,
in its body up to its last EXIT (the slow path of an IEEE division, a
subroutine after it, is left out) and between each pair of ``BAR.SYNC``.
The C = 3 kernels' loops are unrolled, so past the first barrier (the tile
fill, whose two versions, inside the image and at its edge, both count
there) the body is straight-line code that every thread issues.

Per channel-pixel: a forward thread computes 4 output pixels x 3 channels,
a backward thread gathers 2 x 3 (and 204 of a block's 256 threads compute
3 x 3 coefficients; the count takes every warp through every section, an
upper estimate by at most one warp in eight of the coefficient sections).
The issue floor is the warp instructions of the launch over what the card
issues: one warp instruction a clock on each of an SM's 4 schedulers, at
the SM's maximum clock (``nvidia-smi``), for the FP32 instructions alone
and for all the instructions past the fill. Needs a CUDA card (for the SM
count and the clock) and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import re
import subprocess
from collections import Counter

import torch

from deep_visual_slam_torch.utils import cuda_build

FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FCHK"}
SHAPE = (16, 480, 640, 3)
TILE = (16, 32)  # rows, columns of a block's output tile (csrc/reprojection.cu)
# name fragment (C = 3 instantiation): (label, warps a block, channel-pixels a thread)
KERNELS = {
    "reprojection_loss_kernelILi3E": ("forward", 4, 4 * 3),
    "reprojection_grad_kernelILi3E": ("backward", 8, 2 * 3),
}
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


def _functions(sass: str) -> dict:
    """Opcode lists by mangled function name."""
    out, name = {}, None
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = head.group(1)
            out[name] = []
            continue
        m = _INSTR.match(line)
        if name and m:
            out[name].append(m.group(1))
    return out


def _count(ops) -> tuple[int, int]:
    base = [op.split(".")[0] for op in ops]
    return sum(b in FP32 for b in base), sum(b == "MUFU" for b in base)


def _report_k2(sass: str) -> None:
    for name, ops in _functions(sass).items():
        base = [op.split(".")[0] for op in ops]
        fp32, _ = _count(ops)
        print(f"K2 {name}: {len(ops)} instructions, FP32 {fp32}, " + ", ".join(
            f"{k} {base.count(k)}" for k in ("LDL", "STL", "LDG", "LDGSTS", "LDS", "STS",
                                             "SHFL", "HMMA")))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--source", choices=("reprojection.cu", "correlation.cu"),
                        default="reprojection.cu", help="the kernel's source in csrc/")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sass_report needs a CUDA card (SM count and clock)")
    cuda_build.build_all([args.source])
    lib = str(cuda_build.library_path(args.source))
    tool = cuda_build.cuda_tool("cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    usage = subprocess.run([tool, "-res-usage", lib], capture_output=True,
                           text=True, check=True).stdout
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    clock_hz = float(smi.split(",")[-1]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{smi} (name, power limit W, max SM clock MHz); {sms} SMs")
    for line in usage.splitlines():
        if "Function" in line or "REG:" in line:
            print("  " + line.strip())
    if args.source == "correlation.cu":
        _report_k2(sass)
        return
    B, H, W, C = SHAPE
    blocks = B * -(-H // TILE[0]) * -(-W // TILE[1])
    functions = _functions(sass)
    for fragment, (label, warps, per_thread) in KERNELS.items():
        names = [n for n in functions if fragment in n]
        if len(names) != 1:
            raise RuntimeError(f"{fragment}: found {names} in the SASS")
        ops = functions[names[0]]
        exits = [i for i, op in enumerate(ops) if op.split(".")[0] == "EXIT"]
        body = ops[: exits[-1] + 1]
        fp32, mufu = _count(body)
        sections, current = [], []  # (all, FP32) instructions between barriers
        for op in body + ["BAR"]:
            if op.startswith("BAR"):
                sections.append((len(current), _count(current)[0]))
                current = []
            else:
                current.append(op)
        past_fill = sum(n for n, _ in sections[1:])
        issue_us = blocks * warps / (4 * sms * clock_hz) * 1e6  # per instruction
        top = Counter(op.split(".")[0] for op in body).most_common(10)
        print(
            f"K1 {label} (C=3): {fp32} FP32 + {mufu} MUFU instructions "
            f"({(fp32 + mufu) / per_thread:.1f} per channel-pixel, issue floor "
            f"{(fp32 + mufu) * issue_us:.1f} us); {len(body)} instructions in the "
            f"body, {past_fill} of them past the tile fill ({past_fill / per_thread:.1f} "
            f"per channel-pixel, issue floor {past_fill * issue_us:.1f} us); "
            f"(all, FP32) by BAR.SYNC section {sections}; at {list(SHAPE)}: "
            f"{blocks} blocks x {warps} warps; most common opcodes {top}"
        )


if __name__ == "__main__":
    main()
