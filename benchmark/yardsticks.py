"""The benchmark's frozen arithmetic: the cards' data-sheet peaks, kernel K1's
bytes and operations from its shapes, the kernel-name groups of the trace,
and a training step's model FLOPs counted on the plain reference networks.
None of it reads the program: a later change to the program cannot move
these numbers.
"""

from __future__ import annotations

from typing import Dict, Optional

from benchmark.reference import nets

# NVIDIA data sheets, dense rates without sparsity, at the card's full power
# limit: memory bytes/s, fp32 FLOP/s outside the tensor cores, bf16 tensor
# FLOP/s. Keyed by a fragment of torch.cuda.get_device_name().
PEAKS = {
    "H100 80GB HBM3": (3.35e12, 67e12, 989e12),
    "H100 SXM": (3.35e12, 67e12, 989e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H200": (4.8e12, 67e12, 989e12),
}


def card_peaks(card: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``card``, or None for a card not listed."""
    for fragment, (bw, fp32, bf16) in PEAKS.items():
        if fragment in card:
            return {"bytes_per_s": bw, "fp32_flops": fp32, "bf16_flops": bf16}
    return None


# K1 forward, fp32 operations: per channel-pixel the 9 taps x 8 of the five
# box sums, then the moments, SSIM, clamp and L1 (33); per pixel the channel
# means and the blend (5). Backward, per channel-pixel: the window sums and
# SSIM again (9 x 8 + 33), the chain rule to the three window coefficients
# (30), the 3x3 gather with multiplicities (9 x 6) and the combination with
# the L1 term (6); per pixel the scaling of the incoming gradient (5).
K1_FWD_OPS_PER_CHANNEL = 9 * 8 + 33
K1_FWD_OPS_PER_PIXEL = 5
K1_BWD_OPS_PER_CHANNEL = 9 * 8 + 33 + 30 + 9 * 6 + 6
K1_BWD_OPS_PER_PIXEL = 5


def k1_forward_work(B: int, H: int, W: int, C: int) -> Dict[str, int]:
    """Bytes (pred and target read once, the [B, H, W, 1] map written once)
    and operations of one K1 forward launch."""
    pixels = B * H * W
    return {"bytes": 2 * pixels * C * 4 + pixels * 4,
            "ops": pixels * (K1_FWD_OPS_PER_CHANNEL * C + K1_FWD_OPS_PER_PIXEL)}


def k1_backward_work(B: int, H: int, W: int, C: int) -> Dict[str, int]:
    """Bytes (pred, target and the gradient read once, dL/dpred written
    once) and operations of one K1 backward launch."""
    pixels = B * H * W
    return {"bytes": 3 * pixels * C * 4 + pixels * 4,
            "ops": pixels * (K1_BWD_OPS_PER_CHANNEL * C + K1_BWD_OPS_PER_PIXEL)}


def least_seconds(work: Dict[str, int], peaks: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the bytes at its
    memory rate and the fp32 operations at its fp32 rate."""
    return max(work["bytes"] / peaks["bytes_per_s"], work["ops"] / peaks["fp32_flops"])


# Kernel-name fragments of the groups whose device time the metrics sum.
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


def group_of(kernel: str) -> Optional[str]:
    """The first group whose fragments the kernel's name holds, or None."""
    for group, fragments in GROUPS.items():
        if any(f in kernel for f in fragments):
            return group
    return None


def train_step_flops(config: Dict, batch: int, height: int, width: int) -> int:
    """Model FLOPs of one training step over ``batch`` rows: 2 per
    multiply-add of every convolution of the forward, times 3 for the
    forward and the backward. The VO step runs DepthNet on the target and
    PoseNet on the two (source, target) pairs of each snippet."""
    flops = nets.forward_flops(nets.depthnet_spec(), nets.depthnet, (batch, height, width, 3))
    if config["networks"] == "depth_pose":
        flops += nets.forward_flops(nets.posenet_spec(), nets.posenet,
                                    (2 * batch, height, width, 6))
    return 3 * flops
