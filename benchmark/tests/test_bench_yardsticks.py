"""The benchmark's frozen arithmetic against hand-worked values."""

import pytest
import torch

from benchmark import yardsticks
from benchmark.reference import nets


def test_k1_forward_work_by_hand():
    # 1x2x2 pixels of 3 channels: pred and target 4*3 floats each read
    # once, the 4-pixel map written once; 4 * (105 * 3 + 5) operations.
    assert yardsticks.k1_forward_work(1, 2, 2, 3) == {"bytes": 112, "ops": 1280}


def test_k1_backward_work_by_hand():
    # pred, target and dL/dpred 4*3 floats each, the gradient 4 floats;
    # per channel-pixel 72 + 33 + 30 + 54 + 6 = 195 operations.
    assert yardsticks.k1_backward_work(1, 2, 2, 3) == {"bytes": 160, "ops": 2360}


def test_least_seconds_takes_the_larger_bound():
    peaks = yardsticks.card_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"bytes_per_s": 3.35e12, "fp32_flops": 67e12, "bf16_flops": 989e12}
    # The step's map: 137.6 MB against 1.57 GFLOP -> bound by bytes.
    work = yardsticks.k1_forward_work(16, 480, 640, 3)
    assert work["bytes"] == 137_625_600
    assert yardsticks.least_seconds(work, peaks) == pytest.approx(137_625_600 / 3.35e12)
    assert yardsticks.least_seconds({"bytes": 1, "ops": 67e12}, peaks) == pytest.approx(1.0)
    assert yardsticks.card_peaks("Tesla T4") is None


@pytest.mark.parametrize("name, group", [
    ("void reprojection_loss_kernel<3>(float const*, ...)", "K1 reprojection_loss_kernel"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "cuDNN convolution"),
    ("void at::native::(anonymous)::multi_tensor_apply_kernel<...>", "Adam (foreach)"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "NCCL"),
    ("void at::native::elementwise_kernel<128, 2>", None),
])
def test_kernel_groups(name, group):
    assert yardsticks.group_of(name) == group


def test_conv_flops_by_hand():
    # [2, 3, 8, 8] through a 3x3, 4-channel convolution with padding 1:
    # 2 x (2 * 4 * 8 * 8) outputs x (3 * 3 * 3) multiply-adds each.
    counter = nets.FlopCounter()
    with torch.device("meta"):
        counter.conv(torch.empty(2, 3, 8, 8), torch.empty(4, 3, 3, 3), None, 1, 1)
    assert counter.flops == 27_648


def test_stem_flops_by_hand():
    # The 7x7 stride-2 stem over [1, 3, 32, 32]: 64 x 16 x 16 outputs of
    # 3 x 49 multiply-adds.
    counter = nets.FlopCounter()
    with torch.device("meta"):
        counter.conv(torch.empty(1, 3, 32, 32), torch.empty(64, 3, 7, 7), None, 2, 3)
    assert counter.flops == 2 * 64 * 16 * 16 * 3 * 49


def _hooked_flops(model, x):
    """2 per multiply-add of every nn.Conv2d the port's module runs."""
    total = [0]

    def hook(m, inputs, out):
        total[0] += 2 * out.numel() * m.in_channels // m.groups * m.kernel_size[0] * \
            m.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return total[0]


def test_reference_count_matches_the_port_modules():
    """The count on the reference networks equals a hook count over the
    port's modules at the same small shape (the benchmark itself never
    counts on the port)."""
    from deep_visual_slam_torch.models import DepthNet, PoseNet

    depth, pose = DepthNet(), PoseNet()
    x = torch.rand(2, 64, 96, 3)
    pair = torch.rand(4, 64, 96, 6)
    assert nets.forward_flops(nets.depthnet_spec(), nets.depthnet, x.shape) == \
        _hooked_flops(depth, x)
    assert nets.forward_flops(nets.posenet_spec(), nets.posenet, pair.shape) == \
        _hooked_flops(pose, pair)
    step = yardsticks.train_step_flops({"networks": "depth_pose"}, 2, 64, 96)
    assert step == 3 * (_hooked_flops(depth, x) + _hooked_flops(pose, pair))
