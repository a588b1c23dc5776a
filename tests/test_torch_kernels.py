"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc`` (a CUDA kernel has no CPU
mode), so they are marked ``cuda`` and skip elsewhere. This file imports
nothing of JAX, so it also runs where JAX is not installed; the repo's
``conftest.py`` does import JAX, hence on such a machine:

    python3 -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -m cuda

K1 and its plain version are both fp32 with the same tap order, so they
agree to a few ulp: atol 1e-5.
"""

import pytest
import torch

from deep_visual_slam_torch.ops import photometric_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernel K1 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 480, 640, 3), (2, 37, 53, 3), "zeros"])
def test_reprojection_kernel_matches_plain_on_card(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    if shape == "zeros":  # the SSIM denominator falls to C1 * C2
        x = torch.zeros((1, 32, 40, 3), device=cuda_device)
        y = x.clone()
    else:
        x = torch.rand(shape, device=cuda_device, generator=g)
        y = torch.rand(shape, device=cuda_device, generator=g)
    launches = photometric_cuda.reprojection_loss.launches
    out = photometric_cuda.reprojection_loss(x, y, 0.85)
    torch.cuda.synchronize()
    assert photometric_cuda.reprojection_loss.launches == launches + 1
    ref = photometric_cuda.reprojection_loss_plain(x, y, 0.85)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_reprojection_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.rand(1, 8, 8, 3, device=cuda_device)
    with pytest.raises(TypeError):
        photometric_cuda.reprojection_loss(x.double(), x.double())
    with pytest.raises(ValueError):  # not contiguous NHWC
        photometric_cuda.reprojection_loss(x.transpose(1, 2), x)
    with pytest.raises(ValueError):  # H = 1: no reflect padding
        photometric_cuda.reprojection_loss(x[:, :1], x[:, :1])
    with pytest.raises(ValueError):  # one input on the CPU
        photometric_cuda.reprojection_loss(x, x.cpu())
    with pytest.raises(NotImplementedError):  # no backward kernel yet
        photometric_cuda.reprojection_loss(x.clone().requires_grad_(), x)
