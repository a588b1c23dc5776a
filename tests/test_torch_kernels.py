"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA device and ``nvcc`` (a CUDA kernel has no CPU
mode), so they are marked ``cuda`` and skip elsewhere. This file imports
nothing of JAX, so it also runs where JAX is not installed; the repo's
``conftest.py`` does import JAX, hence on such a machine:

    python3 -m pytest tests/test_torch_kernels.py --noconftest -o addopts="" -m cuda

K1 and its plain version are both fp32 with the same tap order, so they
agree to a few ulp: atol 1e-5. The shapes put the kernels' 32 x 16 output
tiles against the image's edges: H = 17 and W = 33 leave a tile of one row
and one column, (1, 2, 2, 3) is the smallest image the reflect padding takes,
(1, 3, 5, 3) reaches the 2-pixel halo's clamp, and C = 1 and C = 8 take the
kernels' other channel counts (C = 8 with more than 48 KB of shared memory
in the backward). K1's backward kernel and the plain version's
autograd take their sums in other orders (and the plain one's
reflect-padding backward adds with atomics): atol 2e-5 x the largest
gradient.
"""

import pytest
import torch

from deep_visual_slam_torch.ops import photometric_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (kernel K1 has no CPU mode)")
    return torch.device("cuda")


SHAPES = [(2, 480, 640, 3), (2, 37, 53, 3), (2, 17, 33, 3), (1, 2, 2, 3),
          (1, 3, 5, 3), (2, 37, 53, 1), (1, 19, 35, 8), "zeros"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
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
    wide = torch.rand(1, 8, 8, photometric_cuda.MAX_CHANNELS + 1, device=cuda_device)
    with pytest.raises(ValueError):  # more channels than the tiles hold
        photometric_cuda.reprojection_loss(wide, wide)


@pytest.mark.cuda
def test_reprojection_gradient_comes_from_the_kernel(cuda_device):
    x = torch.rand(1, 8, 8, 3, device=cuda_device, requires_grad=True)
    y = torch.rand(1, 8, 8, 3, device=cuda_device)
    launches = photometric_cuda.reprojection_loss.backward_launches
    photometric_cuda.reprojection_loss(x, y).sum().backward()
    torch.cuda.synchronize()
    assert photometric_cuda.reprojection_loss.backward_launches == launches + 1
    assert x.grad.shape == x.shape and torch.isfinite(x.grad).all()


def _inputs(shape, device):
    g = torch.Generator(device=device).manual_seed(1)
    if shape == "zeros":
        return torch.zeros((1, 32, 40, 3), device=device), torch.zeros(
            (1, 32, 40, 3), device=device
        )
    return (torch.rand(shape, device=device, generator=g),
            torch.rand(shape, device=device, generator=g))


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-5 * b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_reprojection_backward_kernel_matches_plain_on_card(cuda_device, shape):
    x, y = _inputs(shape, cuda_device)
    g = 0.5 + torch.rand(x.shape[:3] + (1,), device=cuda_device)
    grads = []
    for fn in (photometric_cuda.reprojection_loss,
               photometric_cuda.reprojection_loss_plain):
        a, b = x.clone().requires_grad_(), y.clone().requires_grad_()
        launches = photometric_cuda.reprojection_loss.backward_launches
        fn(a, b, 0.85).backward(g)
        torch.cuda.synchronize()
        if fn is photometric_cuda.reprojection_loss:
            assert photometric_cuda.reprojection_loss.backward_launches == launches + 2
        grads.append((a.grad, b.grad))
    _assert_grads_close(*grads)


@pytest.mark.cuda
def test_reprojection_backward_kernel_takes_a_strided_gradient(cuda_device):
    """Two maps concatenated on the last axis, as in the VO loss: each
    map's incoming gradient is a stride-2 slice."""
    a, t = _inputs((2, 48, 64, 3), cuda_device)
    b = torch.rand_like(a)
    w = torch.rand((2, 48, 64, 2), device=cuda_device)
    grads = []
    for fn in (photometric_cuda.reprojection_loss,
               photometric_cuda.reprojection_loss_plain):
        ga, gb = a.clone().requires_grad_(), b.clone().requires_grad_()
        both = torch.cat([fn(ga, t, 0.85), fn(gb, t, 0.85)], dim=-1)
        (both * w).sum().backward()
        grads.append((ga.grad, gb.grad))
    torch.cuda.synchronize()
    _assert_grads_close(*grads)


@pytest.mark.cuda
def test_reprojection_backward_kernel_leaves_a_strided_gradient_uncopied(cuda_device):
    """A stride-2 gradient, as the VO loss hands each map, goes to the kernel
    as it is (pointer and stride, no copy), and the kernel's dL/dpred matches
    the plain version's autograd on it."""
    x, y = _inputs((2, 37, 53, 3), cuda_device)
    both = 0.5 + torch.rand((2, 37, 53, 2), device=cuda_device)
    g = both[..., 1:]
    view, stride = photometric_cuda._grad_view(g, x)
    assert stride == 2 and view.data_ptr() == g.data_ptr()
    got = photometric_cuda.reprojection_loss_backward(x, y, g, 0.85)
    a = x.clone().requires_grad_()
    photometric_cuda.reprojection_loss_plain(a, y, 0.85).backward(g)
    torch.cuda.synchronize()
    _assert_grads_close((got,), (a.grad,))
