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

K2 (the windowed correlation lookup) against the plain lazy lookup, at
SmallRAFT's and BasicRAFT's shapes at 480x640 and at small shapes whose
fourth level is 1x1, with targets up to 12 pixels off the grid, smooth
targets (the tiled form's staged boxes, also past the map's edges) and both
in one launch: atol 1e-4 on correlations up to ~5 (the kernel dots before it
blends and sums in another order; 4.6e-5 measured at D = 128 in the
per-pixel form).

K3 (the decoder's padded conv inputs) against its plain version at the
11 launches of a DepthNet forward at 480x640, at the depth cell's B = 64 and
the VO cell's B = 16, and at 96x128, and at small edge shapes, in bf16 and
fp32, with channels-last encoder features as the encoder gives them. Copied elements (the padding, the upsample, the
skip, the unactivated feature) are exactly equal; the ELU's within one ulp
of the working type. The gradients are held to the plain version's in
float64: the kernel rounds once (half an ulp, 2^-8 of the value in bf16)
and reads the ELU's derivative back from P rounded to the working type
(an ulp of 1: 2^-8 times the gathered sum in bf16), and sums up to nine
terms in fp32 (1e-6 of the largest sum).

Depth-Anything-V2 (vits, 56x84), the ORB matcher and ORB itself run no
kernel of the port's own; their card checks sit here because this file
needs no JAX (nor cv2).
The model in fp32 on the card (TF32 off) against the CPU within
``DA_CARD_ATOL`` m, and
bf16 under autocast against the card's fp32 by relative error; the
matcher's lists on the card equal the CPU's; ORB's keypoints, angles,
responses and descriptors on the card equal the CPU's bit for bit (integer
and IEEE elementwise arithmetic only, see ``ops/orb.py``).
"""

import pytest
import torch

from deep_visual_slam_torch.ops import correlation, correlation_cuda, photometric_cuda
from deep_visual_slam_torch.ops.decoder_pad_cuda import decoder_pad, decoder_pad_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (a CUDA kernel has no CPU mode)")
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


# (B, H1, W1, D, radius) and the targets. The tiled form takes D = 128 and
# 256: "smooth" (one shift) and "edges" (a smooth flow out of the centre,
# past every edge) stage every tile's union box, "random" (+-12 px) runs
# the fine levels' tiles in the per-pixel form, "mixed" alternates the two
# tile by tile in one launch; D = 16 and 32 take the per-pixel form alone.
K2_SHAPES = [((16, 60, 80, 128, 3), "random"), ((1, 60, 80, 256, 4), "random"),
             ((2, 9, 13, 16, 3), "random"), ((2, 8, 12, 32, 4), "random"),
             ((16, 60, 80, 128, 3), "mixed"), ((16, 60, 80, 128, 3), "edges"),
             ((1, 60, 80, 256, 4), "smooth"), ((2, 9, 13, 128, 3), "smooth")]


def _corr_inputs(shape, device, flow="random"):
    B, H, W, D, _ = shape
    g = torch.Generator(device=device).manual_seed(2)
    f1 = torch.randn((B, H, W, D), device=device, generator=g)
    f2 = torch.randn((B, H, W, D), device=device, generator=g)
    ys, xs = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32), indexing="ij")
    grid = torch.stack([xs, ys], -1)
    noise = 24 * torch.rand((B, H, W, 2), device=device, generator=g) - 12
    shift = torch.tensor([3.3, -2.7], device=device)
    if flow == "random":
        coords = grid + noise
    elif flow == "smooth":
        coords = grid + shift
    elif flow == "edges":
        centre = torch.tensor([(W - 1) / 2, (H - 1) / 2], device=device)
        coords = grid + 0.1 * (grid - centre) + torch.tensor([0.37, -0.21], device=device)
    else:  # "mixed"
        tile = correlation_cuda.TILE
        checker = ((grid[..., :1] // tile + grid[..., 1:] // tile) % 2) == 1
        coords = grid + torch.where(checker, noise, shift)
    levels = correlation.build_corr_pyramid(f1, f2, 4, memory_efficient=True)[2]
    return f1, levels, coords.expand(B, H, W, 2).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,flow", K2_SHAPES)
def test_windowed_correlation_matches_plain_on_card(cuda_device, shape, flow):
    f1, levels, coords = _corr_inputs(shape, cuda_device, flow)
    radius = shape[-1]
    if flow == "mixed":  # both forms in the one launch
        shares = [p["staged"].float().mean().item() for p in correlation_cuda.tile_plan(
            coords, [t.shape[1:3] for t in levels], radius)]
        assert 0 < shares[0] < 1
    launches = correlation_cuda.windowed_correlation.launches
    with torch.no_grad():
        out = correlation.corr_pyramid_lookup(("lazy", f1, levels), coords, radius)
        torch.cuda.synchronize()
        ref = correlation.lookup_lazy_plain(f1, levels, coords, radius)
    assert correlation_cuda.windowed_correlation.launches == launches + 1
    assert out.shape == ref.shape == shape[:3] + (4 * (2 * radius + 1) ** 2,)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_windowed_correlation_takes_unaligned_rows(cuda_device):
    """fmap1 one float past a 16-byte boundary: the kernel's scalar form
    (its 16-byte row loads need aligned rows)."""
    f1, levels, coords = _corr_inputs((2, 16, 20, 128, 3), cuda_device)
    shifted = torch.empty(f1.numel() + 1, device=cuda_device)[1:].view(f1.shape)
    shifted.copy_(f1)
    with torch.no_grad():
        out = correlation_cuda.windowed_correlation(shifted, levels, coords, 3)
        ref = correlation.lookup_lazy_plain(f1, levels, coords, 3)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_windowed_correlation_rejects_what_it_cannot_take(cuda_device):
    f1, levels, coords = _corr_inputs((1, 8, 12, 16, 3), cuda_device)
    k2 = correlation_cuda.windowed_correlation
    with pytest.raises(RuntimeError, match="ROADMAP"):  # forward only
        k2(f1.clone().requires_grad_(), levels, coords, 3)
    with pytest.raises(TypeError):
        k2(f1.double(), levels, coords, 3)
    with pytest.raises(ValueError):  # not contiguous
        k2(f1.transpose(1, 2).contiguous().transpose(1, 2), levels, coords, 3)
    for radius in (1, 2, 5):  # no RAFT window: no instantiation
        with pytest.raises(ValueError):
            k2(f1, levels, coords, radius)
    with pytest.raises(ValueError):  # a level on the CPU
        k2(f1, [levels[0].cpu()] + levels[1:], coords, 3)
    wide = torch.zeros((1, 8, 12, correlation_cuda.MAX_CHANNELS + 1), device=cuda_device)
    with pytest.raises(ValueError):  # more channels than a warp's lanes hold
        k2(wide, [wide], coords, 3)


# Depth-Anything-V2 and the ORB matcher launch none of the port's kernels;
# their card-only checks live here too, as this file imports no JAX.
DA_CARD_ATOL = 1e-4  # measured 1.9e-6 m (chip_smoke.py phase 13a)
DA_BF16_RTOL, DA_BF16_MEAN_RTOL = 5e-3, 1e-3  # measured 4.5e-4, 1.0e-4 (13b)


def _depth_anything(seed):
    from deep_visual_slam_torch.models import DepthAnythingV2

    torch.manual_seed(seed)
    model = DepthAnythingV2("vits")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # LayerScale near 1, as a trained checkpoint's
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
    return model.eval()


@pytest.mark.cuda
def test_depth_anything_on_card_in_fp32_and_bf16(cuda_device):
    """vits at 56x84: fp32 on the card against the CPU, and bf16 under
    autocast against the card's fp32, by relative error."""
    model = _depth_anything(0)
    x = torch.rand(1, 3, 56, 84, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        cpu = model(x)
        model.to(cuda_device)
        fp32 = model(x.to(cuda_device))
        with torch.autocast("cuda", torch.bfloat16):
            bf16 = model(x.to(cuda_device))
    assert (fp32.cpu() - cpu).abs().max().item() <= DA_CARD_ATOL
    assert bf16.dtype == torch.float32 and bf16.shape == (1, 56, 84)
    rel = (bf16 - fp32).abs() / fp32
    assert rel.max().item() <= DA_BF16_RTOL and rel.mean().item() <= DA_BF16_MEAN_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3000, 3100])  # at and above the capacity (3072)
def test_matcher_on_card_matches_cpu(cuda_device, n):
    import numpy as np

    from deep_visual_slam_torch.ops import matching

    rng = np.random.default_rng(0)
    des2 = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    des1 = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    des1[::3] = des2[::3]  # planted matches
    des2[1::7] = des2[0::7][: len(des2[1::7])]  # ties for the nearest place
    got = matching.match_descriptors_device(des1, des2, device=cuda_device)
    assert got == matching.match_descriptors_device(des1, des2, device="cpu")
    assert len(got[0]) > 500


@pytest.mark.cuda
def test_synced_batch_norm_on_card_matches_cpu(cuda_device):
    """The synced BatchNorm's CUDA form (torch's fused batch-norm statistics
    and gradient kernels) against its CPU form (plain float64 operators),
    with no process group: output, input gradient, parameter gradients and
    running statistics, fp32 (1e-5 of each one's scale)."""
    from deep_visual_slam_torch.models.resnet import BatchNorm2d

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, 30, 40, generator=g) * 2 + 3
    dy = torch.randn(4, 16, 30, 40, generator=g)
    runs = []
    for device in ("cpu", cuda_device):
        bn = BatchNorm2d(16).to(device)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 16))
            bn.bias.copy_(torch.linspace(-1, 1, 16))
        bn.sync = True
        xi = x.to(device, copy=True).requires_grad_()
        out = bn(xi)
        out.backward(dy.to(device))
        runs.append([t.detach().cpu() for t in (out, xi.grad, bn.weight.grad, bn.bias.grad,
                                                 bn.running_mean, bn.running_var)])
    for want, got in zip(*runs):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_orb_on_card_matches_cpu(cuda_device):
    """ORB of a 480x640 render of the SLAM fixture and of a 96x128 one, on
    the card and on the CPU: equal outputs; ``extract_features`` of the
    float frame the same way."""
    import numpy as np

    from deep_visual_slam_torch.data import synthetic_multidepth_sequence
    from deep_visual_slam_torch.ops import orb
    from deep_visual_slam_torch.slam import frontend

    for H, W in ((480, 640), (96, 128)):
        rgb = synthetic_multidepth_sequence(1, H, W, seed=100)[0][0]
        gray = orb.rgb_to_gray(torch.from_numpy((np.clip(rgb, 0, 1) * 255).astype(np.uint8)))
        cpu = orb.detect_and_compute(gray)
        card = orb.detect_and_compute(gray.to(cuda_device))
        assert cpu[0].shape[0] > 50
        for a, b in zip(cpu, card):
            assert torch.equal(a, b.cpu())
        kc, dc = frontend.extract_features(rgb, device="cpu")
        kg, dg = frontend.extract_features(rgb, device=cuda_device)
        assert np.array_equal(kc, kg) and np.array_equal(dc, dg)


ENC_CH, DEC_CH = (64, 64, 128, 256, 512), (16, 32, 64, 128, 256)


def decoder_pad_forms(B, H=480, W=640):
    """(label, y shape, y channels-last, skip shape or None, elu, up) of the
    11 launches of a DepthNet forward at B x H x W, in launch order."""
    forms = [("f4", (B, ENC_CH[4], H >> 5, W >> 5), True, None, False, False)]
    for i in range(4, -1, -1):
        skip = (B, ENC_CH[i - 1], H >> i, W >> i) if i > 0 else None
        forms.append((f"upconv_{i}_1 input", (B, DEC_CH[i], H >> (i + 1), W >> (i + 1)),
                      False, skip, True, True))
        forms.append((f"upconv_{i}_1 output", (B, DEC_CH[i], H >> i, W >> i),
                      False, None, True, False))
    return forms


# Per working type: an ulp of values in [1, 2) (the ELU's forward and its
# derivative read from P), and the final rounding's relative bound.
K3_ULP = {torch.bfloat16: 2.0**-7, torch.float32: 2.0**-23}
K3_ROUND = {torch.bfloat16: 2.0**-8, torch.float32: 2.0**-22}


# Small shapes at the edges of the row and column arithmetic: one source
# row that both edge rows reflect onto (3 rows without the upsample, 1 with
# it), 2 rows or columns, odd sizes, with and without the ELU and the skip.
DECODER_PAD_EDGES = [
    ("3 rows", (2, 8, 3, 5), False, None, True, False),
    ("3 rows, no ELU", (2, 8, 3, 4), True, None, False, False),
    ("2x2", (1, 4, 2, 2), False, None, True, False),
    ("1 row up", (2, 4, 1, 3), False, (2, 6, 2, 6), True, True),
    ("1x1 up, no skip", (1, 4, 1, 1), False, None, True, True),
    ("odd up", (2, 3, 3, 5), False, (2, 5, 6, 10), True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["b64_480x640", "b16_480x640", "b4_96x128", "edges"])
def test_decoder_pad_kernel_matches_plain_on_card(cuda_device, case, dtype):
    """At both cells' shapes, at 96x128 (the encoder's last feature 3 rows
    high) and at ``DECODER_PAD_EDGES``, forward and backward."""
    forms = {"b64_480x640": lambda: decoder_pad_forms(64),
             "b16_480x640": lambda: decoder_pad_forms(16),
             "b4_96x128": lambda: decoder_pad_forms(4, 96, 128),
             "edges": lambda: DECODER_PAD_EDGES}[case]()
    g = torch.Generator(device=cuda_device).manual_seed(len(case))

    def randn(shape, channels_last=False):
        t = torch.randn(shape, device=cuda_device, generator=g).to(dtype)
        return t.contiguous(memory_format=torch.channels_last) if channels_last else t

    for label, y_shape, y_cl, skip_shape, elu, up in forms:
        y = randn(y_shape, y_cl)
        skip = None if skip_shape is None else randn(skip_shape, True)
        leaves = [t.clone().requires_grad_() for t in (y, skip) if t is not None]
        launches = decoder_pad.launches, decoder_pad.backward_launches
        out = decoder_pad(*leaves, elu=elu, up=up)
        dout = randn(out.shape)
        out.backward(dout)
        torch.cuda.synchronize()
        assert (decoder_pad.launches, decoder_pad.backward_launches) == (
            launches[0] + 1, launches[1] + 1), label
        assert out.dtype == dtype and out.is_contiguous(), label

        with torch.no_grad():
            ref = decoder_pad_plain(y, skip, elu=elu, up=up)
        C1 = y_shape[1]
        if elu:
            assert torch.equal(out[:, C1:], ref[:, C1:]), label
            got, want = out[:, :C1].float(), ref[:, :C1].float()
            assert ((got - want).abs() <= K3_ULP[dtype] * want.abs()).all(), label
        else:
            assert torch.equal(out, ref), label
        del out, ref

        # Float64 references: the gradient, and the gathered sums without
        # the ELU's derivative.
        refs = []
        for with_elu in (elu, False):
            leaves64 = [t.double().requires_grad_() for t in (y, skip) if t is not None]
            decoder_pad_plain(*leaves64, elu=with_elu, up=up).backward(dout.double())
            refs.append([t.grad for t in leaves64])
        for k, (leaf, want, sums) in enumerate(zip(leaves, *refs)):
            got = leaf.grad
            assert got.dtype == dtype and got.stride() == leaf.stride(), label
            deriv = K3_ULP[dtype] if (elu and k == 0) else 0.0
            tol = (K3_ROUND[dtype] * want.abs() + deriv * sums.abs()
                   + 1e-6 * sums.abs().max())
            assert ((got.double() - want).abs() <= tol).all(), (label, k)
        del leaves, refs, dout


@pytest.mark.cuda
def test_decoder_pad_kernel_rejects_what_it_cannot_take(cuda_device):
    y = torch.randn(1, 4, 3, 3, device=cuda_device)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            decoder_pad(y.to(dtype))
    with pytest.raises(ValueError):  # skip on another device
        decoder_pad(y, torch.randn(1, 2, 6, 6), up=True)
    with pytest.raises(ValueError):  # skip in another dtype
        decoder_pad(y, torch.randn(1, 2, 6, 6, device=cuda_device).bfloat16(), up=True)
    with pytest.raises(ValueError):  # skip not at twice y's size
        decoder_pad(y, torch.randn(1, 2, 5, 6, device=cuda_device), up=True)
    with pytest.raises(ValueError):  # one row: the reflect pad needs two
        decoder_pad(y[:, :, :1])


@pytest.mark.cuda
def test_decoder_pad_launches_11_and_11_a_depthnet_train_step(cuda_device, monkeypatch):
    """A depth train step on the card takes K3 for every padded input: the
    plain composition (F.pad, F.elu, F.interpolate, torch.cat) never runs."""
    from deep_visual_slam_torch.ops import decoder_pad_cuda
    from deep_visual_slam_torch.training import (
        DepthLossConfig,
        TrainState,
        init_depth_model,
        make_depth_train_step,
    )

    def refuse(*args, **kwargs):
        raise AssertionError("the plain composition ran on the card")

    monkeypatch.setattr(decoder_pad_cuda, "decoder_pad_plain", refuse)
    model = init_depth_model(0)
    state = TrainState.create(model, None, 1e-4, 100)
    step = make_depth_train_step(model, DepthLossConfig(), torch.bfloat16, device=cuda_device)
    g = torch.Generator().manual_seed(0)
    B, H, W = 2, 64, 96
    batch = {"image": torch.rand(B, H, W, 3, generator=g),
             "depth": 0.5 + 5 * torch.rand(B, H, W, 1, generator=g),
             "valid_mask": torch.ones(B, H, W, 1)}
    launches = decoder_pad.launches, decoder_pad.backward_launches
    losses = step(state, batch)
    torch.cuda.synchronize()
    assert (decoder_pad.launches - launches[0],
            decoder_pad.backward_launches - launches[1]) == (11, 11)
    assert torch.isfinite(losses["loss"])


@pytest.mark.cuda
def test_vo_export_traces_the_plain_route_and_runs_on_card(cuda_device, tmp_path):
    """The exported step holds the plain composition (a ctypes launch cannot
    run on a trace's fake tensors) and agrees with the eager networks, which
    launch K3."""
    from deep_visual_slam_torch.training import init_vo_models
    from deep_visual_slam_torch.utils.export import (
        export_vo_inference,
        load_exported,
        make_vo_inference_fn,
    )

    depth, pose = init_vo_models(0)
    H, W = 64, 96
    launches = decoder_pad.launches
    path = export_vo_inference(depth, pose, str(tmp_path / "vo.pt2"), (H, W),
                               device=cuda_device)
    assert decoder_pad.launches == launches
    g = torch.Generator().manual_seed(1)
    frame, prev = ((255 * torch.rand(1, H, W, 3, generator=g)).to(torch.uint8).to(cuda_device)
                   for _ in range(2))
    with torch.inference_mode():
        got = load_exported(path)(frame, prev)
        assert decoder_pad.launches == launches
        want = make_vo_inference_fn(depth, pose)(frame, prev)
    assert decoder_pad.launches > launches
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0)  # depth
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-5)  # T
