"""Parity of the PyTorch port's DepthNet and PoseNet with the JAX package.

Weights come from a JAX ``init`` (BatchNorm statistics and affine terms
randomized in numpy so eval-mode normalization is not the identity) and are
carried across by ``deep_visual_slam_torch.utils.weights``. Both sides run
in fp32 on the CPU in eval mode; conv sums are taken in other orders by XLA
and by PyTorch, so the outputs are held to atol 1e-4. The JAX package's own
``convert_depthnet``/``convert_posenet`` read the port's ``state_dict``s
back exactly.

The decoder's padded conv inputs (``ops/decoder_pad_cuda.py``, kernel K3 on
the card): on the CPU their plain version, the composition the kernels
replace, is held to the kernels' index arithmetic, outputs and gradients bit
for bit in fp32, and ``DepthDecoder``'s forward to its own modules called in
the old order, each padding its own input.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.models import DepthNet as JaxDepthNet
from deep_visual_slam_tpu.models import PoseNet as JaxPoseNet
from deep_visual_slam_tpu.utils.torch_weights import convert_depthnet, convert_posenet

from deep_visual_slam_torch.models import DepthDecoder, DepthNet, PoseNet
from deep_visual_slam_torch.ops.decoder_pad_cuda import decoder_pad
from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

# One thread per test process: the tests run beside others, and torch's
# default of one thread per core then spends its time waiting for cores.
torch.set_num_threads(1)

H, W = 64, 96


@functools.lru_cache(maxsize=None)
def _init(network: str):
    """``init`` of the JAX DepthNet (with the ``unc`` head) or PoseNet at
    [1, H, W, C] as numpy, with random BN, made once per test process."""
    model, channels, seed = {
        "depth": (JaxDepthNet(predict_uncertainty=True), 3, 1),
        "pose": (JaxPoseNet(), 6, 2),
    }[network]
    variables = jax.tree.map(
        np.asarray,
        jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1, H, W, channels))),
    )
    rng = np.random.default_rng(seed)

    def randomize(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomize(v)
            elif k in ("scale", "var"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "mean" or (k == "bias" and "scale" in tree):
                tree[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)

    randomize(variables)
    return variables


def jax_variables(network: str, predict_uncertainty: bool = False):
    """A fresh copy of the cached variables; the DepthNet's without its
    ``uncconv_0`` head unless ``predict_uncertainty``."""
    variables = copy.deepcopy(_init(network))
    if network == "depth" and not predict_uncertainty:
        del variables["params"]["decoder"]["uncconv_0"]
    return variables


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("predict_uncertainty", [False, True])
def test_depthnet_parity_with_both_jax_decoders(rng, predict_uncertainty):
    variables = jax_variables("depth", predict_uncertainty)
    net = DepthNet(predict_uncertainty=predict_uncertainty).eval()
    net.load_state_dict(depthnet_from_jax(variables))
    x = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    expect_keys = {("disp", s) for s in range(4)}
    if predict_uncertainty:
        expect_keys.add(("unc", 0))
    assert set(out) == expect_keys
    for phase_fused in (False, True):
        model = JaxDepthNet(
            phase_fused=phase_fused, predict_uncertainty=predict_uncertainty
        )
        ref = jax.jit(lambda v, x: model.apply(v, x, train=False))(
            variables, jnp.asarray(x)
        )
        assert set(ref) == expect_keys
        for k in expect_keys:
            assert out[k].shape == ref[k].shape, k
            np.testing.assert_allclose(
                out[k].numpy(), np.asarray(ref[k]), atol=1e-4, rtol=0,
                err_msg=f"{k} phase_fused={phase_fused}",
            )


def test_posenet_parity(rng):
    variables = jax_variables("pose")
    net = PoseNet().eval()
    net.load_state_dict(posenet_from_jax(variables))
    x = rng.uniform(size=(2, H, W, 6)).astype(np.float32)
    with torch.no_grad():
        aa, t = net(torch.from_numpy(x))
    jaa, jt = JaxPoseNet().apply(variables, jnp.asarray(x), train=False)
    for a, b in ((aa, jaa), (t, jt)):
        assert a.shape == b.shape == (2, 1, 1, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)


def test_weights_round_trip_through_reference_converters():
    """The port's state_dicts use the reference torch naming: the JAX
    package's converters map them back to the JAX variables exactly. (The
    reference naming has no uncertainty head, so the DepthNet is the plain
    one.)"""
    for network, port_model, to_torch, back in (
        ("depth", DepthNet, depthnet_from_jax, convert_depthnet),
        ("pose", PoseNet, posenet_from_jax, convert_posenet),
    ):
        variables = jax_variables(network)
        sd = to_torch(variables)
        port = port_model().state_dict()
        assert set(sd) == set(port)
        assert all(sd[k].shape == port[k].shape for k in port)
        restored = back({k: v.numpy() for k, v in sd.items()})
        a, b = _flat(variables), _flat(restored)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _reflected_gather(y, skip, elu, up):
    """P by the kernel's index arithmetic: padded row (column) q of a part
    n rows high takes source row reflect(q - 1) >> up, with reflect(-1) = 1
    and reflect(n) = n - 2; the skip is not upsampled."""

    def rows(n, shift):
        q = torch.arange(-1, n + 1)
        return torch.where(q < 0, -q, torch.where(q >= n, 2 * (n - 1) - q, q)) >> shift

    H, W = y.shape[2] << up, y.shape[3] << up
    x = torch.nn.functional.elu(y) if elu else y
    parts = [x[:, :, rows(H, up)][:, :, :, rows(W, up)]]
    if skip is not None:
        parts.append(skip[:, :, rows(H, 0)][:, :, :, rows(W, 0)])
    return torch.cat(parts, dim=1)


# (y shape, skip channels or None, elu, up): pad_elu with and without the
# ELU at odd sizes, at 3 rows (both edge rows reflect onto row 1) and at
# 2x2; pad_up_cat with a channels-last skip, from 1x1 (padded at 2x2) and
# odd sizes, and without a skip (the last level).
DECODER_PAD_FORMS = [
    ((2, 3, 5, 7), None, True, False),
    ((1, 4, 2, 2), None, True, False),
    ((2, 5, 3, 2), None, False, False),
    ((2, 3, 3, 5), 4, True, True),
    ((1, 2, 1, 1), 3, True, True),
    ((2, 3, 5, 3), None, True, True),
]


@pytest.mark.parametrize("y_shape,c2,elu,up", DECODER_PAD_FORMS)
def test_decoder_pad_plain_is_the_old_composition(y_shape, c2, elu, up):
    """The old composition (``decoder_pad`` takes it on the CPU) against the
    reflected gather the kernels compute: outputs and, from an output
    gradient of small integers (sums exact in any order), gradients bit
    for bit in fp32."""
    g = torch.Generator().manual_seed(sum(y_shape))
    y = torch.randn(y_shape, generator=g)
    skip = None
    if c2 is not None:
        B, _, h, w = y_shape
        skip = torch.randn((B, c2, 2 * h, 2 * w), generator=g).contiguous(
            memory_format=torch.channels_last)
    dout = None
    results = []
    for fn in (lambda a, b: decoder_pad(a, b, elu=elu, up=up),
               lambda a, b: _reflected_gather(a, b, elu, up)):
        a = y.clone().requires_grad_()
        b = None if skip is None else skip.clone().requires_grad_()
        out = fn(a, b)
        if dout is None:
            dout = torch.randint(-8, 9, out.shape, generator=g).float()
        out.backward(dout)
        results.append((out, a.grad, None if b is None else b.grad))
    (out, dy, dskip), (ref, dy_ref, dskip_ref) = results
    h, w = y_shape[2] << up, y_shape[3] << up
    assert out.shape == (y_shape[0], y_shape[1] + (c2 or 0), h + 2, w + 2)
    assert torch.equal(out, ref) and torch.equal(dy, dy_ref)
    assert dskip is dskip_ref is None or torch.equal(dskip, dskip_ref)


@pytest.mark.parametrize("predict_uncertainty", [False, True])
def test_depth_decoder_is_its_modules_in_the_old_order(predict_uncertainty):
    """Each padded input written once for all its convs gives what each
    module, padding its own input, gave."""
    g = torch.Generator().manual_seed(3)
    dec = DepthDecoder(predict_uncertainty=predict_uncertainty, generator=g)
    features = [torch.randn((1, c, 2 << (4 - s), 3 << (4 - s)), generator=g)
                .contiguous(memory_format=torch.channels_last)
                for s, c in enumerate((64, 64, 128, 256, 512))]
    with torch.no_grad():
        out = dec(features)
        want = {}
        x = features[-1]
        for k, i in enumerate(range(4, -1, -1)):
            x = torch.nn.functional.interpolate(dec[2 * k](x), scale_factor=2, mode="nearest")
            if i > 0:
                x = torch.cat([x, features[i - 1]], dim=1)
            x = dec[2 * k + 1](x)
            if i < 4:
                want[("disp", i)] = torch.sigmoid(dec[10 + i](x).float())
        if predict_uncertainty:
            want[("unc", 0)] = torch.sigmoid(dec[14](x).float())
    assert out.keys() == want.keys()
    for key in want:
        assert out[key].shape == want[key].shape, key
        assert torch.equal(out[key], want[key]), key
