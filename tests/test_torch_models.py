"""Parity of the PyTorch port's DepthNet and PoseNet with the JAX package.

Weights come from a JAX ``init`` (BatchNorm statistics and affine terms
randomized in numpy so eval-mode normalization is not the identity) and are
carried across by ``deep_visual_slam_torch.utils.weights``. Both sides run
in fp32 on the CPU in eval mode; conv sums are taken in other orders by XLA
and by PyTorch, so the outputs are held to atol 1e-4. The JAX package's own
``convert_depthnet``/``convert_posenet`` read the port's ``state_dict``s
back exactly.
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

from deep_visual_slam_torch.models import DepthNet, PoseNet
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
