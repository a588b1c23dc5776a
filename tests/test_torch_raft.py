"""The port's RAFT, its correlation lookups and the flow pose networks against
the JAX package, on the CPU in fp32, the same numpy inputs on both sides.

- ``resize_bilinear_align_corners``: atol 5e-6 on values of ~3 (JAX samples
  through normalized grid coordinates, PyTorch maps the pixels directly:
  the source positions differ by rounding, 1.7e-6 measured).
- ``build_corr_pyramid`` and both lookups at 9x13 fmaps, whose fourth level
  is 1x1 (every tap of a 1-pixel axis samples index 0) and whose odd rows and
  columns the pooling drops, with targets up to 6 pixels off the grid so
  that taps leave the map: atol 1e-5 on correlations of magnitude ~5 (fp32
  dot products summed in other orders).
- ``upsample_flow_convex`` with a random mask (a uniform one hides a wrong
  channel order): atol 1e-5.
- SmallRAFT (inside FlowPoseNet) and BasicRAFT at 128x160 (1/8 fmaps 16x20,
  so no level is degenerate), ``iters=2``, every flow of the list, with the
  port's random weights carried to JAX by ``convert_raft``: atol 1e-4 px on
  flows of ~2 px (the measured gap is ~2e-5: XLA and PyTorch sum the
  convolutions in other orders); the pose atol 1e-6 on values of ~1e-2.
- The port's ``memory_efficient=True`` against its dense route, which
  ``memory_efficient=None`` (the default) takes on the CPU: atol 1e-4 px
  (the JAX package's own test holds its two routes at 5e-3).
- ``FlowUpdateModule``: atol 1e-5 on the hidden state, 1e-6 on the twist.

Two JAX models are compiled, FlowPoseNet and BasicRAFT; each lookup test
compiles its pyramid and lookups as one small program, and the
FlowUpdateModule runs op by op. Every JAX tree is read back by the port's
``utils/weights.py`` and must equal the port's ``state_dict``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.models.flow_posenet import FlowPoseNet as JaxFlowPoseNet
from deep_visual_slam_tpu.models.flow_posenet import FlowUpdateModule as JaxFlowUpdateModule
from deep_visual_slam_tpu.models.raft import BasicRAFT as JaxBasicRAFT
from deep_visual_slam_tpu.models.raft import coords_grid as jax_coords_grid
from deep_visual_slam_tpu.models.raft import upsample_flow_convex as jax_upsample_flow_convex
from deep_visual_slam_tpu.ops.pallas import correlation as jax_corr
from deep_visual_slam_tpu.ops.warp import (
    resize_bilinear_align_corners as jax_resize_align_corners,
)
from deep_visual_slam_tpu.utils.torch_weights import convert_raft

from deep_visual_slam_torch.models import BasicRAFT, FlowPoseNet, FlowUpdateModule, SmallRAFT
from deep_visual_slam_torch.models import raft
from deep_visual_slam_torch.models.raft import upsample_flow_convex
from deep_visual_slam_torch.ops import correlation
from deep_visual_slam_torch.ops.correlation_cuda import windowed_correlation
from deep_visual_slam_torch.ops.warp import resize_bilinear_align_corners
from deep_visual_slam_torch.utils.pretrained import load_raft_state_dict
from deep_visual_slam_torch.utils.weights import (
    flow_posenet_from_jax,
    flow_update_module_from_jax,
    raft_from_jax,
)

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

H, W = 128, 160
FLOW_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def _flax_conv(sd, prefix):
    return {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0), "bias": sd[f"{prefix}.bias"]}


def _flax_dense(sd, prefix):
    return {"kernel": sd[f"{prefix}.weight"].T, "bias": sd[f"{prefix}.bias"]}


def _assert_same_state_dict(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)


def _basic_raft(iters):
    """A BasicRAFT with random running statistics in its batch-normed cnet."""
    model = BasicRAFT(iters=iters, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
    return model.eval()


def test_resize_bilinear_align_corners_matches_jax(rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    got = resize_bilinear_align_corners(_t(x), 40, 56).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_resize_align_corners(jnp.asarray(x), 40, 56)),
                               rtol=0, atol=5e-6)
    same = _t(x)
    assert resize_bilinear_align_corners(same, 5, 7) is same


@pytest.mark.parametrize("memory_efficient", [False, True])
def test_corr_pyramid_and_lookup_match_jax(rng, memory_efficient):
    B, h, w, D = 2, 9, 13, 16
    f1 = rng.normal(size=(B, h, w, D)).astype(np.float32)
    f2 = rng.normal(size=(B, h, w, D)).astype(np.float32)
    coords = (np.asarray(jax_coords_grid(B, h, w))
              + rng.uniform(-6, 6, size=(B, h, w, 2))).astype(np.float32)
    ours = correlation.build_corr_pyramid(_t(f1), _t(f2), 4, memory_efficient)

    @jax.jit
    def jax_levels_and_lookups(f1, f2, coords):
        pyramid = jax_corr.build_corr_pyramid(f1, f2, 4, memory_efficient)
        return pyramid[2], [jax_corr.corr_pyramid_lookup(pyramid, coords, r) for r in (1, 3)]

    jax_levels, jax_lookups = jax_levels_and_lookups(f1, f2, coords)
    assert ours[0] == ("lazy" if memory_efficient else "dense")
    levels = ours[2]
    assert [tuple(t.shape[1:3]) for t in levels] == [(9, 13), (4, 6), (2, 3), (1, 1)]
    for a, b in zip(levels, jax_levels):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for radius, want in zip((1, 3), jax_lookups):
        got = correlation.corr_pyramid_lookup(ours, _t(coords), radius).numpy()
        want = np.asarray(want)
        assert got.shape == (B, h, w, 4 * (2 * radius + 1) ** 2)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=f"radius {radius}")
    if memory_efficient:  # the kernel's wrapper takes CUDA tensors only
        with pytest.raises(ValueError, match="CUDA"):
            windowed_correlation(ours[1], levels, _t(coords), 3)


def test_upsample_flow_convex_random_mask_matches_jax(rng):
    flow = rng.normal(size=(2, 4, 6, 2)).astype(np.float32)
    mask = 3.0 * rng.normal(size=(2, 4, 6, 9 * 64)).astype(np.float32)
    got = upsample_flow_convex(_t(flow), _t(mask)).numpy()
    want = np.asarray(jax_upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask)))
    assert got.shape == (2, 32, 48, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_small_raft_and_flow_posenet_match_jax(rng):
    """FlowPoseNet's SmallRAFT (every flow of the list, read from JAX's
    intermediates) and its pose, at 128x160, B=2, ``iters=2``."""
    net = FlowPoseNet(iters=2, generator=torch.Generator().manual_seed(1)).eval()
    sd = _numpy(net.state_dict())
    raft_sd = {k[len("flow_net."):]: v for k, v in sd.items() if k.startswith("flow_net.")}
    params = {"flow_net": convert_raft(raft_sd, small=True)["params"],
              "Dense_0": _flax_dense(sd, "fc")}
    for i in range(3):
        params[f"Conv_{i}"] = _flax_conv(sd, f"conv{i + 1}")
    variables = {"params": params}
    _assert_same_state_dict(flow_posenet_from_jax(variables), net.state_dict())

    pair = rng.uniform(size=(2, H, W, 6)).astype(np.float32)
    (jaa, jt), inter = jax.jit(lambda v, x: JaxFlowPoseNet(iters=2).apply(
        v, x, capture_intermediates=lambda m, _: m.name == "flow_net"))(
            variables, jnp.asarray(pair))
    jax_flows = inter["intermediates"]["flow_net"]["__call__"][0]
    with torch.no_grad():
        flows = net.flow_net(_t(pair[..., :3]), _t(pair[..., 3:]))
        aa, t = net(_t(pair))
    assert len(flows) == len(jax_flows) == 2
    for i, (a, b) in enumerate(zip(flows, jax_flows)):
        assert a.shape == (2, H, W, 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=FLOW_ATOL,
                                   err_msg=f"iteration {i}")
    for a, b in ((aa, jaa), (t, jt)):
        assert a.shape == (2, 1, 1, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


def test_basic_raft_matches_jax(rng):
    """BasicRAFT (batch-normed cnet, SepConvGRU, convex upsampling) at
    128x160, ``iters=2``, every flow of the list."""
    model = _basic_raft(2)
    variables = convert_raft(_numpy(model.state_dict()), small=False)
    x1, x2 = (rng.uniform(size=(1, H, W, 3)).astype(np.float32) for _ in range(2))
    want = jax.jit(JaxBasicRAFT(iters=2).apply)(variables, jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        got = model(_t(x1), _t(x2))
    assert len(got) == len(want) == 2
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=FLOW_ATOL,
                                   err_msg=f"iteration {i}")


@pytest.mark.parametrize("small", [True, False])
def test_memory_efficient_matches_dense(rng, small, monkeypatch):
    routes = []

    def build(fmap1, fmap2, num_levels, memory_efficient):
        routes.append(memory_efficient)
        return correlation.build_corr_pyramid(fmap1, fmap2, num_levels, memory_efficient)

    monkeypatch.setattr(raft, "build_corr_pyramid", build)
    dense = SmallRAFT(iters=2, generator=torch.Generator().manual_seed(5)) if small \
        else _basic_raft(2)
    assert dense.memory_efficient is None  # the route follows the device
    lazy = (SmallRAFT if small else BasicRAFT)(iters=2, memory_efficient=True)
    lazy.load_state_dict(dense.state_dict())
    lazy.eval()
    x1, x2 = (_t(rng.uniform(size=(1, H, W, 3)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        for a, b in zip(dense.eval()(x1, x2), lazy(x1, x2)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=FLOW_ATOL)
    assert routes == [False, True]  # the default is dense on the CPU


def test_raft_from_jax_inverts_convert_raft():
    for small in (True, False):
        model = SmallRAFT() if small else _basic_raft(1)
        variables = convert_raft(_numpy(model.state_dict()), small=small)
        assert ("batch_stats" in variables) is not small
        _assert_same_state_dict(raft_from_jax(variables, small=small), model.state_dict())


def test_flow_update_module_matches_jax(rng):
    B, h, w = 2, 6, 8
    module = FlowUpdateModule(corr_planes=196, input_dim=64,
                              generator=torch.Generator().manual_seed(2)).eval()
    sd = _numpy(module.state_dict())
    params = {f"Conv_{i}": _flax_conv(sd, name)
              for i, name in enumerate(("convc1", "convc2", "convf1", "convf2", "conv"))}
    params["GlobalContextConvGRU_0"] = {
        name: _flax_conv(sd, f"gru.{name}")
        for name in ("w", "convz", "convz_glo", "convr", "convr_glo", "convq", "convq_glo")}
    params["Dense_0"] = _flax_dense(sd, "fc")
    variables = {"params": params}
    _assert_same_state_dict(flow_update_module_from_jax(variables), module.state_dict())

    inputs = [rng.normal(size=(B, h, w, c)).astype(np.float32) for c in (128, 64, 196, 2)]
    inputs[0] = np.tanh(inputs[0])
    jnet, jpose = JaxFlowUpdateModule().apply(variables, *map(jnp.asarray, inputs))
    with torch.no_grad():
        net, pose = module(*map(_t, inputs))
    np.testing.assert_allclose(net.numpy(), np.asarray(jnet), rtol=0, atol=1e-5)
    assert pose.shape == (B, 6)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), rtol=0, atol=1e-6)


def test_load_raft_state_dict(tmp_path):
    """A reference-style checkpoint: DataParallel's ``module.`` prefixes in a
    ``state_dict`` wrapper. It loads strictly, and a Small file does not
    load as the Basic variant."""
    model = SmallRAFT(generator=torch.Generator().manual_seed(7))
    path = tmp_path / "raft-small.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in model.state_dict().items()}}, path)
    sd = load_raft_state_dict(str(path), small=True)
    _assert_same_state_dict(sd, model.state_dict())
    net = FlowPoseNet(iters=1)
    net.flow_net.load_state_dict(sd)
    with pytest.raises(RuntimeError, match="state_dict"):
        load_raft_state_dict(str(path), small=False)
