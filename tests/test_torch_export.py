"""The port's VO inference export, ResNet-50/101/152 encoders,
``TwoEncoderPoseNet`` and the intrinsics helpers against the JAX package,
on the CPU in fp32 at 64x96.

Weights start as the port's initialization with BatchNorm statistics and
affine terms drawn in numpy (so eval-mode normalization is not the
identity), carried into JAX's tree by the JAX package's own converters
(``convert_depthnet``, ``convert_posenet``, ``convert_resnet_encoder``)
and back by the port's (``utils/weights.py``), which must restore them
exactly. The JAX side runs jitted; XLA and PyTorch sum the convolutions in
other orders, so outputs are held as ``tests/test_torch_models.py`` holds
the ResNet-18 networks: disparity and pose within atol 1e-4 (measured:
the ResNet-50 DepthNet's disparities within 2.4e-6, its feature maps
within 2.3e-6 of their largest value; the exported step's disparity
within 6e-8 and T within 1.4e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.models import DepthNet as JaxDepthNet
from deep_visual_slam_tpu.models import PoseNet as JaxPoseNet
from deep_visual_slam_tpu.models.posenet import TwoEncoderPoseNet as JaxTwoEncoderPoseNet
from deep_visual_slam_tpu.models.resnet import ResNetEncoder as JaxResNetEncoder
from deep_visual_slam_tpu.ops import camera as jax_camera
from deep_visual_slam_tpu.utils import export as jax_export
from deep_visual_slam_tpu.utils.torch_weights import (
    convert_depthnet,
    convert_posenet,
    convert_resnet_encoder,
)

from deep_visual_slam_torch.models import DepthNet, PoseNet, TwoEncoderPoseNet
from deep_visual_slam_torch.models.resnet import BottleneckBlock
from deep_visual_slam_torch.ops import intrinsics_pyramid, scale_intrinsics
from deep_visual_slam_torch.utils.export import (
    export_vo_inference,
    load_exported,
    make_vo_inference_fn,
)
from deep_visual_slam_torch.utils.weights import (
    depthnet_from_jax,
    posenet_from_jax,
    two_encoder_posenet_from_jax,
)

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

H, W = 64, 96
ATOL = 1e-4


def _randomized(model, seed):
    """``model`` with BatchNorm statistics and affine terms drawn from
    ``seed``, in eval mode."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith(("running_var", "bn1.weight", "bn2.weight", "bn3.weight")):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
            elif k.endswith(("running_mean", "bn1.bias", "bn2.bias", "bn3.bias")):
                v.copy_(torch.from_numpy(rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)))
    return model.eval()


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_state_dict(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def test_export_round_trip_matches_jax(tmp_path):
    """``export_vo_inference`` on the CPU, saved and loaded: equal to the
    eager fp32 step (atol 1e-6; measured 0), and to JAX's exported StableHLO
    (``platforms=("cpu",)``) on the same uint8 frames: disparity and T
    within atol 1e-4, depth within 1e-3 relative (measured 2.4e-7)."""
    g = torch.Generator().manual_seed(0)
    depth = _randomized(DepthNet(generator=g), 1)
    pose = _randomized(PoseNet(generator=g), 2)
    rng = np.random.default_rng(3)
    frame, prev = (rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8) for _ in range(2))

    path = export_vo_inference(depth, pose, str(tmp_path / "vo.pt2"), (H, W), device="cpu")
    loaded = load_exported(path)
    got = [x.numpy() for x in loaded(torch.from_numpy(frame), torch.from_numpy(prev))]
    with torch.no_grad():
        eager = make_vo_inference_fn(depth, pose)(torch.from_numpy(frame), torch.from_numpy(prev))
    assert [x.shape for x in got] == [(1, H, W), (1, 4, 4), (1, H, W, 1)]
    for a, b in zip(got, eager):
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-6)

    jpath = jax_export.export_vo_inference(
        JaxDepthNet(phase_fused=False), JaxPoseNet(),
        convert_depthnet(_numpy(depth.state_dict())),
        convert_posenet(_numpy(pose.state_dict())),
        str(tmp_path / "vo.stablehlo"), image_shape=(H, W), platforms=("cpu",),
    )
    want = [np.asarray(x) for x in
            jax_export.load_exported(jpath).call(jnp.asarray(frame), jnp.asarray(prev))]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3, atol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=ATOL)


def test_bf16_export_round_trip(tmp_path):
    """With ``compute_dtype=torch.bfloat16`` the autocast region is part of
    the exported graph: the loaded program equals the eager bf16 step
    (atol 1e-6; measured 0), its outputs stay fp32, and it leaves the fp32
    step by bf16 rounding only (depth within 2e-2 relative, as
    ``tests/test_torch_slice.py`` holds bf16 ``Networks.step``)."""
    g = torch.Generator().manual_seed(8)
    depth = _randomized(DepthNet(generator=g), 9)
    pose = _randomized(PoseNet(generator=g), 10)
    rng = np.random.default_rng(11)
    frame, prev = (torch.from_numpy(rng.integers(0, 256, (1, H, W, 3), dtype=np.uint8))
                   for _ in range(2))
    path = export_vo_inference(depth, pose, str(tmp_path / "vo_bf16.pt2"), (H, W),
                               compute_dtype=torch.bfloat16, device="cpu")
    got = load_exported(path)(frame, prev)
    with torch.no_grad():
        eager = make_vo_inference_fn(depth, pose, compute_dtype=torch.bfloat16)(frame, prev)
        fp32 = make_vo_inference_fn(depth, pose)(frame, prev)
    assert [x.dtype for x in got] == [torch.float32] * 3
    for a, b in zip(got, eager):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), fp32[0].numpy(), rtol=2e-2, atol=0)


@pytest.mark.parametrize("num_layers", [18, 34, 50, 101, 152])
def test_encoder_depths_and_weight_map(num_layers):
    """``num_ch_enc`` per instance (x4 past the stem above 34 layers, JAX's
    property) and the bottleneck blocks' names: the port's DepthNet
    ``state_dict`` goes through the JAX package's ``convert_depthnet`` and
    back through ``depthnet_from_jax`` unchanged."""
    net = DepthNet(num_layers)
    assert net.encoder.num_ch_enc == JaxResNetEncoder(num_layers=num_layers).num_ch_enc
    assert isinstance(net.encoder.encoder.layer1[0], BottleneckBlock) is (num_layers > 34)
    sd = net.state_dict()
    _assert_same_state_dict(depthnet_from_jax(convert_depthnet(_numpy(sd), num_layers),
                                              num_layers), sd)


def test_resnet50_depthnet_matches_jax(rng):
    """A ResNet-50 DepthNet through ``depthnet_from_jax(..., 50)``: the
    encoder's five feature maps (within 1e-4 of each map's largest value)
    and the four disparities against JAX's."""
    src = _randomized(DepthNet(50, generator=torch.Generator().manual_seed(4)), 5)
    variables = convert_depthnet(_numpy(src.state_dict()), 50)
    net = DepthNet(50).eval()
    net.load_state_dict(depthnet_from_jax(variables, 50))
    x = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    with torch.no_grad():
        feats = net.encoder(torch.from_numpy(x).permute(0, 3, 1, 2))
        out = net(torch.from_numpy(x))
    encoder = JaxResNetEncoder(num_layers=50)
    jfeats, jout = jax.jit(lambda v, x: (
        encoder.apply({"params": v["params"]["encoder"],
                       "batch_stats": v["batch_stats"]["encoder"]}, x, train=False),
        JaxDepthNet(num_layers=50, phase_fused=False).apply(v, x, train=False),
    ))(variables, jnp.asarray(x))
    for a, b in zip(feats, jfeats):
        b = np.asarray(b)
        assert a.shape[1] == b.shape[-1]
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), b, rtol=0,
                                   atol=1e-4 * np.abs(b).max())
    for s in range(4):
        np.testing.assert_allclose(out[("disp", s)].numpy(), np.asarray(jout[("disp", s)]),
                                   rtol=0, atol=ATOL, err_msg=f"disp {s}")


def _flax_conv(sd, prefix):
    return {"kernel": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0),
            "bias": sd[f"{prefix}.bias"]}


@pytest.mark.parametrize("num_input_images", [2, 3])
def test_two_encoder_posenet_matches_jax(rng, num_input_images):
    """``TwoEncoderPoseNet``: one shared encoder over the frames stacked on
    the batch, the squeeze per frame, the pose head over the concatenated
    maps, 6 x (n - 1) outputs scaled by 0.01. The JAX tree is built from the
    port's weights (the encoder by ``convert_resnet_encoder``) and read back
    by ``two_encoder_posenet_from_jax`` unchanged."""
    n = num_input_images
    src = _randomized(TwoEncoderPoseNet(num_input_images=n,
                                        generator=torch.Generator().manual_seed(6)), 7)
    sd = _numpy(src.state_dict())
    enc = convert_resnet_encoder(
        {k[len("encoder.encoder."):]: v for k, v in sd.items()
         if k.startswith("encoder.encoder.")}, 18, 1)
    params = {"encoder": enc["params"]}
    for i, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        params[name] = _flax_conv(sd, f"net.{i}")
    variables = {"params": params, "batch_stats": {"encoder": enc["batch_stats"]}}
    net = TwoEncoderPoseNet(num_input_images=n).eval()
    back = two_encoder_posenet_from_jax(variables)
    _assert_same_state_dict(back, src.state_dict())
    net.load_state_dict(back)
    x = rng.uniform(size=(2, H, W, 3 * n)).astype(np.float32)
    with torch.no_grad():
        aa, t = net(torch.from_numpy(x))
    jaa, jt = jax.jit(lambda v, x: JaxTwoEncoderPoseNet(num_input_images=n).apply(
        v, x, train=False))(variables, jnp.asarray(x))
    for a, b in ((aa, jaa), (t, jt)):
        assert a.shape == b.shape == (2, n - 1, 1, 3)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    assert posenet_from_jax(variables).keys() == back.keys()


def test_intrinsics_helpers_match_jax(rng):
    """``scale_intrinsics`` on a batch of 4x4 intrinsics and the 4-scale
    ``intrinsics_pyramid`` with its inverses: rtol 1e-6 (the inverses are
    LU solves in two libraries)."""
    K = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    K[:, 0, 0], K[:, 1, 1] = rng.uniform(100, 600, 3), rng.uniform(100, 600, 3)
    K[:, 0, 2], K[:, 1, 2] = rng.uniform(40, 320, 3), rng.uniform(30, 240, 3)
    got = scale_intrinsics(torch.from_numpy(K), 0.5, 0.25).numpy()
    want = np.asarray(jax_camera.scale_intrinsics(jnp.asarray(K), 0.5, 0.25))
    np.testing.assert_array_equal(got, want)
    pyramid = intrinsics_pyramid(torch.from_numpy(K), 4)
    jpyramid = jax_camera.intrinsics_pyramid(jnp.asarray(K), 4)
    assert len(pyramid) == len(jpyramid) == 4
    for (Ks, inv), (jKs, jinv) in zip(pyramid, jpyramid):
        np.testing.assert_array_equal(Ks.numpy(), np.asarray(jKs))
        np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(inv.numpy() @ Ks.numpy(), np.tile(np.eye(4), (3, 1, 1)),
                                   atol=1e-6)
