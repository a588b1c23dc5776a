"""The port's weight routes read the JAX package's ``.npz`` variable files.

The same seeded port weights go to JAX variables through the JAX package's
own converters (``utils/torch_weights.py``: ``convert_depthnet``,
``convert_posenet``, ``convert_resnet_encoder``, ``convert_raft``), are
written by its ``save_variables_npz``, and come back through the port's
``apply_vo_pretrained``, ``apply_depth_pretrained`` and
``load_raft_state_dict``: every weight must equal its source exactly
(tolerance 0; BatchNorm's batch counters aside, which no route carries).
A 3-channel encoder file fails on the pose encoder as the JAX graft does,
and a file of the wrong network or a misshapen weight raises. No JAX
computation runs.
"""

import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.utils.pretrained import apply_vo_pretrained as jax_apply_vo_pretrained
from deep_visual_slam_tpu.utils.pretrained import save_variables_npz
from deep_visual_slam_tpu.utils.torch_weights import (
    convert_depthnet,
    convert_posenet,
    convert_raft,
    convert_resnet_encoder,
)

from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.models.raft import RAFT
from deep_visual_slam_torch.training import init_depth_model, init_vo_models
from deep_visual_slam_torch.utils.pretrained import (
    apply_depth_pretrained,
    apply_vo_pretrained,
    load_raft_state_dict,
)

torch.set_num_threads(1)

_ENC = "encoder.encoder."


def _random_state_dict(module, seed):
    """``module``'s weights drawn from ``seed`` (batch counters kept), as
    the module holds them: a module registered under two names (RAFT's
    shortcut norms) keeps one value."""
    rng = np.random.default_rng(seed)
    module.load_state_dict({
        k: (v if k.endswith("num_batches_tracked")
            else torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)))
        for k, v in module.state_dict().items()})
    return {k: v.clone() for k, v in module.state_dict().items()}


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_equal(model, want, prefix=""):
    got = model.state_dict()
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    assert keys
    for k in keys:
        assert torch.equal(got[prefix + k], want[k]), k


def test_vo_networks_load_from_jax_npz_exactly(tmp_path):
    """DepthNet and PoseNet ``.npz`` files through ``Train.pretrained_weights``
    into freshly made networks: equal to the source weights, and the same
    report as the JAX package's graft of the same files."""
    depth_sd = _random_state_dict(DepthNet(), 1)
    pose_sd = _random_state_dict(PoseNet(), 2)
    save_variables_npz(str(tmp_path / "depth.npz"), convert_depthnet(_numpy(depth_sd)))
    save_variables_npz(str(tmp_path / "pose.npz"), convert_posenet(_numpy(pose_sd)))
    config = {"Train": {"pretrained_weights": {"depth": str(tmp_path / "depth.npz"),
                                               "pose": str(tmp_path / "pose.npz")}}}
    depth, pose = init_vo_models(7)
    report = apply_vo_pretrained(depth, pose, config)
    _assert_equal(depth, depth_sd)
    _assert_equal(pose, pose_sd)
    jd, jp = (convert(_numpy(m.state_dict()))
              for convert, m in zip((convert_depthnet, convert_posenet), init_vo_models(8)))
    variables = {"params": {"depth": jd["params"], "pose": jp["params"]},
                 "batch_stats": {"depth": jd["batch_stats"], "pose": jp["batch_stats"]}}
    assert report == jax_apply_vo_pretrained(variables, config)[1]


def test_depthnet_resnet50_with_uncertainty_from_npz(tmp_path):
    """The encoder's depth is read off the tree: a ResNet-50 DepthNet with
    the uncertainty head through ``apply_depth_pretrained``."""
    want = _random_state_dict(DepthNet(50, predict_uncertainty=True), 3)
    variables = convert_depthnet(_numpy(want), 50)
    # convert_depthnet stops at dispconv_3; a JAX-trained tree with the
    # head holds it as uncconv_0 (flax kernels [kh, kw, I, O]).
    variables["params"]["decoder"]["uncconv_0"] = {"Conv_0": {
        "kernel": want["decoder.14.conv.weight"].numpy().transpose(2, 3, 1, 0),
        "bias": want["decoder.14.conv.bias"].numpy()}}
    save_variables_npz(str(tmp_path / "d50.npz"), variables)
    model = DepthNet(50, predict_uncertainty=True)
    report = apply_depth_pretrained(
        model, {"Train": {"pretrained_weights": {"depth": str(tmp_path / "d50.npz")}}})
    assert report == [f"pretrained depth net: {tmp_path / 'd50.npz'}"]
    _assert_equal(model, want)


def test_encoder_npz_loads_as_it_is(tmp_path):
    """A bare encoder ``.npz`` (``convert_resnet_encoder``'s tree, one input
    image) goes into the depth encoder unchanged, and fails on the pose
    encoder's 6-channel conv1, naming the file, as the JAX graft fails."""
    resnet = _random_state_dict(DepthNet().encoder.encoder, 4)
    path = str(tmp_path / "resnet18.x1.npz")
    save_variables_npz(path, convert_resnet_encoder(_numpy(resnet), 18, 1))
    model = init_depth_model(5)
    apply_depth_pretrained(model, {"Train": {"pretrained_encoder": path}})
    _assert_equal(model, resnet, prefix=_ENC)

    config = {"Train": {"pretrained_encoder": path}}
    with pytest.raises(ValueError, match=r"shape[\s\S]*resnet18\.x1\.npz|resnet18\.x1\.npz[\s\S]*shape"):
        apply_vo_pretrained(*init_vo_models(6), config)
    jd = convert_depthnet(_numpy(DepthNet().state_dict()))
    jp = convert_posenet(_numpy(PoseNet().state_dict()))
    variables = {"params": {"depth": jd["params"], "pose": jp["params"]},
                 "batch_stats": {"depth": jd["batch_stats"], "pose": jp["batch_stats"]}}
    with pytest.raises(ValueError, match="shape"):
        jax_apply_vo_pretrained(variables, config)


@pytest.mark.parametrize("small", [True, False])
def test_raft_loads_from_jax_npz_exactly(tmp_path, small):
    """SmallRAFT (no BatchNorm) and BasicRAFT (its batch-normed context
    encoder) ``.npz`` files through ``load_raft_state_dict``."""
    want = _random_state_dict(RAFT(small=small), 6)
    path = str(tmp_path / "raft.npz")
    save_variables_npz(path, convert_raft(_numpy(want), small))
    got = load_raft_state_dict(path, small=small)
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    assert sorted(keys) == sorted(k for k in got if not k.endswith("num_batches_tracked"))
    for k in keys:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises((KeyError, RuntimeError)):
        load_raft_state_dict(path, small=not small)


def test_mismatched_npz_raises(tmp_path):
    """A DepthNet file given as the pose network, and a DepthNet file with
    one misshapen kernel, raise ``ValueError`` naming the file."""
    depth_sd = _numpy(_random_state_dict(DepthNet(), 7))
    save_variables_npz(str(tmp_path / "depth.npz"), convert_depthnet(depth_sd))
    with pytest.raises(ValueError, match="depth.npz"):
        apply_vo_pretrained(*init_vo_models(8), {"Train": {"pretrained_weights": {
            "pose": str(tmp_path / "depth.npz")}}})
    bad = convert_depthnet(depth_sd)
    kernel = bad["params"]["decoder"]["dispconv_0"]["Conv_0"]["kernel"]
    bad["params"]["decoder"]["dispconv_0"]["Conv_0"]["kernel"] = kernel[:, :, :-1]
    save_variables_npz(str(tmp_path / "bad.npz"), bad)
    with pytest.raises(ValueError, match=r"shape[\s\S]*bad\.npz|bad\.npz[\s\S]*shape"):
        apply_depth_pretrained(init_depth_model(9), {"Train": {"pretrained_weights": {
            "depth": str(tmp_path / "bad.npz")}}})
