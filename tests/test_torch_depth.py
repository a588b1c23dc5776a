"""The port's supervised-depth path against the JAX package, on the CPU in
fp32 at 64x96 (the port-only resume at 64x64), B=2 to 4, the same numpy
inputs on both sides.

- ``ops/depth.py``, SILog with its gradient, ``multi_scale_loss`` and
  ``forward_step``: rtol 1e-5 on the elementwise work and the metrics
  (fp32 sums in other orders), 1e-4 where a network runs (XLA and PyTorch
  sum convolutions in other orders: ``tests/test_torch_models.py``).
- ``DepthMetrics`` streamed over three batches: rtol 1e-6 (the port sums in
  float64 on the device what JAX sums on the host).
- ``DepthSampleDataset``: the same generator draws the same flips and
  jitters; images within 1e-5 (the port's numpy HSV against cv2's,
  ``tests/test_torch_data.py``), depths and masks exact.
- ``apply_depth_pretrained`` against the JAX graft: bit for bit.
- The trainer: the JAX package's ``Trainer(use_mesh=False)`` reads an NYU
  tree written with cv2; the port's ``DepthLoader`` is handed datasets that
  the test's own cv2 reader decodes from the same files. The JAX trainer
  starts from the port's initial weights (carried by ``convert_depthnet``,
  the plain decoder as ``phase_fused=False``, no JAX ``init`` compiled); two
  steps and a validation are held to ``tests/test_torch_train_step.py``'s
  tolerances. One JAX train step is compiled.
- A resume at the epoch boundary equals the uninterrupted run exactly, and
  the entry points ``train_depth``/``eval_depth_cli`` run on ``tmp_path``.

The inputs have no ties (JAX and torch split a gradient at a tie
differently, ROADMAP.md §3).
"""

import glob
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from deep_visual_slam_tpu.data.base import DepthSampleDataset as JaxDepthSampleDataset
from deep_visual_slam_tpu.eval.metrics import DepthMetrics as JaxDepthMetrics
from deep_visual_slam_tpu.models import DepthNet as JaxDepthNet
from deep_visual_slam_tpu.ops import depth as jax_depth
from deep_visual_slam_tpu.training import depth_learner as jax_depth_learner
from deep_visual_slam_tpu.training import depth_trainer as jax_depth_trainer
from deep_visual_slam_tpu.utils.config import load_config as jax_load_config
from deep_visual_slam_tpu.utils.pretrained import apply_depth_pretrained as jax_apply_pretrained
from deep_visual_slam_tpu.utils.torch_weights import convert_depthnet

from deep_visual_slam_torch import eval_depth_cli, train_depth
from deep_visual_slam_torch.data import nyu
from deep_visual_slam_torch.data.base import DepthSampleDataset
from deep_visual_slam_torch.data.nyu import DepthLoader
from deep_visual_slam_torch.eval.metrics import DepthMetrics
from deep_visual_slam_torch.models import DepthNet
from deep_visual_slam_torch.models.resnet import ResNetEncoder
from deep_visual_slam_torch.ops import depth as port_depth
from deep_visual_slam_torch.ops.photometric import normalized_smooth_loss
from deep_visual_slam_torch.training import depth_learner
from deep_visual_slam_torch.training.depth_trainer import Trainer
from deep_visual_slam_torch.training.state import init_depth_model
from deep_visual_slam_torch.utils.checkpoint import save_params_only
from deep_visual_slam_torch.utils.config import load_config
from deep_visual_slam_torch.utils.pretrained import apply_depth_pretrained
from deep_visual_slam_torch.utils.weights import depthnet_from_jax

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

H, W = 64, 96
B1 = 0.9  # Adam's beta1 in configs/depth.yaml and both packages' defaults
GRAD_RTOL, GRAD_LEAF_RTOL = 1e-2, 1e-1


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _depth_pair(rng, shape):
    """Labels in [0.3, 9] m, predictions within a factor ~1.6 of them, and
    a mask of ~80% of the pixels."""
    gt = rng.uniform(0.3, 9.0, shape).astype(np.float32)
    pred = (gt * np.exp(rng.normal(0.0, 0.25, shape))).astype(np.float32)
    valid = rng.uniform(size=shape) < 0.8
    return gt, pred, valid


def test_depth_conversions_and_errors_match_jax(rng):
    gt, pred, valid = _depth_pair(rng, (2, H, W, 1))
    _close(port_depth.depth_to_disp(_t(gt), 0.1, 10.0),
           jax_depth.depth_to_disp(jnp.asarray(gt), 0.1, 10.0), 1e-6)
    scaled, depth = port_depth.disp_to_depth(port_depth.depth_to_disp(_t(gt), 0.1, 10.0),
                                             0.1, 10.0)
    _close(depth, gt, 1e-5)
    for got, want in (
        (port_depth.compute_depth_errors(_t(gt[valid]), _t(pred[valid])),
         jax_depth.compute_depth_errors(jnp.asarray(gt[valid]), jnp.asarray(pred[valid]))),
        (port_depth.masked_depth_errors(_t(gt), _t(pred), _t(valid)),
         jax_depth.masked_depth_errors(jnp.asarray(gt), jnp.asarray(pred), jnp.asarray(valid))),
    ):
        assert set(got) == set(want) == {"abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2",
                                         "a3"}
        for k in want:
            assert got[k].dtype == torch.float32
            _close(got[k], want[k], 1e-5, what=k)
    masked = port_depth.masked_depth_errors(_t(gt), _t(pred), _t(valid))
    gathered = port_depth.compute_depth_errors(_t(gt[valid]), _t(pred[valid]))
    for k in gathered:
        _close(masked[k], gathered[k], 1e-5, what=k)


def test_silog_loss_and_gradient_match_jax(rng):
    """The value and d/dpred with invalid pixels (some with zero labels) and
    predictions under the 1e-6 floor; bf16 predictions are taken in fp32;
    a perfect prediction sits on the ``max(silog, 1e-6)`` floor (1e-3)."""
    gt, pred, valid = _depth_pair(rng, (2, H, W, 1))
    gt[~valid & (rng.uniform(size=gt.shape) < 0.5)] = 0.0
    pred[~valid & (rng.uniform(size=gt.shape) < 0.2)] = 1e-8
    for focus in (0.85, 0.5):
        p = _t(pred).requires_grad_()
        loss = port_depth.silog_loss(p, _t(gt), _t(valid), focus)
        loss.backward()
        jloss, jgrad = jax.value_and_grad(jax_depth.silog_loss)(
            jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(valid), focus)
        _close(loss.item(), jloss, 1e-5)
        _close(p.grad, jgrad, 1e-5, atol=1e-5 * np.abs(np.asarray(jgrad)).max())
        assert not p.grad[~_t(valid)].any()
    bf16 = port_depth.silog_loss(_t(pred).bfloat16(), _t(gt), _t(valid))
    want = jax_depth.silog_loss(jnp.asarray(pred, jnp.bfloat16), jnp.asarray(gt),
                                jnp.asarray(valid))
    assert bf16.dtype == torch.float32
    _close(bf16.item(), want, 1e-5)
    assert port_depth.silog_loss(_t(gt), _t(gt), _t(valid)).item() == pytest.approx(1e-3)


def _randomized_depthnet(seed):
    """A ResNet-18 DepthNet with BatchNorm statistics and affine terms drawn
    from ``seed``."""
    net = DepthNet(generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            if k.endswith(("running_var", "bn1.weight", "bn2.weight")):
                v.copy_(_t(rng.uniform(0.5, 1.5, v.shape).astype(np.float32)))
            elif k.endswith(("running_mean", "bn1.bias", "bn2.bias")):
                v.copy_(_t(rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)))
    return net


def test_multi_scale_loss_and_forward_step_match_jax(rng):
    """``forward_step`` in eval mode through the same DepthNet weights, and
    ``multi_scale_loss`` on given depths. The smoothness normalisation is
    the depth one (``depth / max(mean, 1e-7)``), not the VO one, which
    differs at means below 1e-3."""
    cfg = depth_learner.DepthLossConfig(smooth_weight=0.3, silog_weight=0.7)
    jcfg = jax_depth_learner.DepthLossConfig(smooth_weight=0.3, silog_weight=0.7)
    image = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    gt, _, valid = _depth_pair(rng, (2, H, W))  # [B, H, W]: forward_step adds the axis
    preds = [rng.uniform(0.2, 8.0, (2, H >> s, W >> s, 1)).astype(np.float32) for s in range(4)]
    got = depth_learner.multi_scale_loss([_t(p) for p in preds], _t(gt[..., None]), _t(image),
                                         _t(valid[..., None]), cfg)
    want = jax_depth_learner.multi_scale_loss(
        [jnp.asarray(p) for p in preds], jnp.asarray(gt[..., None]), jnp.asarray(image),
        jnp.asarray(valid[..., None]), jcfg)
    for a, b in zip(got, want):
        _close(a.item(), b, 1e-5)
    small = preds[0] * 1e-4
    _close(depth_learner._normalized_smooth(_t(small), _t(image)).item(),
           jax_depth_learner._normalized_smooth(jnp.asarray(small), jnp.asarray(image)), 1e-5)
    assert not np.isclose(depth_learner._normalized_smooth(_t(small), _t(image)).item(),
                          normalized_smooth_loss(_t(small), _t(image)).item(), rtol=1e-2)

    net = _randomized_depthnet(3).eval()
    variables = convert_depthnet({k: v.numpy() for k, v in net.state_dict().items()})
    sample = {"image": image, "depth": gt, "valid_mask": valid}
    with torch.no_grad():
        total, losses, depths = depth_learner.forward_step(
            net, {k: _t(v) for k, v in sample.items()}, cfg)
    model = JaxDepthNet(phase_fused=False)
    jtotal, jlosses, jdepths = jax.jit(lambda v, s: jax_depth_learner.forward_step(
        lambda _, x, train: model.apply(v, x, train=train), None, s, jcfg))(
        variables, {k: jnp.asarray(v) for k, v in sample.items()})
    assert set(losses) == set(jlosses) == {"loss", "silog", "smooth"}
    assert losses["loss"] is total
    for k in jlosses:
        _close(losses[k].item(), jlosses[k], 1e-4, what=k)
    for s, (a, b) in enumerate(zip(depths, jdepths)):
        assert a.shape == b.shape == (2, H >> s, W >> s, 1)
        _close(a, b, 1e-4, what=f"depth {s}")


def test_depth_metrics_streamed_match_jax(rng):
    """Three batches, labels partly outside (0.1, 10), predictions partly
    outside the clip range, an extra mask on one batch."""
    port, jax_metrics = DepthMetrics(0.1, 10.0), JaxDepthMetrics(0.1, 10.0)
    for i in range(3):
        gt = rng.uniform(0.05, 11.0, (2 + i, H, W, 1)).astype(np.float32)
        pred = (gt * np.exp(rng.normal(0.0, 0.3, gt.shape))).astype(np.float32)
        mask = rng.uniform(size=gt.shape) < 0.7 if i == 1 else None
        port.update(_t(pred), _t(gt), None if mask is None else _t(mask))
        jax_metrics.update(pred, gt, mask)
    assert port._sums.dtype == torch.float64
    got, want = port.result(), jax_metrics.result()
    assert list(got) == list(want)
    for k in want:
        _close(got[k], want[k], 1e-6, what=k)
    port.reset()
    assert port.result() == JaxDepthMetrics().result()


def _write_nyu_split(split_dir, n, seed):
    """``n`` pairs of an RGB PNG and a 16-bit depth PNG (mm: labels in 0.15
    to 0.40 m, about the random network's 0.2 m, and ~5% zeros) under
    ``split_dir/{rgb,depth}``."""
    rng = np.random.default_rng(seed)
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(split_dir, sub), exist_ok=True)
    for i in range(n):
        rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        depth = rng.integers(150, 400, (H, W)).astype(np.uint16)
        depth[rng.uniform(size=(H, W)) < 0.05] = 0
        cv2.imwrite(os.path.join(split_dir, "rgb", f"{i:03d}.png"), rgb[..., ::-1])
        cv2.imwrite(os.path.join(split_dir, "depth", f"{i:03d}.png"), depth)


class Cv2DepthDataset(DepthSampleDataset):
    """The test's own reader of the files ``_write_nyu_split`` wrote, as the
    JAX package decodes them (cv2, BGR -> RGB, /255; depth unchanged)."""

    def __init__(self, split_dir, is_train):
        self.rgbs = sorted(glob.glob(os.path.join(split_dir, "rgb", "*")))
        self.depths = sorted(glob.glob(os.path.join(split_dir, "depth", "*")))
        super().__init__(len(self.rgbs), (H, W), 10.0, is_train, is_train, 1000.0)

    def _load(self, idx):
        img = cv2.cvtColor(cv2.imread(self.rgbs[idx], cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
        return img.astype(np.float32) / 255.0, cv2.imread(self.depths[idx], cv2.IMREAD_UNCHANGED)


def test_depth_sample_dataset_matches_jax(tmp_path):
    """The same generator seed on both sides: the same flip and jitter
    draws in JAX's order (all four combinations occur), the same depth in
    metres and mask, and both generators left in the same state."""
    split = str(tmp_path / "train")
    _write_nyu_split(split, 2, 0)
    port = Cv2DepthDataset(split, is_train=True)
    ref = JaxDepthSampleDataset(port.rgbs, port.depths, (H, W), max_depth=0.3)
    port.max_depth = 0.3  # some labels above the mask's limit
    seen = set()
    for idx in range(2):
        for seed in range(12):
            rng_p, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
            draws = np.random.default_rng(seed).uniform(size=2) < 0.5
            got, want = port.__getitem__(idx, rng_p), ref.__getitem__(idx, rng_j)
            seen.add(tuple(draws))
            assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
                k: (v.shape, v.dtype) for k, v in want.items()}
            np.testing.assert_allclose(got["image"], want["image"], rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got["depth"], want["depth"])
            np.testing.assert_array_equal(got["valid_mask"], want["valid_mask"])
            assert rng_p.uniform() == rng_j.uniform()
    assert seen == {(False, False), (False, True), (True, False), (True, True)}
    evaluation = Cv2DepthDataset(split, is_train=False)
    assert not evaluation.augment
    sample = evaluation[1]
    assert sample["depth"].max() <= 0.4 and sample["valid_mask"].mean() > 0.9
    with pytest.raises(NotImplementedError, match="1f"):
        DepthSampleDataset(1, (H, W))[0]


def _random_state_dict(module, seed, prefix=""):
    rng = np.random.default_rng(seed)
    return {
        prefix + k: (v if k.endswith("num_batches_tracked")
                     else _t(rng.normal(size=tuple(v.shape)).astype(np.float32)))
        for k, v in module.state_dict().items()
    }


def test_apply_depth_pretrained_matches_jax(tmp_path):
    """A torchvision-style ResNet-18 file (wrapped in ``state_dict``, with
    compile prefixes and a classifier) as the encoder, then a full DepthNet
    file: the port's network equals the JAX graft carried across, bit for
    bit; a file with a tensor of the wrong shape, or one missing, is
    refused."""
    encoder = _random_state_dict(ResNetEncoder(18, 1).encoder, 1, "_orig_mod.")
    encoder["_orig_mod.fc.weight"] = torch.zeros(1000, 512)
    torch.save({"state_dict": encoder}, tmp_path / "resnet18.pth")
    torch.save(_random_state_dict(DepthNet(), 2), tmp_path / "depth.pth")
    depth = init_depth_model(4)
    dv = convert_depthnet({k: v.numpy() for k, v in depth.state_dict().items()})
    variables = {"params": {"depth": dv["params"]}, "batch_stats": {"depth": dv["batch_stats"]}}
    for train in (
        {"pretrained_encoder": str(tmp_path / "resnet18.pth")},
        {"pretrained_weights": {"depth": str(tmp_path / "depth.pth"), "pose": "ignored"}},
    ):
        report = apply_depth_pretrained(depth, {"Train": train})
        variables, jreport = jax_apply_pretrained(variables, {"Train": train})
        assert report == jreport
        want = depthnet_from_jax({"params": variables["params"]["depth"],
                                  "batch_stats": variables["batch_stats"]["depth"]})
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(depth.state_dict()[k], v), k
    bad = dict(depth.state_dict())
    bad["decoder.10.conv.weight"] = torch.zeros(1, 16, 1, 1)
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape"):
        apply_depth_pretrained(depth, {"Train": {"pretrained_weights": {
            "depth": str(tmp_path / "bad.pth")}}})
    del bad["decoder.10.conv.weight"]
    torch.save(bad, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="does not match"):
        apply_depth_pretrained(depth, {"Train": {"pretrained_weights": {
            "depth": str(tmp_path / "bad.pth")}}})


def _overrides(root, **train):
    return {
        "Directory": {"exp_name": "d", "data_dir": f"{root}/data", "log_dir": f"{root}/tb",
                      "weights": f"{root}/weights", "results": f"{root}/results"},
        "Dataset": {"nyu_depth_v2": True, "redwood_depth": False},
        "Train": {"img_h": H, "img_w": W, "batch_size": 2, "epoch": 2, "valid_freq": 1,
                  "num_workers": 2, "compute_dtype": "float32", "weight_decay": 1e-5,
                  "smooth_weight": 0.1, "silog_weight": 1.0, **train},
    }


def _nyu_tree(root, train=4, test=2):
    nyu_root = root / "data" / "nyu_depth_v2"
    _write_nyu_split(str(nyu_root / "train"), train, 10)
    _write_nyu_split(str(nyu_root / "test"), test, 11)
    return nyu_root


def _state_dict_of(jstate):
    return depthnet_from_jax({"params": jax.device_get(jstate.params["depth"]),
                              "batch_stats": jax.device_get(jstate.batch_stats["depth"])})


def test_depth_trainer_matches_jax(tmp_path, monkeypatch):
    """Two steps of epoch 1, then a validation from the same weights."""
    nyu_root = _nyu_tree(tmp_path)
    overrides = _overrides(tmp_path)
    depth = init_depth_model(42)
    variables = convert_depthnet({k: v.numpy() for k, v in depth.state_dict().items()})

    class FromPort:
        """JAX's DepthNet (plain decoder) whose ``init`` hands out the
        port's initial weights."""

        def __init__(self, dtype):
            self.model = JaxDepthNet(dtype=dtype, phase_fused=False)

        def init(self, *args):
            return variables

        def apply(self, *args, **kwargs):
            return self.model.apply(*args, **kwargs)

    monkeypatch.setattr(jax_depth_trainer, "DepthNet", FromPort)
    jtr = jax_depth_trainer.Trainer(jax_load_config(overrides=overrides), use_mesh=False)
    loader = DepthLoader(load_config(overrides=overrides),
                         Cv2DepthDataset(str(nyu_root / "train"), True),
                         Cv2DepthDataset(str(nyu_root / "test"), False))
    tr = Trainer(load_config(overrides=overrides), device="cpu", data_loader=loader)
    assert len(jtr.data_loader.train_loader) == tr.steps_per_epoch == 2
    for k, v in _state_dict_of(jtr.state).items():
        assert torch.equal(tr.state.depth_model.state_dict()[k], v), k

    jax_steps = []
    jax_step = jtr.train_step

    def record_jax(state, batch, rng):
        before = jax.tree.map(jnp.copy, state)  # the step donates its state
        state, losses = jax_step(state, batch, rng)
        jax_steps.append((before, jax.tree.map(jnp.copy, state), jax.device_get(losses)))
        return state, losses

    jtr.train_step = record_jax
    jtr.train_epoch(1)
    assert len(jax_steps) == 2

    schedule = optax.polynomial_schedule(1e-4, 0.0, 0.9, 2 * 2)
    port_step = tr.train_step
    lrs = []

    def check_port(state, batch):
        before, after, jlosses = jax_steps[len(lrs)]
        if lrs:  # start from JAX's weights
            _load(state.depth_model, _state_dict_of(before))
        losses = port_step(state, batch)
        assert set(losses) == set(jlosses) == {"loss", "silog", "smooth"}
        for k in jlosses:
            _close(losses[k].item(), jlosses[k], 1e-4, what=k)
        _assert_grads(state.depth_model, before, after)
        _assert_weights(state.depth_model, after)
        lrs.append(state.optimizer.param_groups[0]["lr"])
        _close(lrs[-1], schedule(len(lrs) - 1), 1e-6)
        return losses

    tr.train_step = check_port
    tr.train_epoch(1)
    assert len(lrs) == 2 and tr.state.step == int(jtr.state.step) == 2

    _load(tr.state.depth_model, _state_dict_of(jtr.state))
    got, want = tr.validate(1), jtr.validate(1)
    assert set(got) == set(want) and len(got) == 10
    assert 0.0 < want["valid/delta1"] < 1.0
    for k in want:
        _close(got[k], want[k], 1e-4, what=k)


def _load(model, state_dict):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                v.copy_(state_dict[k])


def _assert_grads(model, before, after):
    """The port's ``.grad`` against JAX's gradient, read from the first Adam
    moment (``mu' = b1 mu + (1 - b1) g``; optax's weight decay comes after
    it), as a whole within 1e-2 and leaf by leaf within 1e-1 of the 2-norm
    (``tests/test_torch_train_step.py``)."""
    g = jax.tree.map(lambda m1, m0: (np.asarray(m1) - B1 * np.asarray(m0)) / (1 - B1),
                     after.opt_state[0].mu["depth"], before.opt_state[0].mu["depth"])
    want = depthnet_from_jax({"params": g,
                              "batch_stats": jax.device_get(after.batch_stats["depth"])})
    sq_err = sq_want = 0.0
    for k, p in model.named_parameters():
        err = np.linalg.norm(p.grad.numpy() - want[k].numpy())
        scale = np.linalg.norm(want[k].numpy())
        assert err <= GRAD_LEAF_RTOL * scale, f"gradient of {k}: {err:.2e} of {scale:.2e}"
        sq_err, sq_want = sq_err + err**2, sq_want + scale**2
    assert np.sqrt(sq_err / sq_want) <= GRAD_RTOL


def _assert_weights(model, jstate):
    """Parameters atol 2.5e-4 (a first Adam step moves each by at most lr),
    BatchNorm statistics rtol 1e-4 with atol 1e-5."""
    got = model.state_dict()
    for k, v in _state_dict_of(jstate).items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = (dict(rtol=1e-4, atol=1e-5) if k.endswith(("running_mean", "running_var"))
               else dict(rtol=0, atol=2.5e-4))
        _close(got[k], v, what=k, **tol)


class MemoryDepthDataset(DepthSampleDataset):
    """``n`` samples at 64x64 from a pool of 3 random ones, indexed modulo."""

    def __init__(self, n, is_train, seed):
        super().__init__(n, (64, 64), 10.0, is_train, is_train)
        rng = np.random.default_rng(seed)
        self.images = rng.uniform(size=(3, 64, 64, 3)).astype(np.float32)
        self.depths = rng.integers(150, 400, (3, 64, 64)).astype(np.uint16)

    def _load(self, idx):
        return self.images[idx % 3], self.depths[idx % 3]


def _memory_trainer(root):
    config = load_config(overrides=_overrides(root, img_h=64, img_w=64))
    loader = DepthLoader(config, MemoryDepthDataset(4, True, 0), MemoryDepthDataset(2, False, 1))
    return Trainer(config, device="cpu", data_loader=loader)


def test_depth_trainer_resumes_at_epoch_boundary(tmp_path):
    """A run stopped after its first epoch's checkpoint and resumed by a new
    ``Trainer`` equals the uninterrupted run bit for bit: the losses of
    epoch 2, the weights, the optimizer state and the validation."""

    def run(trainer, log, stop_at=None):
        step = trainer.train_step

        def recorded(state, batch):
            if stop_at is not None and len(log) == stop_at:
                raise KeyboardInterrupt
            losses = step(state, batch)
            log.append({k: v.item() for k, v in losses.items()})
            return losses

        trainer.train_step = recorded
        trainer.train()

    full, part, rest = [], [], []
    a = _memory_trainer(tmp_path / "a")
    run(a, full)
    assert len(full) == 4 and a.state.step == 4
    b = _memory_trainer(tmp_path / "b")
    with pytest.raises(KeyboardInterrupt):
        run(b, part, stop_at=2)
    c = _memory_trainer(tmp_path / "b")
    assert (c.start_epoch, c.state.step) == (2, 2)
    run(c, rest)
    assert part + rest == full
    for k, v in a.state.depth_model.state_dict().items():
        assert torch.equal(c.state.depth_model.state_dict()[k], v), k
    assert str(c.state.optimizer.state_dict()) == str(a.state.optimizer.state_dict())
    assert c.validate(2) == a.validate(2)


def test_depth_entry_points(tmp_path, monkeypatch):
    """``train_depth`` and ``eval_depth_cli`` on an NYU tree under
    ``tmp_path``: the file sources raise ``NotImplementedError`` (no image
    decoder yet), the card is the default device, and with the test's cv2
    reader in place of the sources they train, checkpoint and write JAX's
    CSV columns with the validation's metrics, from the checkpoint
    directory and from a params-only file alike."""
    _nyu_tree(tmp_path, train=2, test=2)
    cfg_path = tmp_path / "depth.yaml"
    cfg_path.write_text(yaml.safe_dump(_overrides(tmp_path, epoch=1)))
    csv_path = tmp_path / "out" / "eval.csv"
    for main, args in ((train_depth.main, []),
                       (eval_depth_cli.main, ["--output", str(csv_path)])):
        with pytest.raises(NotImplementedError, match="1f"):
            main(["--config", str(cfg_path), "--device", "cpu", *args])
        if not torch.cuda.is_available():  # no fallback: the default device is CUDA
            with pytest.raises(RuntimeError, match="CUDA"):
                main(["--config", str(cfg_path), *args])

    monkeypatch.setattr(nyu, "nyu_dataset",
                        lambda root, split, size, max_depth, is_train:
                        Cv2DepthDataset(os.path.join(root, split), is_train))
    train_depth.main(["--config", str(cfg_path), "--device", "cpu"])
    exp = "depth_d_ep1_bs2_lr0.0001_64x96"
    log = [json.loads(line) for line in (tmp_path / "tb" / exp / "metrics.jsonl").open()]
    tags = {m["tag"]: m["value"] for m in log}
    assert np.isfinite(tags["train/loss"]) and np.isfinite(tags["valid/abs_rel"])
    ckpt = tmp_path / "weights" / exp
    model = init_depth_model(0)
    eval_depth_cli.load_depth_weights(model, str(ckpt))
    save_params_only({"depth": model.state_dict()}, str(tmp_path / "params.pt"))
    header = ["samples"] + list(JaxDepthMetrics().result())
    for weights in (str(ckpt), str(tmp_path / "params.pt")):
        eval_depth_cli.main(["--config", str(cfg_path), "--weights", weights, "--output",
                             str(csv_path), "--device", "cpu"])
        lines = csv_path.read_text().splitlines()
        assert lines[0].split(",") == header and len(lines) == 2
        row = dict(zip(header, map(float, lines[1].split(","))))
        assert row["samples"] == 2
        for k in header[1:]:
            assert row[k] == tags[f"valid/{k}"], k
