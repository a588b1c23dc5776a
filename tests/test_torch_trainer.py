"""The port's VO trainer, its checkpoint and the readers of it, on the CPU.

- Against JAX: the JAX package's ``Trainer(use_mesh=False)`` and the port's
  on the same config (a packed synthetic scene read as uint8, 64x96, B=2,
  fp32, mono, host and device jitter off, a synthetic stereo stream
  counted but not run), from the same weights and with the same auto-mask
  noise, run two steps of an epoch. Losses, the gradient and the weights
  after each step are held to ``tests/test_torch_train_step.py``'s
  tolerances (its helpers do the work; the port's weights are set to
  JAX's before the second step, so that each step starts from the same
  weights), and the learning rate of each update to optax's schedule over
  the same ``total_updates``, in which a stereo stream is counted. One JAX
  train step is compiled.
- Resume, port only: a run interrupted after a ``save_every_steps``
  checkpoint and resumed by a new ``Trainer`` equals the uninterrupted run
  exactly (atol 0), as ``tests/test_trainer.py`` asserts of the JAX
  trainer.
- The checkpoint's round trip, ``Networks.from_checkpoint``,
  ``apply_vo_pretrained`` against the JAX package's grafts, and the entry
  points ``pack_dataset``, ``train_vo`` and ``ba_ablation --vo_ckpt``
  (without a card, ``train_vo`` and ``from_checkpoint`` raise unless given
  the CPU).
"""

import functools
import json
import types

import jax
import numpy as np
import optax
import pytest
import torch
import yaml

from deep_visual_slam_tpu.models import DepthNet as JaxDepthNet
from deep_visual_slam_tpu.training import vo_trainer as jax_vo_trainer
from deep_visual_slam_tpu.utils.config import load_config as jax_load_config
from deep_visual_slam_tpu.utils.pretrained import apply_vo_pretrained as jax_apply_pretrained
from deep_visual_slam_tpu.utils.torch_weights import convert_depthnet, convert_posenet

from deep_visual_slam_torch import ba_ablation, pack_dataset, train_vo
from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.models.resnet import ResNetEncoder
from deep_visual_slam_torch.ops import disp_to_depth
from deep_visual_slam_torch.slam import Networks
from deep_visual_slam_torch.training import TrainState, init_vo_models
from deep_visual_slam_torch.training.vo_trainer import Trainer
from deep_visual_slam_torch.utils.checkpoint import (
    CheckpointManager,
    load_params_only,
    save_params_only,
)
from deep_visual_slam_torch.utils.config import load_config, save_config
from deep_visual_slam_torch.utils.pretrained import apply_vo_pretrained
from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

from test_torch_train_step import (
    MONO_NOISE,
    _assert_grads,
    _assert_losses,
    _assert_weights,
    _copy,
    _sync,
    _traced_with_noise,
)

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

H, W = 64, 96


def _overrides(root, **train):
    return {
        "Directory": {
            "exp_name": "t", "data_dir": f"{root}/data/", "log_dir": f"{root}/tb",
            "weights": f"{root}/weights", "results": f"{root}/results",
        },
        "Dataset": {"redwood": {"mono": False},
                    "packed": {"mono": True, "root": f"{root}/packed"},
                    "synthetic": {"stereo": True, "length": 4}},
        "Train": {"img_h": H, "img_w": W, "batch_size": 2, "epoch": 3, "valid_freq": 10,
                  "num_workers": 2, "compute_dtype": "float32", **train},
    }


def _pack(root, frames=10):
    """One packed train scene: ``frames`` - 6 snippets, B=2."""
    pack_dataset.pack_synthetic(f"{root}/packed", 1, frames, (H, W), device="cpu")


def test_trainer_steps_match_jax(tmp_path, monkeypatch):
    """Two mono steps of the first epoch. The data are packed uint8 scenes
    with the host jitter off (``uint8_h2d`` without ``device_augment``), so
    both trainers get the same batches bit for bit; a synthetic stereo
    stream is configured, and counted in ``total_updates``, but not run.
    The JAX trainer starts from the port's initial weights, carried over by
    the JAX package's ``convert_depthnet``/``convert_posenet`` (no JAX
    ``init`` is compiled), and builds the plain decoder that the port
    implements (``phase_fused=False``; ``tests/test_torch_models.py`` holds
    both JAX decoders to the port)."""
    _pack(tmp_path)
    depth, pose = init_vo_models(42)
    dv = convert_depthnet({k: v.numpy() for k, v in depth.state_dict().items()})
    pv = convert_posenet({k: v.numpy() for k, v in pose.state_dict().items()})
    variables = {"params": {"depth": dv["params"], "pose": pv["params"]},
                 "batch_stats": {"depth": dv["batch_stats"], "pose": pv["batch_stats"]}}
    monkeypatch.setattr(jax_vo_trainer, "init_vo_models", lambda *a, **k: variables)
    monkeypatch.setattr(jax_vo_trainer, "DepthNet",
                        functools.partial(JaxDepthNet, phase_fused=False))
    overrides = _overrides(tmp_path, uint8_h2d=True)
    jtr = jax_vo_trainer.Trainer(jax_load_config(overrides=overrides), use_mesh=False)
    tr = Trainer(load_config(overrides=overrides), device="cpu")
    # 2 mono and 2 stereo batches an epoch, over 3 epochs.
    assert tr.steps_per_epoch == jtr.steps_per_epoch == 2
    assert tr.total_updates == jtr.total_updates == 12
    for name, model in (("depth", tr.state.depth_model), ("pose", tr.state.pose_model)):
        want = jax.device_get(jtr.state.params[name])
        got = {"depth": convert_depthnet, "pose": convert_posenet}[name](
            {k: v.numpy() for k, v in model.state_dict().items()})["params"]
        jax.tree.map(np.testing.assert_array_equal, got, want)
    # Mono steps only: one JAX compile.
    jtr.stereo_step = tr.stereo_step = None

    jax_steps = []
    jax_step = jtr.train_step

    def record_jax(state, batch, rng):
        before = _copy(state)  # the step donates its state
        if jax_steps:
            state, losses = jax_step(state, batch, rng)
        else:
            state, losses = _traced_with_noise(
                pytest.MonkeyPatch.context, jax_step, MONO_NOISE, state, batch, rng
            )
        jax_steps.append((before, _copy(state), jax.device_get(losses)))
        return state, losses

    jtr.train_step = record_jax
    jtr.train_epoch(1)
    assert len(jax_steps) == 2

    schedule = optax.polynomial_schedule(1e-4, 0.0, 0.9, jtr.total_updates)
    port_step = tr.train_step
    port_steps = []

    def check_port(state, batch, generator):
        before, after, jlosses = jax_steps[len(port_steps)]
        if port_steps:
            _sync(state, before)
        losses = port_step(state, batch, noise=[torch.from_numpy(n) for n in MONO_NOISE])
        _assert_losses(losses, jlosses)
        _assert_grads(state, before, after)
        _assert_weights(state, after)
        lr = state.optimizer.param_groups[0]["lr"]
        np.testing.assert_allclose(lr, float(schedule(len(port_steps))), rtol=1e-6)
        port_steps.append(lr)
        return losses

    tr.train_step = check_port
    tr.train_epoch(1)
    assert len(port_steps) == 2 and tr.state.step == int(jtr.state.step) == 2
    assert port_steps[1] < port_steps[0] == 1e-4


def _resume_config(root):
    if not (root / "packed").exists():
        _pack(root, frames=12)
    return load_config(overrides=_overrides(root, epoch=1, save_every_steps=2,
                                            device_augment=True, uint8_h2d=True))


def _recorded(trainer, log, stop_at=None):
    """Record every mono and stereo step's losses; with ``stop_at``, the
    mono step of that number raises before it runs (a preemption)."""
    mono, stereo = trainer.train_step, trainer.stereo_step

    def train_step(state, batch, generator):
        if stop_at is not None and len([k for k, _ in log if k == "mono"]) + 1 == stop_at:
            raise KeyboardInterrupt
        losses = mono(state, batch, generator)
        log.append(("mono", {k: v.item() for k, v in losses.items()}))
        return losses

    def stereo_step(state, batch, generator):
        losses = stereo(state, batch, generator)
        log.append(("stereo", {k: v.item() for k, v in losses.items()}))
        return losses

    trainer.train_step, trainer.stereo_step = train_step, stereo_step


def test_mid_epoch_resume_matches_uninterrupted(tmp_path):
    """3 mono steps with a stereo step after each of the first two, device
    jitter and uint8 batches; saves every 2 mono steps. Interrupted in step
    3 and resumed, the run equals the uninterrupted one bit for bit."""
    full = []
    a = Trainer(_resume_config(tmp_path / "a"), device="cpu")
    assert (a.steps_per_epoch, a.total_updates) == (3, 5)
    _recorded(a, full)
    a.train()
    assert [k for k, _ in full] == ["mono", "stereo", "mono", "stereo", "mono"]

    part = []
    b = Trainer(_resume_config(tmp_path / "b"), device="cpu")
    _recorded(b, part, stop_at=3)
    with pytest.raises(KeyboardInterrupt):
        b.train()
    assert part == full[:4]

    rest = []
    c = Trainer(_resume_config(tmp_path / "b"), device="cpu")
    assert (c.start_epoch, c.resume_step_in_epoch, c.state.step) == (1, 2, 4)
    _recorded(c, rest)
    c.train()
    assert rest == full[4:]
    assert c.state.step == a.state.step == 5
    assert c.state.optimizer.param_groups[0]["lr"] == a.state.optimizer.param_groups[0]["lr"]
    assert torch.equal(c.generator.get_state(), a.generator.get_state())
    for name in ("depth_model", "pose_model"):
        ours, want = getattr(c.state, name).state_dict(), getattr(a.state, name).state_dict()
        for k, v in want.items():
            assert torch.equal(ours[k], v), k


def _tiny_state(seed):
    g = torch.Generator().manual_seed(seed)
    depth, pose = torch.nn.Linear(3, 2), torch.nn.Linear(2, 1)
    for p in [*depth.parameters(), *pose.parameters()]:
        torch.nn.init.normal_(p, generator=g)
    opt = torch.optim.Adam([*depth.parameters(), *pose.parameters()])
    return types.SimpleNamespace(depth_model=depth, pose_model=pose, optimizer=opt, step=0)


def test_checkpoint_manager_keeps_newest_and_restores(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=3)
    state = _tiny_state(0)
    for step in range(1, 6):
        state.depth_model(torch.ones(3)).sum().backward()
        state.optimizer.step()
        state.step = step
        mgr.save(step, state, metadata={"epoch": step, "generator": [1, 2, 3]})
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        f"ckpt_{s:08d}.pt" for s in (3, 4, 5)
    ]
    assert mgr.latest_step() == 5
    fresh = _tiny_state(1)
    fresh, meta, step = CheckpointManager(tmp_path / "ckpt").restore_latest(fresh)
    assert step == fresh.step == 5 and meta == {"epoch": 5, "generator": [1, 2, 3]}
    for a, b in zip(fresh.depth_model.parameters(), state.depth_model.parameters()):
        assert torch.equal(a, b)
    assert str(fresh.optimizer.state_dict()) == str(state.optimizer.state_dict())
    empty = _tiny_state(2)
    assert CheckpointManager(tmp_path / "none").restore_latest(empty) == (empty, None, None)

    weights = {"depth": state.depth_model.state_dict(), "pose": state.pose_model.state_dict()}
    save_params_only(weights, str(tmp_path / "export" / "weights.pt"))
    loaded = load_params_only(str(tmp_path / "export" / "weights.pt"))
    assert {k: set(v) for k, v in loaded.items()} == {k: set(v) for k, v in weights.items()}
    assert all(torch.equal(loaded["depth"][k], v) for k, v in weights["depth"].items())
    config = load_config(overrides={"Train": {"epoch": 2}})
    save_config(config, tmp_path / "cfg" / "vo.yaml")
    assert load_config(tmp_path / "cfg" / "vo.yaml") == config


@pytest.mark.parametrize("uncertainty", [False, True])
def test_networks_from_checkpoint(tmp_path, uncertainty):
    """The SLAM networks of a trainer checkpoint are the trainer's models:
    the same weights, the uncertainty head found from them, and the same
    depth and pose in eval mode."""
    depth, pose = init_vo_models(3, predict_uncertainty=uncertainty)
    with torch.no_grad():  # BatchNorm statistics away from 0 and 1
        for model in (depth, pose):
            for k, v in model.state_dict().items():
                if k.endswith(("running_mean", "running_var")):
                    v.uniform_(0.5, 1.5)
    state = TrainState.create(depth, pose, 1e-4, 10)
    CheckpointManager(tmp_path).save(7, state)
    nets = Networks.from_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    assert nets.predict_uncertainty is uncertainty
    for got, want in ((nets.depth_model, depth), (nets.pose_model, pose)):
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
    frames = np.random.default_rng(0).uniform(size=(2, H, W, 3)).astype(np.float32)
    depth.eval(), pose.eval()
    with torch.no_grad():
        disps = depth(torch.from_numpy(frames[1:]))
        want_depth = disp_to_depth(disps[("disp", 0)], 0.1, 10.0)[1][0, ..., 0]
        aa, t = pose(torch.from_numpy(np.concatenate(frames, -1)[None]))
    got_depth, T = nets.step(frames[0], frames[1])
    np.testing.assert_array_equal(got_depth, want_depth.numpy())
    np.testing.assert_allclose(T[:3, 3], t[0, 0, 0].double().numpy(), rtol=0, atol=1e-7)
    assert (nets.depth_unc(frames[1])[1] is not None) is uncertainty
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Networks.from_checkpoint(str(tmp_path / "empty"), device="cpu")


def _random_state_dict(module, seed, prefix=""):
    rng = np.random.default_rng(seed)
    return {
        prefix + k: (v if k.endswith("num_batches_tracked")
                     else torch.from_numpy(rng.normal(size=tuple(v.shape)).astype(np.float32)))
        for k, v in module.state_dict().items()
    }


def test_apply_vo_pretrained_matches_jax(tmp_path):
    """A torchvision-style ResNet-18 file (wrapped in ``state_dict``, with
    compile prefixes and a classifier) as the encoder, then full DepthNet
    and PoseNet files: the port's networks equal the JAX package's grafts
    carried across, bit for bit."""
    encoder = _random_state_dict(ResNetEncoder(18, 1).encoder, 1, "_orig_mod.")
    encoder["_orig_mod.fc.weight"] = torch.zeros(1000, 512)
    torch.save({"state_dict": encoder}, tmp_path / "resnet18.pth")
    depth, pose = init_vo_models(4)
    dv = convert_depthnet({k: v.numpy() for k, v in depth.state_dict().items()})
    pv = convert_posenet({k: v.numpy() for k, v in pose.state_dict().items()})
    variables = {"params": {"depth": dv["params"], "pose": pv["params"]},
                 "batch_stats": {"depth": dv["batch_stats"], "pose": pv["batch_stats"]}}

    for train in (
        {"pretrained_encoder": str(tmp_path / "resnet18.pth")},
        {"pretrained_weights": {"depth": str(tmp_path / "depth.pth")}},
    ):
        if "pretrained_weights" in train:
            torch.save(_random_state_dict(DepthNet(), 2), tmp_path / "depth.pth")
        report = apply_vo_pretrained(depth, pose, {"Train": train})
        variables, jreport = jax_apply_pretrained(variables, {"Train": train})
        assert report == jreport
        for model, name, to_torch in ((depth, "depth", depthnet_from_jax),
                                      (pose, "pose", posenet_from_jax)):
            want = to_torch({"params": variables["params"][name],
                             "batch_stats": variables["batch_stats"][name]})
            for k, v in want.items():
                if not k.endswith("num_batches_tracked"):
                    assert torch.equal(model.state_dict()[k], v), f"{name} {k}"

    torch.save(_random_state_dict(PoseNet(num_input_images=1), 3), tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="shape"):
        apply_vo_pretrained(depth, pose, {"Train": {"pretrained_weights": {
            "pose": str(tmp_path / "bad.pth")}}})


def test_entry_points(tmp_path):
    """Pack three synthetic scenes, train one epoch on them with validation
    through ``train_vo``, then run the BA ablation on the checkpoint."""
    packed = tmp_path / "packed"
    pack_dataset.main(["--synthetic", "3", "--frames", "10", "--size", str(H), str(W),
                       "--out", str(packed), "--generator", "mix", "--device", "cpu"])
    assert [len(list((packed / f).iterdir())) for f in ("train", "valid", "test")] == [1, 1, 1]
    cfg = _overrides(tmp_path, epoch=1, valid_freq=1)
    del cfg["Dataset"]["synthetic"]
    (tmp_path / "vo.yaml").write_text(yaml.safe_dump(cfg))
    train_vo.main(["--config", str(tmp_path / "vo.yaml"), "--device", "cpu"])
    log = [json.loads(line) for line in
           (tmp_path / "tb" / "t_ep1_bs2_lr0.0001_64x96" / "metrics.jsonl").open()]
    tags = {m["tag"]: m["value"] for m in log}
    assert np.isfinite(tags["train/loss"]) and np.isfinite(tags["valid/loss"])
    assert np.isfinite(tags["valid/ate_rmse"])

    ckpt = str(tmp_path / "weights" / "t_ep1_bs2_lr0.0001_64x96")
    out = tmp_path / "ablation.json"
    ba_ablation.main(["--vo_ckpt", ckpt, "--init", "net", "--frames", "8", "--size", str(H),
                      str(W), "--seeds", "100", "--device", "cpu", "--out_json", str(out)])
    record = json.loads(out.read_text())
    assert record["provenance"]["weights"] == ckpt
    for m in record["per_scene"]["100"].values():
        assert np.isfinite(m["ate_rmse"]) and np.isfinite(m["rpe_pos_mean"])

    if not torch.cuda.is_available():  # no fallback: the default device is CUDA
        with pytest.raises(RuntimeError, match="CUDA"):
            train_vo.main(["--config", str(tmp_path / "vo.yaml")])
        with pytest.raises(RuntimeError, match="CUDA"):
            Networks.from_checkpoint(ckpt)
