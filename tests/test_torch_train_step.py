"""The port's VO train step and stereo train step against the JAX package,
end to end on the CPU in fp32 at 64x96, two rows per microbatch.

Both packages start from the same weights (a JAX ``init`` carried across),
the same ``synthetic_vo_batch`` / stereo batch and the same auto-mask
tie-break noise: the JAX step draws it from ``jax.random.normal``, which the
test replaces while the step is traced by a function that hands out the
numpy draws the port receives as ``noise``. The JAX steps are compiled once
per configuration and shared through a module-scoped fixture; the noise is
baked into each compiled step, so every call of one step sees the same draws.
(Under ``accum_steps=2`` the JAX microbatch loop is a ``lax.scan`` traced
once, so both microbatches take the same draws; the port is handed them
twice over.) With ``accum_steps=2`` the batch has four rows, so that each
microbatch holds two, as the other steps' batches do.

What is compared, and the tolerances:

- The gradient. optax keeps none, but its first Adam moment moves as
  ``mu' = b1 mu + (1 - b1) g``, which gives JAX's ``g``; the port leaves
  its own in ``.grad``. The whole must agree within 1e-2 of its 2-norm and
  each leaf within 1e-1 of its own: a wrong gradient on any one leaf
  (negated, zeroed, another leaf's) is off by 1 or more. Measured: the
  whole within 4.3e-3, the worst leaf within 2.5e-2. The gap is not
  rounding spread evenly: fp32 rounding decides near-ties, one pixel or
  channel at a time, and each decision moves the gradient by a step. The
  auto-mask ``min`` has pairs whose margin is below 1e-6, and nearly
  constant BatchNorm channels sit at a ReLU's kink; a relative perturbation
  of 1e-7 of the port's own weights moves its gradient by 1.8e-3 and its
  worst leaf's largest entry by up to 1.5%. At one row per microbatch
  (``layer4`` then normalizes six values per channel) that reached 22% of a
  leaf, hence two rows.
- Losses rtol 1e-4 (measured within 1e-5: the networks agree to ~1e-5,
  the rest is fp32 elementwise work) and ``grad_norm`` rtol 1e-3 (measured
  within 4.2e-4). The stereo test's third step differs by 2.0e-3 in
  ``grad_norm``, from the same near-ties: there the coarsest scale warps by
  under 0.4 pixel, so its reprojection nearly ties with the identity map,
  and a 1e-7 relative perturbation of the port's own weights moves its
  ``grad_norm`` by 1.1e-3. It is held there to rtol 5e-3.
- Parameters after the update atol 2.5e-4 and BatchNorm running statistics
  rtol 1e-4 with atol 1e-5 (means near 0). A first Adam step moves each
  weight by at most lr (1e-4), so the parameter check shows that the update
  was applied, not that the gradients agree: that is the gradient check's
  work. Where steps follow one another, the port is given JAX's weights
  after each step, so that each step starts from the same weights.

The inputs have no exact ties. JAX and torch differ there by design, and
the port keeps torch's rule: at a clip bound JAX's gradient is 0.5 and
torch's 1, and at a ``min`` tie JAX splits the gradient where torch gives
it to one index.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.data.synthetic import SyntheticStereoDataset
from deep_visual_slam_tpu.data.synthetic import synthetic_vo_batch as jax_vo_batch
from deep_visual_slam_tpu.models import DepthNet as JaxDepthNet
from deep_visual_slam_tpu.models import PoseNet as JaxPoseNet
from deep_visual_slam_tpu.training import state as jax_state
from deep_visual_slam_tpu.training import steps as jax_steps
from deep_visual_slam_tpu.training import vo_learner as jax_vo_learner

from deep_visual_slam_torch.data import synthetic_stereo_batch
from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.ops import photometric_cuda
from deep_visual_slam_torch.training import (
    TrainState,
    VOLossConfig,
    make_stereo_train_step,
    make_vo_train_step,
)
from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

from test_torch_models import H, W, jax_variables

# One thread per test process: the tests run beside others, and torch's
# default of one thread per core then spends its time waiting for cores.
torch.set_num_threads(1)

B = 2  # rows per microbatch
LR, TOTAL_STEPS = 1e-4, 10
B1 = 0.9  # Adam's beta1 in both packages' defaults
GRAD_RTOL, GRAD_LEAF_RTOL = 1e-2, 1e-1
MONO_NOISE = np.random.default_rng(5).standard_normal((4, B, H, W, 2)).astype(np.float32)
STEREO_NOISE = np.random.default_rng(6).standard_normal((4, B, H, W, 1)).astype(np.float32)


def _traced_with_noise(monkeypatch_ctx, fn, draws, *args):
    """Calls ``fn`` (a jitted step, traced at this first call) with
    ``jax.random.normal`` handing out ``draws`` in order; all must go."""
    queue = [jnp.asarray(d) for d in draws]
    with monkeypatch_ctx() as mp:
        mp.setattr(jax.random, "normal", lambda key, shape, *a, **k: queue.pop(0))
        out = fn(*args)
    assert not queue, f"{len(queue)} noise draws left"
    return out


def _copy(tree):
    """The JAX steps donate their state: hand each call its own copy."""
    return jax.tree.map(jnp.copy, tree)


class JaxSteps:
    """The JAX steps, compiled at first use per configuration. Each call
    takes a copy of the state it is given, which stays valid."""

    def __init__(self):
        self._mono, self._stereo = {}, None

    def mono(self, uncertainty, accum_steps, state, batch):
        key = (uncertainty, accum_steps)
        if key not in self._mono:
            step = jax_steps.make_vo_train_step(
                JaxDepthNet(phase_fused=False, predict_uncertainty=uncertainty),
                JaxPoseNet(), jax_vo_learner.VOLossConfig(uncertainty=uncertainty),
                accum_steps=accum_steps,
            )
            out = _traced_with_noise(
                pytest.MonkeyPatch.context, step, MONO_NOISE, _copy(state), batch,
                jax.random.PRNGKey(0),
            )
            self._mono[key] = step
            return out
        return self._mono[key](_copy(state), batch, jax.random.PRNGKey(0))

    def stereo(self, state, batch):
        if self._stereo is None:
            step = jax_steps.make_stereo_train_step(
                JaxDepthNet(phase_fused=False), jax_vo_learner.VOLossConfig()
            )
            out = _traced_with_noise(
                pytest.MonkeyPatch.context, step, STEREO_NOISE, _copy(state), batch,
                jax.random.PRNGKey(0),
            )
            self._stereo = step
            return out
        return self._stereo(_copy(state), batch, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def jax_train_steps():
    return JaxSteps()


@functools.lru_cache(maxsize=None)
def _mono_batch(rows):
    batch, _ = jax_vo_batch(0, rows, H, W)
    return {k: np.array(v) for k, v in batch.items()}


def _start(uncertainty=False):
    """The same initial weights in a JAX TrainState and in the port's."""
    dv = jax_variables("depth", predict_uncertainty=uncertainty)
    pv = jax_variables("pose")
    jstate = jax_state.TrainState.create(
        params={"depth": dv["params"], "pose": pv["params"]},
        batch_stats={"depth": dv["batch_stats"], "pose": pv["batch_stats"]},
        tx=jax_state.make_optimizer(LR, TOTAL_STEPS),
    )
    depth_net = DepthNet(predict_uncertainty=uncertainty)
    depth_net.load_state_dict(depthnet_from_jax(dv))
    pose_net = PoseNet()
    pose_net.load_state_dict(posenet_from_jax(pv))
    return jstate, TrainState.create(depth_net, pose_net, LR, TOTAL_STEPS)


def _assert_losses(losses, jlosses, grad_norm_rtol=1e-3):
    assert set(losses) == set(jlosses)
    for k in jlosses:
        rtol = grad_norm_rtol if k == "grad_norm" else 1e-4
        np.testing.assert_allclose(
            losses[k].item(), float(jlosses[k]), rtol=rtol, err_msg=k
        )


def _jax_grads(before, after):
    """JAX's gradient of the update from ``before`` to ``after`` as the
    port's state_dict entries of both networks, from the first Adam moment:
    ``mu' = b1 mu + (1 - b1) g``."""
    mu, mu_next = before.opt_state[0].mu, after.opt_state[0].mu
    grads = {}
    for name, to_torch in (("depth", depthnet_from_jax), ("pose", posenet_from_jax)):
        g = jax.tree.map(
            lambda m1, m0: (np.asarray(m1) - B1 * np.asarray(m0)) / (1 - B1),
            mu_next[name], mu[name],
        )
        grads[name] = to_torch(
            {"params": g, "batch_stats": jax.device_get(after.batch_stats[name])}
        )
    return grads


def _assert_grads(state, before, after, networks=("depth", "pose")):
    """The gradient the port's step left in ``.grad`` against JAX's, as a
    whole and leaf by leaf, in the 2-norm."""
    want = _jax_grads(before, after)
    sq_err = sq_want = 0.0
    for name, model in (("depth", state.depth_model), ("pose", state.pose_model)):
        if name not in networks:
            continue
        for k, p in model.named_parameters():
            got, w = p.grad.numpy(), want[name][k].numpy()
            err, scale = np.linalg.norm(got - w), np.linalg.norm(w)
            assert err <= GRAD_LEAF_RTOL * scale, (
                f"gradient of {name}.{k}: {err:.2e} > {GRAD_LEAF_RTOL} x {scale:.2e}"
            )
            sq_err += err**2
            sq_want += scale**2
    rel = np.sqrt(sq_err / sq_want)
    assert rel <= GRAD_RTOL, f"gradient off by {rel:.2e} of its 2-norm"


def _assert_weights(state, jstate):
    """Parameters and BatchNorm statistics of both networks."""
    for name, model, to_torch in (
        ("depth", state.depth_model, depthnet_from_jax),
        ("pose", state.pose_model, posenet_from_jax),
    ):
        expect = to_torch({
            "params": jax.device_get(jstate.params[name]),
            "batch_stats": jax.device_get(jstate.batch_stats[name]),
        })
        got = model.state_dict()
        assert set(expect) == set(got)
        for k, v in expect.items():
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                tol = dict(rtol=1e-4, atol=1e-5)
            else:
                tol = dict(rtol=0, atol=2.5e-4)
            np.testing.assert_allclose(
                got[k].numpy(), v.numpy(), err_msg=f"{name} {k}", **tol
            )


def _sync(state, jstate):
    """The port's weights and BatchNorm statistics set to JAX's (the Adam
    moments and counts stay the port's own)."""
    with torch.no_grad():
        for name, model, to_torch in (
            ("depth", state.depth_model, depthnet_from_jax),
            ("pose", state.pose_model, posenet_from_jax),
        ):
            expect = to_torch({
                "params": jax.device_get(jstate.params[name]),
                "batch_stats": jax.device_get(jstate.batch_stats[name]),
            })
            for k, v in model.state_dict().items():
                if not k.endswith("num_batches_tracked"):
                    v.copy_(expect[k])


@pytest.mark.parametrize("uncertainty, accum_steps", [(False, 1), (True, 2)])
def test_vo_train_step_matches_jax(jax_train_steps, uncertainty, accum_steps):
    """One step; ``accum_steps=2`` runs two microbatches of B rows."""
    batch = _mono_batch(B * accum_steps)
    jstart, state = _start(uncertainty)
    jstate, jlosses = jax_train_steps.mono(uncertainty, accum_steps, jstart, batch)

    step = make_vo_train_step(
        state.depth_model, state.pose_model, VOLossConfig(uncertainty=uncertainty),
        torch.float32, accum_steps=accum_steps, device="cpu",
    )
    noise = np.concatenate([MONO_NOISE] * accum_steps, axis=1)
    launches = photometric_cuda.reprojection_loss.backward_launches
    losses = step(state, batch, noise=[torch.from_numpy(n) for n in noise])
    assert photometric_cuda.reprojection_loss.backward_launches == launches  # CPU
    assert state.step == 1
    _assert_losses(losses, jlosses)
    _assert_grads(state, jstart, jstate)
    _assert_weights(state, jstate)


def test_stereo_step_matches_jax_and_freezes_posenet(jax_train_steps):
    """mono, stereo, mono against JAX. The stereo update leaves PoseNet's
    weights and Adam moments as they were, yet advances the update count
    for them: the last mono step's pose bias correction is the third
    one's in both packages."""
    ds = SyntheticStereoDataset((H, W), length=B, is_train=True)
    items = [ds[i] for i in range(B)]
    stereo_batch = {
        k: np.stack([it[k] for it in items]) for k in ("source_image", "target_image",
                                                        "intrinsic", "pose")
    }
    port_batch, _ = synthetic_stereo_batch(0, B, H, W, device="cpu")
    for k, v in stereo_batch.items():  # the port's batch is the JAX dataset's
        np.testing.assert_allclose(port_batch[k].numpy(), v, atol=1e-5, err_msg=k)

    mono_batch = _mono_batch(B)
    jstate, state = _start()
    cfg = VOLossConfig()
    mono = make_vo_train_step(
        state.depth_model, state.pose_model, cfg, torch.float32, device="cpu"
    )
    stereo = make_stereo_train_step(state.depth_model, cfg, torch.float32, device="cpu")
    mono_noise = [torch.from_numpy(n) for n in MONO_NOISE]

    jprev, (jstate, _) = jstate, jax_train_steps.mono(False, 1, jstate, mono_batch)
    mono(state, mono_batch, noise=mono_noise)
    _assert_grads(state, jprev, jstate)
    _sync(state, jstate)

    pose_before = {k: v.clone() for k, v in state.pose_model.state_dict().items()}
    moments_before = [
        {k: v.clone() for k, v in state.optimizer.state[p].items()}
        for p in state.pose_model.parameters()
    ]
    jprev, (jstate, jlosses) = jstate, jax_train_steps.stereo(jstate, stereo_batch)
    losses = stereo(
        state, stereo_batch, noise=[torch.from_numpy(n) for n in STEREO_NOISE]
    )
    _assert_losses(losses, jlosses)
    _assert_grads(state, jprev, jstate, networks=("depth",))
    _assert_weights(state, jstate)
    for k, v in state.pose_model.state_dict().items():
        torch.testing.assert_close(v, pose_before[k], rtol=0, atol=0, msg=k)
    for p, before in zip(state.pose_model.parameters(), moments_before):
        after = state.optimizer.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(after[k], before[k], rtol=0, atol=0)
        assert after["step"].item() == before["step"].item() + 1 == 2
    _sync(state, jstate)

    jprev, (jstate, jlosses) = jstate, jax_train_steps.mono(False, 1, jstate, mono_batch)
    losses = mono(state, mono_batch, noise=mono_noise)
    assert state.step == int(jstate.step) == 3
    _assert_losses(losses, jlosses, grad_norm_rtol=5e-3)
    _assert_grads(state, jprev, jstate)
    _assert_weights(state, jstate)
