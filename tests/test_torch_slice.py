"""The port's VO evaluation step and SLAM-loop ``Networks`` against the JAX
package, end to end on the CPU in fp32.

Both packages get the same weights (a JAX ``init`` carried across), the same
``synthetic_vo_batch`` and the same auto-mask tie-break noise: the JAX step
draws it from ``jax.random.normal``, which the test replaces for the
duration of the trace by a function that hands out the numpy draws the port
receives as ``noise``. The networks agree to ~1e-5 (see
``test_torch_models.py``), and everything downstream is fp32 elementwise
work, so the step's outputs are held to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deep_visual_slam_tpu.data.synthetic import synthetic_vo_batch
from deep_visual_slam_tpu.models import DepthNet as JaxDepthNet
from deep_visual_slam_tpu.models import PoseNet as JaxPoseNet
from deep_visual_slam_tpu.slam.monovo import Networks as JaxNetworks
from deep_visual_slam_tpu.training import vo_learner as jax_vo_learner
from deep_visual_slam_tpu.training.state import TrainState
from deep_visual_slam_tpu.training.steps import make_vo_eval_step as jax_eval_step

from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.ops import photometric_cuda
from deep_visual_slam_torch.slam import Networks
from deep_visual_slam_torch.training import VOLossConfig, make_vo_eval_step
from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

from test_torch_models import H, W, jax_variables

# One thread per test process: the tests run beside others, and torch's
# default of one thread per core then spends its time waiting for cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("uncertainty", [False, True])
def test_eval_step_matches_jax(monkeypatch, uncertainty):
    B = 2
    dv = jax_variables("depth", predict_uncertainty=uncertainty)
    pv = jax_variables("pose")
    batch, _ = synthetic_vo_batch(0, B, H, W)
    batch = {k: np.array(v) for k, v in batch.items()}
    noise = np.random.default_rng(5).standard_normal((4, B, H, W, 2)).astype(np.float32)

    draws = list(noise)
    monkeypatch.setattr(
        jax.random, "normal", lambda key, shape, *a, **k: jnp.asarray(draws.pop(0))
    )
    state = TrainState.create(
        params={"depth": dv["params"], "pose": pv["params"]},
        batch_stats={"depth": dv["batch_stats"], "pose": pv["batch_stats"]},
        tx=optax.identity(),
    )
    jcfg = jax_vo_learner.VOLossConfig(uncertainty=uncertainty)
    jkeep, jlosses = jax_eval_step(
        JaxDepthNet(phase_fused=False, predict_uncertainty=uncertainty),
        JaxPoseNet(),
        jcfg,
    )(state, batch, jax.random.PRNGKey(0))
    assert not draws  # the JAX loss took all four per-scale draws

    depth_net = DepthNet(predict_uncertainty=uncertainty)
    depth_net.load_state_dict(depthnet_from_jax(dv))
    pose_net = PoseNet()
    pose_net.load_state_dict(posenet_from_jax(pv))
    step = make_vo_eval_step(
        depth_net, pose_net, VOLossConfig(uncertainty=uncertainty),
        compute_dtype=torch.float32, device="cpu",
    )
    launches = photometric_cuda.reprojection_loss.launches
    keep, losses = step(batch, noise=[torch.from_numpy(n) for n in noise])
    assert photometric_cuda.reprojection_loss.launches == launches  # CPU: plain

    assert set(losses) == set(jlosses) == {"loss", *(f"loss/{s}" for s in range(4))}
    for k in jlosses:
        np.testing.assert_allclose(
            losses[k].item(), float(jlosses[k]), rtol=1e-4, err_msg=k
        )
    assert set(keep) == set(jkeep)
    for k in jkeep:
        assert keep[k].shape == jkeep[k].shape, k
        np.testing.assert_allclose(
            keep[k].numpy(), np.asarray(jkeep[k]), rtol=1e-4, atol=1e-5, err_msg=k
        )


@pytest.mark.parametrize("uint8", [False, True])
def test_networks_match_jax(rng, uint8):
    dv, pv = jax_variables("depth"), jax_variables("pose")
    jnets = JaxNetworks(dv, pv, image_shape=(H, W), dtype=jnp.float32)
    nets = Networks(
        depthnet_from_jax(dv), posenet_from_jax(pv), dtype=torch.float32,
        device="cpu",
    )
    prev, cur = rng.uniform(size=(2, H, W, 3))
    if uint8:
        prev, cur = (np.round(a * 255).astype(np.uint8) for a in (prev, cur))
    else:
        prev, cur = prev.astype(np.float32), cur.astype(np.float32)

    depth, T = nets.step(prev, cur)
    jdepth, jT = jnets.step(prev, cur)  # the merged-stem fused program
    assert depth.shape == (H, W) and T.shape == (4, 4)
    np.testing.assert_allclose(depth, jdepth, rtol=1e-4)
    np.testing.assert_allclose(T, jT, atol=1e-6)
    np.testing.assert_allclose(nets.depth(cur), jnets.depth(cur), rtol=1e-4)
    np.testing.assert_allclose(nets.pose(prev, cur), jnets.pose(prev, cur), atol=1e-6)
    np.testing.assert_allclose(nets.depth(cur), depth)
    assert nets.depth_unc(cur)[1] is None


def test_networks_match_jax_in_bf16(rng):
    """``Networks.step`` under bf16 against JAX's ``Networks(dtype=bfloat16)``
    with the same weights. bf16 keeps 8 bits of mantissa, and each side
    rounds its activations at every layer in its own way: measured over
    three inputs at 64x96, each side's bf16 depth leaves its own fp32 depth
    by up to 7.7e-3 (1.4e-3 on average), and the two bf16 depths differ by
    up to 8.5e-3 (1.7e-3 on average), the translations by 1.2e-4 of ~2.7e-2
    and the rotations by 6e-5: the same order, rounding and not a
    disagreement. Held to rtol 2e-2 per pixel, 4e-3 on average, and atol
    3e-4 on the pose."""
    dv, pv = jax_variables("depth"), jax_variables("pose")
    jnets = JaxNetworks(dv, pv, image_shape=(H, W), dtype=jnp.bfloat16)
    nets = Networks(
        depthnet_from_jax(dv), posenet_from_jax(pv), dtype=torch.bfloat16, device="cpu"
    )
    prev, cur = rng.uniform(size=(2, H, W, 3)).astype(np.float32)
    depth, T = nets.step(prev, cur)
    jdepth, jT = jnets.step(prev, cur)
    rel = np.abs(depth - jdepth) / np.abs(jdepth)
    assert rel.max() <= 2e-2 and rel.mean() <= 4e-3, (rel.max(), rel.mean())
    np.testing.assert_allclose(T, jT, rtol=0, atol=3e-4)
