"""The port's SE(3) maps and windowed photometric BA (``ops/se3.py``,
``slam/ba.py``) against the JAX package on the CPU, on
``tests/test_ba.py:_make_problem``.

Both sides are fp32. The residuals, Jacobians and normal equations are sums
taken in other orders by XLA and PyTorch, and a Cholesky solve of the
reduced pose system (condition ~1e4-1e6 with LM damping 1e-4) amplifies
their last bits, so poses are held to 2e-5 and depths to 2e-4 after a full
solve. The LM accept sequence is discrete and must be equal; JAX does not
return it, so it is read off its chi2 history (an accepted step always
lowers the carried energy, a rejected one leaves it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.ops import se3 as jse3
from deep_visual_slam_tpu.slam import ba as jba

from deep_visual_slam_torch.ops import se3
from deep_visual_slam_torch.slam import ba

from test_ba import F, P, _make_problem

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _torch_problem(problem):
    return ba.BAProblem(*(_t(v) for v in problem))


# Rotation angles across the series branches (< 1e-4) and beyond.
ANGLES = [0.0, 3e-7, 5e-5, 9.9e-5, 2e-4, 1e-2, 0.7, 2.5]


@pytest.mark.parametrize("angle", ANGLES)
def test_se3_maps_match_jax(angle):
    """exp, log, inv, the adjoint and the SO(3) log at one rotation angle
    (the small-angle series below 1e-4 on both sides): fp32 within 2e-6
    (log within 2e-5 at 2.5 rad, where 1/sin amplifies the rounding)."""
    rng = np.random.default_rng(int(angle * 1e7) % 2**31)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    xi = np.concatenate([rng.uniform(-0.3, 0.3, 3), angle * axis]).astype(np.float32)
    xi = np.stack([xi, xi * 0.5]).astype(np.float32)  # a batch of two

    T_j = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    T_t = se3.se3_exp(_t(xi)).numpy()
    np.testing.assert_allclose(T_t, T_j, rtol=0, atol=2e-6)
    np.testing.assert_allclose(se3.se3_inv(_t(T_j)).numpy(), np.asarray(jse3.se3_inv(T_j)),
                               rtol=0, atol=2e-6)
    log_tol = 2e-5 if angle > 2 else 2e-6
    np.testing.assert_allclose(se3.se3_log(_t(T_j)).numpy(), np.asarray(jse3.se3_log(T_j)),
                               rtol=0, atol=log_tol)
    np.testing.assert_allclose(
        se3.axisangle_from_rotation(_t(T_j[:, :3, :3])).numpy(),
        np.asarray(jse3.axisangle_from_rotation(T_j[:, :3, :3])), rtol=0, atol=log_tol,
    )
    np.testing.assert_allclose(ba.se3_adjoint(_t(T_j)).numpy(),
                               np.asarray(jba.se3_adjoint(T_j)), rtol=0, atol=1e-6)


def test_edges_evaluate_and_jacobian_match_jax():
    """Residuals, validity, geometry and closed-form Jacobians of every
    edge, with out-of-bounds edges (a 5 m shift of the last frame, a point
    below the depth threshold) and a per-frame affine: residuals within
    4e-6 (values up to ~1, fp32 geometry summed in other orders), Jacobians
    within 1e-4 of their largest entry (pixel-scale products of fx/z)."""
    problem, _ = _make_problem(pose_noise=0.05, depth_noise=0.2)
    images, K = problem.images, problem.K
    e_point, e_dest = np.meshgrid(np.arange(P), np.arange(1, F), indexing="ij")
    e_point, e_dest = e_point.ravel().astype(np.int32), e_dest.ravel().astype(np.int32)
    e_host = np.zeros_like(e_point)
    poses = np.array(problem.poses)
    poses[-1, 0, 3] += 5.0
    depths = np.array(problem.depths)
    depths[3] = 5e-4
    uv = np.asarray(problem.host_uv)[e_point]
    Kn = np.asarray(K)
    e_dir = np.stack([(uv[:, 0] - Kn[0, 2]) / Kn[0, 0], (uv[:, 1] - Kn[1, 2]) / Kn[1, 1],
                      np.ones(len(uv), np.float32)], -1).astype(np.float32)
    ab = np.stack([np.linspace(0.9, 1.1, F), np.linspace(-0.05, 0.05, F)], -1).astype(np.float32)
    I_host = np.asarray(ba.bilinear_sample_stack(_t(images), _t(e_host), _t(uv)))

    for ab_arg in (None, ab):
        r_j, g_j = jba.edges_evaluate(
            jnp.asarray(poses), jnp.asarray(depths), e_dest, e_host, e_point,
            jnp.asarray(e_dir), jnp.asarray(I_host), images, K,
            ab=None if ab_arg is None else jnp.asarray(ab_arg),
        )
        r_t, g_t = ba.edges_evaluate(
            _t(poses), _t(depths), _t(e_dest).long(), _t(e_host).long(), _t(e_point).long(),
            _t(e_dir), _t(I_host), _t(images), _t(K), ab=None if ab_arg is None else _t(ab_arg),
        )
        ok = np.asarray(g_j.ok)
        assert 0 < ok.sum() < len(ok), "the fixture has in- and out-of-bounds edges"
        np.testing.assert_array_equal(g_t.ok.numpy(), ok)
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=4e-6)
        for name in ("gI", "R_rel", "X_h", "X_d", "I_dest"):
            np.testing.assert_allclose(getattr(g_t, name).numpy(), np.asarray(getattr(g_j, name)),
                                       rtol=0, atol=4e-6, err_msg=name)
        J_j = jba.edges_jacobian(g_j, jnp.asarray(e_dir), K)
        J_t = ba.edges_jacobian(g_t, _t(e_dir), _t(K))
        for a, b in zip(J_t, J_j):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


def _accepts(diag_j):
    """JAX's accept sequence from its chi2 history and final chi2."""
    seq = np.append(np.asarray(diag_j["chi2_history"]), float(diag_j["chi2"]))
    return seq[1:] != seq[:-1]


def _affine_problem():
    """``_make_problem`` with a per-frame exposure gain on the images."""
    problem, _ = _make_problem(pose_noise=0.01, depth_noise=0.05)
    gains = np.array([1.0, 1.1, 0.9, 1.05], np.float32)[:, None, None, None]
    images = np.clip(np.asarray(problem.images) * gains, 0.0, 1.0)
    return problem._replace(images=jnp.asarray(images))


def test_one_lm_step_matches_jax():
    """One accepted LM step: the pose increment (the se(3) log of
    new @ old^-1, i.e. the solve's dx) within 1e-5 and the depth increment
    dz within 1e-4; the starting chi2 within rtol 1e-5."""
    problem, _ = _make_problem(pose_noise=0.01, depth_noise=0.05)
    p_j, d_j, diag_j = jba.photometric_ba(problem, num_iters=1)
    p_t, d_t, diag_t = ba.photometric_ba(_torch_problem(problem), num_iters=1)
    assert _accepts(diag_j).tolist() == diag_t["accepted"].tolist() == [True]
    np.testing.assert_allclose(diag_t["chi2_history"].numpy(),
                               np.asarray(diag_j["chi2_history"]), rtol=1e-5)
    old = np.asarray(problem.poses)
    dx_j = np.asarray(jse3.se3_log(np.asarray(p_j) @ np.linalg.inv(old)))
    dx_t = np.asarray(jse3.se3_log(p_t.numpy() @ np.linalg.inv(old)))
    assert np.abs(dx_j).max() > 1e-3  # a real step
    np.testing.assert_allclose(dx_t, dx_j, rtol=0, atol=1e-5)
    dz_j = np.asarray(d_j) - np.asarray(problem.depths)
    np.testing.assert_allclose(d_t.numpy() - np.asarray(problem.depths), dz_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("estimate_affine", [False, True], ids=["D6", "D8"])
def test_photometric_ba_matches_jax(estimate_affine):
    """10 LM iterations, D=6 (pose) and D=8 (pose + gain/bias on an
    exposure-changed problem, affine prior 0.1), with a padded frame slot
    (``num_real``) and the odometry prior: equal accept sequences, chi2
    history within rtol 1e-4, poses within 2e-5, depths within 2e-4, (a, b)
    within 1e-4."""
    if estimate_affine:
        problem = _affine_problem()
    else:
        problem, _ = _make_problem(pose_noise=0.01, depth_noise=0.05)
    kwargs = dict(num_iters=10, prior_weight=10.0, num_real=F - 1, depth_damping=0.5,
                  estimate_affine=estimate_affine, affine_prior=0.1)
    p_j, d_j, diag_j = jba.photometric_ba(problem, **kwargs)
    p_t, d_t, diag_t = ba.photometric_ba(_torch_problem(problem), **kwargs)
    acc = _accepts(diag_j)
    assert acc.sum() >= 3
    assert diag_t["accepted"].tolist() == acc.tolist()
    np.testing.assert_allclose(diag_t["chi2_history"].numpy(),
                               np.asarray(diag_j["chi2_history"]), rtol=1e-4)
    np.testing.assert_allclose(float(diag_t["chi2"]), float(diag_j["chi2"]), rtol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=2e-4)
    np.testing.assert_allclose(diag_t["ab"].numpy(), np.asarray(diag_j["ab"]), rtol=0, atol=1e-4)
    if estimate_affine:
        assert np.abs(np.asarray(diag_j["ab"])[1:] - [1.0, 0.0]).max() > 1e-2


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8"])
def test_photometric_ba_pyramid_matches_jax(uint8):
    """The SLAM map's solve: levels (2, 1), 6 iterations each, prior 1e3,
    depth damping 1, on fp32 images and on their uint8 quantization (scaled
    inside the solve), given as a tuple of frames as the map passes them;
    tolerances as above."""
    problem, _ = _make_problem(pose_noise=0.01, depth_noise=0.05)
    images = np.asarray(problem.images)
    if uint8:
        images = np.round(images * 255).astype(np.uint8)
    problem = problem._replace(images=tuple(jnp.asarray(im) for im in images))
    kwargs = dict(levels=(2, 1), iters_per_level=(6, 6), prior_weight=1e3,
                  depth_damping=1.0, num_real=F)
    p_j, d_j, diag_j = jba.photometric_ba_pyramid(problem, **kwargs)
    tproblem = ba.BAProblem(tuple(_t(im) for im in images), *(_t(v) for v in problem[1:]))
    p_t, d_t, diag_t = ba.photometric_ba_pyramid(tproblem, **kwargs)
    acc = _accepts(diag_j)
    assert acc.sum() >= 2
    assert diag_t["accepted"].tolist() == acc.tolist()
    np.testing.assert_allclose(diag_t["chi2_history"].numpy(),
                               np.asarray(diag_j["chi2_history"]), rtol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=2e-4)
    assert np.abs(np.asarray(p_j) - np.asarray(problem.poses)).max() > 1e-3  # it moved


def test_failed_cholesky_rejects_the_step():
    """A reduced system that is not positive definite gives NaN (no error
    raised, no host synchronisation on the card) and the LM step is
    rejected, as JAX rejects its NaN: a negative initial lambda of -1e6
    makes the damped diagonal negative. Lambda then grows x4 and is clipped
    to 1e-8, so the second step is an ordinary one (depth damping 1 keeps it
    well conditioned); tolerances as above."""
    problem, _ = _make_problem(pose_noise=0.01, depth_noise=0.05)
    kwargs = dict(init_lambda=-1e6, depth_damping=1.0)
    p_t, d_t, diag_t = ba.photometric_ba(_torch_problem(problem), num_iters=1, **kwargs)
    p_j, d_j, diag_j = jba.photometric_ba(problem, num_iters=1, **kwargs)
    assert diag_t["accepted"].tolist() == _accepts(diag_j).tolist() == [False]
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(problem.poses))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(problem.depths))
    assert float(diag_t["lambda"]) == float(diag_j["lambda"]) == np.float32(1e-8)

    p_t, d_t, diag_t = ba.photometric_ba(_torch_problem(problem), num_iters=2, **kwargs)
    p_j, d_j, diag_j = jba.photometric_ba(problem, num_iters=2, **kwargs)
    assert diag_t["accepted"].tolist() == _accepts(diag_j).tolist() == [False, True]
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=2e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=2e-4)
