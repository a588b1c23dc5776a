"""The port's global photometric BA (``slam/global_ba.py``), the autodiff
edge forms of ``slam/ba.py`` and ``Map._bucket`` against the JAX package on
the CPU.

The problems are small and consistent: a smooth texture on a
fronto-parallel plane seen under known camera translations, at 64x96, 8
keyframes and 64 points whose tracks run over 1-4 keyframes after their
host (the SLAM track structure), with noisy poses and depths to correct.
Both sides are fp32 and sum in other orders; the LM solves amplify the
last bits, hence the tolerances beside each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.slam import ba as jba
from deep_visual_slam_tpu.slam import global_ba as jgba

from deep_visual_slam_torch.slam import Map, ba, global_ba

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

H, W = 64, 96
F_REAL, P_REAL, L = 8, 64, 4
SOLVE = dict(num_iters=6, depth_damping=1.0, prior_weight=1e3)


def _mini_problem(seed=0, one_host=False):
    """Numpy arrays of a consistent problem (the recipe of
    ``tests/test_global_ba.py:_mini_problem`` at 64x96, F=8, P=64)."""
    rng = np.random.default_rng(seed)
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 80.0
    K[0, 2], K[1, 2] = W / 2 - 0.5, H / 2 - 0.5

    def tex(x, y):
        return np.stack(
            [0.5 + 0.3 * np.sin(0.8 * x + 2.0 * c) * np.cos(0.6 * y - c)
             + 0.15 * np.sin(0.35 * x * y / 8.0 + c) for c in range(3)],
            axis=-1,
        ).astype(np.float32)

    depth_gt = 2.0
    poses = np.tile(np.eye(4, dtype=np.float32), (F_REAL, 1, 1))
    poses[:, :3, 3] = np.arange(F_REAL)[:, None] * np.array([0.02, -0.01, 0.005], np.float32)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    images = []
    for T in poses:
        Zc = depth_gt - T[2, 3]
        Xc = (xs - K[0, 2]) / K[0, 0] * Zc - T[0, 3]
        Yc = (ys - K[1, 2]) / K[1, 1] * Zc - T[1, 3]
        images.append(tex(Xc * 6.0, Yc * 6.0))
    images = np.stack(images)

    host_idx = np.zeros(P_REAL, np.int64) if one_host else rng.integers(0, F_REAL - 1, P_REAL)
    host_uv = np.stack([rng.uniform(8, W - 8, P_REAL), rng.uniform(8, H - 8, P_REAL)],
                       -1).astype(np.float32)
    track_len = rng.integers(1, L + 1, P_REAL)
    obs_off = np.zeros((P_REAL, L), bool)
    obs_mask = np.zeros((P_REAL, F_REAL), bool)
    for p in range(P_REAL):
        obs_mask[p, host_idx[p]] = True
        for l in range(track_len[p]):
            if host_idx[p] + 1 + l < F_REAL:
                obs_off[p, l] = obs_mask[p, host_idx[p] + 1 + l] = True
    depths = (depth_gt * rng.uniform(0.9, 1.1, P_REAL)).astype(np.float32)
    noisy = poses.copy()
    noisy[1:, :3, 3] += rng.normal(0, 0.004, (F_REAL - 1, 3)).astype(np.float32)
    return dict(images=images, K=K, poses=noisy, depths=depths, host_uv=host_uv,
                host_idx=host_idx, obs_off=obs_off, obs_mask=obs_mask,
                weight=np.ones(P_REAL, np.float32))


def _padded(pb, pad_f=0, pad_p=0):
    """The problem's arrays padded to F_REAL + pad_f frames and P_REAL +
    pad_p points, as the map's buckets pad them."""
    F, P = F_REAL + pad_f, P_REAL + pad_p
    out = dict(
        images=np.zeros((F, H, W, 3), np.float32), poses=np.tile(np.eye(4, dtype=np.float32),
                                                                  (F, 1, 1)),
        depths=np.ones(P, np.float32), host_uv=np.zeros((P, 2), np.float32),
        host_idx=np.zeros(P, np.int64), obs_off=np.zeros((P, L), bool),
        weight=np.zeros(P, np.float32),
    )
    out["images"][:F_REAL] = pb["images"]
    out["poses"][:F_REAL] = pb["poses"]
    for k in ("depths", "host_uv", "host_idx", "obs_off", "weight"):
        out[k][:P_REAL] = pb[k]
    return out


FIELDS = ("images", "K", "poses", "depths", "host_uv", "host_idx", "obs_off", "weight")


def _torch(pb, pad_f=0, pad_p=0, **kw):
    arrays = {**pb, **_padded(pb, pad_f, pad_p)}
    problem = global_ba.GlobalBAProblem(*(torch.from_numpy(arrays[k]) for k in FIELDS))
    return global_ba.photometric_ba_global(problem, num_real=F_REAL, **kw)


def _jax(pb, **kw):
    arrays = dict(pb, images=pb["images"].transpose(0, 3, 1, 2),
                  host_idx=pb["host_idx"].astype(np.int32))
    problem = jgba.GlobalBAProblem(*(jnp.asarray(arrays[k]) for k in FIELDS))
    return jgba.photometric_ba_global(problem, num_real=jnp.asarray(F_REAL, jnp.int32), **kw)


def _accepts(diag):
    """The LM accept sequence, read off the chi2 history and final chi2."""
    seq = np.append(np.asarray(diag["chi2_history"]), float(diag["chi2"]))
    return (seq[1:] != seq[:-1]).tolist()


@pytest.mark.parametrize("scale", [1, 2])
def test_global_ba_matches_jax(scale):
    """6 LM iterations with the odometry prior and depth damping, at full
    resolution and on 2x box-pooled images: equal accept sequences, chi2
    history and chi2_photo within rtol 1e-5, poses within 1e-6 (they move by
    ~4e-3) and depths within 1e-5."""
    pb = _mini_problem()
    p_j, d_j, diag_j = _jax(pb, scale=scale, **SOLVE)
    p_t, d_t, diag_t = _torch(pb, scale=scale, **SOLVE)
    acc = _accepts(diag_j)
    assert sum(acc) >= 3 and _accepts(diag_t) == acc
    np.testing.assert_allclose(diag_t["chi2_history"].numpy(), np.asarray(diag_j["chi2_history"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(diag_t["chi2_photo"]), float(diag_j["chi2_photo"]), rtol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(p_j) - pb["poses"]).max() > 1e-3  # it moved
    assert float(diag_t["lambda"]) == pytest.approx(float(diag_j["lambda"]))


@pytest.mark.parametrize("one_host", [False, True], ids=["spread hosts", "one host"])
def test_banded_matches_windowed(one_host):
    """The banded solver against the port's dense windowed solver on the
    same problem (same LM semantics, other edge layout and assembly):
    poses within 2e-5, depths within 2e-4, chi2_photo rtol 1e-4. With every
    point on host 0 the host-side sums add 64 points into one frame, and
    each dest frame's sums the edges of many points."""
    pb = _mini_problem(seed=1, one_host=one_host)
    windowed = ba.BAProblem(*(torch.from_numpy(pb[k]) for k in (
        "images", "K", "poses", "depths", "host_uv", "host_idx", "obs_mask", "weight")))
    p_d, d_d, diag_d = ba.photometric_ba(windowed, num_real=F_REAL, **SOLVE)
    p_b, d_b, diag_b = _torch(pb, **SOLVE)
    assert diag_d["accepted"].tolist() == _accepts(diag_b)
    np.testing.assert_allclose(p_b.numpy(), p_d.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(d_b.numpy(), d_d.numpy(), rtol=0, atol=2e-4)
    np.testing.assert_allclose(float(diag_b["chi2_photo"]), float(diag_d["chi2_photo"]), rtol=1e-4)
    assert np.abs(p_b.numpy() - pb["poses"]).max() > 1e-3


def test_bucket_padding_is_invariant():
    """Padding F by 3 identity-pose, zero-image slots and P by 16 unweighted
    points (the map's buckets) leaves the solution within 1e-6."""
    pb = _mini_problem(seed=5)
    p_a, d_a, _ = _torch(pb, num_iters=5, depth_damping=1.0, prior_weight=1e3)
    p_b, d_b, _ = _torch(pb, pad_f=3, pad_p=16, num_iters=5, depth_damping=1.0, prior_weight=1e3)
    np.testing.assert_allclose(p_b.numpy()[:F_REAL], p_a.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_b.numpy()[:P_REAL], d_a.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(p_b.numpy()[F_REAL:], np.tile(np.eye(4), (3, 1, 1)))


def test_failed_cholesky_rejects_the_step():
    """A reduced system that is not positive definite (initial lambda -1e6)
    gives NaN with no error raised, and the step is rejected as JAX rejects
    its NaN; lambda is then clipped to 1e-8 and the next step is an
    ordinary one. Tolerances as above."""
    pb = _mini_problem(seed=2)
    kw = dict(num_iters=2, init_lambda=-1e6, depth_damping=1.0, prior_weight=1e3)
    p_j, d_j, diag_j = _jax(pb, **kw)
    p_t, d_t, diag_t = _torch(pb, **kw)
    assert _accepts(diag_t) == _accepts(diag_j) == [False, True]
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-5)
    p_1, d_1, diag_1 = _torch(pb, **dict(kw, num_iters=1))
    np.testing.assert_array_equal(p_1.numpy(), pb["poses"])
    np.testing.assert_array_equal(d_1.numpy(), pb["depths"])
    assert float(diag_1["lambda"]) == np.float32(1e-8)


def _edges(pb):
    """Every third (point, dest) edge of the problem with dest != host, on
    poses with the last frame shifted 5 m and one depth below the threshold,
    so that some edges fall out of bounds."""
    e_point, e_dest = np.nonzero(pb["obs_mask"] & (np.arange(F_REAL) != pb["host_idx"][:, None]))
    e_point, e_dest = e_point[::3], e_dest[::3]
    poses = pb["poses"].copy()
    poses[-1, 0, 3] += 5.0
    depths = pb["depths"].copy()
    depths[e_point[0]] = 5e-4
    return e_point, e_dest, pb["host_idx"][e_point], poses, depths


def test_autodiff_edge_forms_match_jax():
    """The single-edge forms against JAX's on 46 edges of the problem (in
    and out of bounds): residuals and intensities within 1e-6, the image
    gradient within 1e-5, ``jacfwd`` Jacobians through the sampler and the
    gather-free ``edge_jacobian`` within 1e-4 of their largest entry (pixel
    scale, fx/z ~ 40). Then the closed-form ``edges_jacobian`` on the carried
    geometry against ``torch.func.jacfwd`` of ``edge_residual``: within
    1e-4 of the largest entry, as JAX holds its own."""
    pb = _mini_problem(seed=3)
    e_point, e_dest, e_host, poses, depths = _edges(pb)
    images, K, uv = pb["images"], pb["K"], pb["host_uv"][e_point]
    I_host = np.asarray(jax.vmap(lambda hi, u: jba.bilinear_sample_stack(jnp.asarray(images), hi, u))(
        e_host.astype(np.int32), uv))

    @jax.jit
    def jax_forms(Td, Th, d, uv1, hi, di, I_h):
        z6, z = jnp.zeros(6), jnp.zeros(())
        images, K = jnp.asarray(pb["images"]), jnp.asarray(pb["K"])

        def res(xd, xh, dd):
            return jba.edge_residual(xd, xh, dd, Td, Th, d, uv1, hi, di, images, K)[0]

        r, ok = jba.edge_residual(z6, z6, z, Td, Th, d, uv1, hi, di, images, K)
        r_g, ok_g, gI = jba.edge_residual_grad(Td, Th, d, uv1, I_h, di, images, K)
        return (r, ok, jax.jacfwd(res, argnums=(0, 1, 2))(z6, z6, z), r_g, ok_g, gI,
                jba.edge_jacobian(Td, Th, d, uv1, gI, images, K),
                jba.bilinear_sample(images[di], uv1),
                jba.bilinear_sample_stack_grad(images, di, uv1))

    want = jax.vmap(jax_forms)(poses[e_dest], poses[e_host], depths[e_point], uv,
                               e_host.astype(np.int32), e_dest.astype(np.int32), I_host)
    want = jax.tree.map(np.asarray, want)
    assert 0 < want[1].sum() < len(e_point), "the fixture has in- and out-of-bounds edges"

    t = {k: torch.from_numpy(np.array(v)) for k, v in dict(
        images=images, K=K, poses=poses, depths=depths, uv=uv, I_host=I_host).items()}
    z6, z = torch.zeros(6), torch.zeros(())
    got = []
    for e, (p, d, h) in enumerate(zip(e_point, e_dest, e_host)):
        Td, Th, dep, uv1 = t["poses"][d], t["poses"][h], t["depths"][p], t["uv"][e]
        hi, di = torch.tensor(h), torch.tensor(d)

        def res(xd, xh, dd):
            return ba.edge_residual(xd, xh, dd, Td, Th, dep, uv1, hi, di, t["images"], t["K"])[0]

        r, ok = ba.edge_residual(z6, z6, z, Td, Th, dep, uv1, hi, di, t["images"], t["K"])
        r_g, ok_g, gI = ba.edge_residual_grad(Td, Th, dep, uv1, t["I_host"][e], di, t["images"],
                                              t["K"])
        got.append((r, ok, torch.func.jacfwd(res, argnums=(0, 1, 2))(z6, z6, z), r_g, ok_g, gI,
                    ba.edge_jacobian(Td, Th, dep, uv1, gI, t["images"], t["K"]),
                    ba.bilinear_sample(t["images"][d], uv1),
                    ba.bilinear_sample_stack_grad(t["images"], di, uv1)))
    got = [torch.stack(x).numpy() if torch.is_tensor(x[0]) else
           tuple(torch.stack(y).numpy() for y in zip(*x)) for x in zip(*got)]

    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[4], want[1])
    np.testing.assert_array_equal(want[4], want[1])
    for i, tol in ((0, 1e-6), (3, 1e-6), (5, 1e-5), (7, 1e-6)):
        np.testing.assert_allclose(got[i], want[i], rtol=0, atol=tol, err_msg=str(i))
    for a, b in zip(got[8], want[8]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    for i in (2, 6):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=str(i))

    # The closed form on the carried geometry against jacfwd through the
    # sampler (computed just above).
    e_dir = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1],
                      np.ones(len(uv))], -1).astype(np.float32)
    r, geom = ba.edges_evaluate(t["poses"], t["depths"], torch.from_numpy(e_dest),
                                torch.from_numpy(e_host), torch.from_numpy(e_point),
                                torch.from_numpy(e_dir), t["I_host"], t["images"], t["K"])
    np.testing.assert_allclose(r.numpy(), got[0], rtol=0, atol=1e-6)
    for a, b in zip(ba.edges_jacobian(geom, torch.from_numpy(e_dir), t["K"]), got[2]):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-4 * np.abs(b).max())


def test_bucket_helper():
    """``Map._bucket``: the smallest bucket that holds n, else n."""
    assert Map._bucket(5, Map._F_BUCKETS) == 8
    assert Map._bucket(8, Map._F_BUCKETS) == 8
    assert Map._bucket(60, Map._F_BUCKETS) == 64
    assert Map._bucket(97, Map._F_BUCKETS) == 128
    assert Map._bucket(9999, Map._F_BUCKETS) == 9999
    assert Map._bucket(1000, Map._P_BUCKETS) == 1024
