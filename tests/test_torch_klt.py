"""The port's KLT ops (``ops/klt.py``) against the JAX package on the CPU.

The same numpy images go through both; everything is fp32 elementwise work
with sums of at most 81 terms, so values agree to a few ulp. The tracker's
and the detector's discrete outputs (``ok``, the corners and their order)
are held equal, on inputs where no decision sits at a tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.ops import klt as jklt

from deep_visual_slam_torch.ops import klt

from test_klt import H, W, _texture

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_rgb_to_gray_and_pyramid_match_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(H, W, 3)).astype(np.float32)
    g_j = np.asarray(jklt.rgb_to_gray(jnp.asarray(img)))
    g_t = klt.rgb_to_gray(_t(img)).numpy()
    # Three products summed: the JAX matvec may round otherwise, by an ulp.
    np.testing.assert_allclose(g_t, g_j, rtol=0, atol=2e-7)

    gray = _texture(rng)
    pyr_j = jklt.build_pyramid(jnp.asarray(gray), 4)
    pyr_t = klt.build_pyramid(_t(gray), 4)
    assert [tuple(p.shape) for p in pyr_t] == [p.shape for p in pyr_j]
    assert [tuple(p.shape) for p in pyr_t] == [(96, 128), (48, 64), (24, 32), (12, 16)]
    for a, b in zip(pyr_t, pyr_j):
        # The same [1, 2, 1]/4 arithmetic in the same order.
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)


@pytest.mark.parametrize("shift", [(3.0, 0.0), (0.0, 2.0), (5.0, -4.0)])
def test_track_points_matches_jax(shift):
    """On ``tests/test_klt.py``'s translations: equal ``ok`` and positions
    within 1e-4 px (8 Gauss-Newton iterations at 4 levels of fp32 sums in
    other orders)."""
    rng = np.random.default_rng(0)
    tex = _texture(rng, H * 2, W * 2)
    sx, sy = shift
    prev = tex[32 : 32 + H, 32 : 32 + W]
    cur = tex[32 - int(sy) : 32 - int(sy) + H, 32 - int(sx) : 32 - int(sx) + W]
    pts_j, score_j = jklt.shi_tomasi_corners(jnp.asarray(prev), 48, nms_radius=4)
    pts = np.asarray(pts_j)
    valid = np.asarray(score_j) > 0
    # Two extra rows: a dead slot, and a point on a flat patch (det gate).
    pts = np.concatenate([pts, [[40.0, 40.0], [W - 10.0, H - 10.0]]]).astype(np.float32)
    valid = np.concatenate([valid, [False, True]])

    new_j, ok_j, err_j = jklt.track_points(
        tuple(jklt.build_pyramid(jnp.asarray(prev), 3)),
        tuple(jklt.build_pyramid(jnp.asarray(cur), 3)),
        jnp.asarray(pts), jnp.asarray(valid),
    )
    new_t, ok_t, err_t = klt.track_points(
        klt.build_pyramid(_t(prev), 3), klt.build_pyramid(_t(cur), 3),
        _t(pts), _t(valid),
    )
    ok_j = np.asarray(ok_j)
    assert ok_j.sum() > 15
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=0, atol=1e-6)


@pytest.mark.parametrize("occupied", [False, True])
def test_shi_tomasi_corners_match_jax(occupied):
    """The same corners in the same order, with and without an occupancy
    table; scores within 1e-6 (a 3x3 box sum and a square root in fp32)."""
    rng = np.random.default_rng(1)
    gray = _texture(rng)
    kwargs = {}
    if occupied:
        occ = rng.uniform(10, 100, size=(24, 2)).astype(np.float32)
        mask = rng.uniform(size=24) < 0.6
        kwargs = dict(occupied_uv=occ, occupied_mask=mask)
    pts_j, score_j = jklt.shi_tomasi_corners(
        jnp.asarray(gray), 400, nms_radius=4,
        **{k: jnp.asarray(v) for k, v in kwargs.items()},
    )
    pts_t, score_t = klt.shi_tomasi_corners(
        _t(gray), 400, nms_radius=4, **{k: _t(v) for k, v in kwargs.items()}
    )
    score_j = np.asarray(score_j)
    n = int((score_j > 0).sum())
    assert n > 20
    # Past the live corners the rows are padding at score 0, ordered by
    # flat index as jax.lax.top_k orders ties: all 400 rows must agree.
    assert n < 400
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_allclose(score_t.numpy(), score_j, rtol=0, atol=1e-6)


def test_corner_ties_come_lowest_index_first():
    """Equal scores: ``jax.lax.top_k``'s order (lowest flat index first),
    which ``torch.topk`` does not promise on CUDA."""
    gray = np.zeros((40, 40), np.float32)
    for y, x in ((12, 30), (12, 10), (28, 20), (28, 12)):
        gray[y - 1 : y + 2, x - 1 : x + 2] = 1.0  # identical blobs
    pts_j, score_j = jklt.shi_tomasi_corners(jnp.asarray(gray), 6, nms_radius=3, border=4)
    pts_t, score_t = klt.shi_tomasi_corners(_t(gray), 6, nms_radius=3, border=4)
    np.testing.assert_array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_array_equal(score_t.numpy(), np.asarray(score_j))
