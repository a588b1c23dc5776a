"""The port's ORB frontend (``ops/orb.py``, ``slam/frontend.py``, the ORB
half of ``slam/map.py`` and ``MonoVO(frontend="orb")``) against cv2 and the
JAX package, on the CPU.

- ORB against cv2 itself and through the JAX package's ``extract_features``:
  each step (gray, pyramid, FAST, blur, ``fastAtan2``) equal; the keypoint
  sets of whole frames equal (the share held is 1.0: with cv2's keep-all-ties
  ``retainBest`` the kept set does not depend on the order of ties, and every
  score is reproduced bit for bit); angles, Harris responses and descriptors
  of the same keypoints equal; the descriptors at cv2's own keypoints equal
  bit for bit; the keypoints' order within each level cv2's (libstdc++'s
  ``nth_element`` and ``partition``, run step by step on the host). The
  committed pattern reproduces cv2 on probe keypoints.
- The matcher on the port's descriptors of two frames against the JAX
  package's cv2 ``BFMatcher`` path: equal lists.
- The Map's ORB functions on one map built by hand on both sides (numpy, no
  JAX compile): equal keyframe decisions, ``keypoints()``, ``BAProblem``
  fields and global track arrays.
- The ORB loop at 96x128 against JAX's ``MonoVO(frontend="orb")`` with the
  same network weights and the same (cv2) features: equal keyframes, and
  poses within 1e-5 m (1.5e-6 measured: the fp32 networks agree to ~1e-6
  and the LM solves carry it along).
"""

import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.data import synthetic as jsynthetic
from deep_visual_slam_tpu.slam import MonoVO as JaxMonoVO
from deep_visual_slam_tpu.slam import Networks as JaxNetworks
from deep_visual_slam_tpu.slam import frontend as jfrontend
from deep_visual_slam_tpu.slam.map import Map as JaxMap

from deep_visual_slam_torch.ops import orb
from deep_visual_slam_torch.slam import Map, MonoVO, Networks, frontend, monovo
from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

from scripts import recover_orb_pattern
from test_torch_models import jax_variables

torch.set_num_threads(1)


def _cv2_orb():
    return cv2.ORB_create(nfeatures=3000, scaleFactor=1.2, nlevels=8, edgeThreshold=31,
                          firstLevel=0, WTA_K=2, patchSize=31)


def _frame(kind: str) -> np.ndarray:
    """An RGB test frame: a 480x640 render of the SLAM fixture, a 480x640
    smooth random texture (enough corners for all 3000 features), or the
    96x128 render the loop test runs at."""
    if kind == "render":
        return jsynthetic.synthetic_multidepth_sequence(1, 480, 640, seed=100)[0][0]
    if kind == "small":
        return jsynthetic.synthetic_multidepth_sequence(1, 96, 128, seed=3)[0][0]
    rng = np.random.default_rng(1)
    g = cv2.resize(rng.integers(0, 256, (60, 80)).astype(np.uint8), (640, 480),
                   interpolation=cv2.INTER_CUBIC)
    return np.stack([g, np.roll(g, 3, 0), np.roll(g, 5, 1)], -1)


def test_pattern_matches_cv2():
    """The committed 256 pairs reproduce cv2's bits on 600 probe keypoints
    (``scripts/recover_orb_pattern.py --check`` on a small probe)."""
    patches, bits = recover_orb_pattern.probe(2, seed=7, per_image=300)
    from deep_visual_slam_torch.ops.orb_pattern import BIT_PATTERN_31

    assert len(BIT_PATTERN_31) == 256
    assert recover_orb_pattern.check(BIT_PATTERN_31, patches, bits) == [1.0] * 256


def test_orb_steps_match_cv2():
    """Every step against the cv2 call it replaces, exactly: the gray
    conversion over all 2^24 colours, the pyramid (``INTER_LINEAR_EXACT``
    from level to level), FAST-9 with non-max suppression (positions and
    scores), the float separable blur, and ``fastAtan2``."""
    c = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([c >> 16, (c >> 8) & 255, c & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    got = orb.rgb_to_gray(torch.from_numpy(rgb)).numpy()
    np.testing.assert_array_equal(got, cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))

    gray = cv2.cvtColor(_frame("texture"), cv2.COLOR_RGB2GRAY)
    levels = orb.build_pyramid(torch.from_numpy(gray))
    kernel = cv2.getGaussianKernel(7, 2, cv2.CV_32F)
    fast = cv2.FastFeatureDetector_create(20, True)
    want = gray
    for l, level in enumerate(levels):
        h, w = level.shape
        if l:
            want = cv2.resize(want, (w, h), interpolation=cv2.INTER_LINEAR_EXACT)
        np.testing.assert_array_equal(level.numpy(), want)
        score = orb.fast_scores(level)
        ys, xs = torch.nonzero(score, as_tuple=True)
        got = {(int(x), int(y)): float(score[y, x]) for y, x in zip(ys, xs)}
        assert got == {(int(k.pt[0]), int(k.pt[1])): k.response for k in fast.detect(want)}
        blur = cv2.sepFilter2D(want, cv2.CV_8U, kernel, kernel, borderType=cv2.BORDER_REFLECT_101)
        np.testing.assert_array_equal(orb.gaussian_blur(level).numpy(), blur)

    rng = np.random.default_rng(0)
    yx = rng.integers(-200000, 200000, (4000, 2)).astype(np.float32)
    yx[:8] = [[0, 0], [0, 5], [5, 0], [-5, 0], [0, -5], [3, 3], [-3, 3], [3, -3]]
    got = orb.fast_atan2(torch.from_numpy(yx[:, 0]), torch.from_numpy(yx[:, 1])).numpy()
    want = np.array([cv2.fastAtan2(float(y), float(x)) for y, x in yx], np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["render", "texture", "small"])
def test_keypoints_and_descriptors_match_cv2(kind):
    """A whole frame: the port's keypoints (level, float position) are
    cv2's, with equal angles, Harris responses and descriptors; the
    descriptors at cv2's own keypoints equal cv2's bit for bit; and the
    port's ``extract_features`` gives the JAX package's (cv2) integer
    positions as a set, for uint8 and float frames, with the same
    descriptor at each."""
    rgb = _frame(kind)
    u8 = rgb if rgb.dtype == np.uint8 else (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    gray = cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)
    pts, octave, angle, resp, des = orb.detect_and_compute(torch.from_numpy(gray))
    kps, cdes = _cv2_orb().detectAndCompute(gray, None)
    assert len(kps) > (2500 if kind == "texture" else 50)
    mine = {(int(o), x, y): i for i, (o, (x, y)) in enumerate(zip(octave.tolist(), pts.tolist()))}
    theirs = {(k.octave, k.pt[0], k.pt[1]): i for i, k in enumerate(kps)}
    assert mine.keys() == theirs.keys()
    i = np.array([mine[k] for k in theirs])
    j = np.array(list(theirs.values()))
    np.testing.assert_array_equal(angle.numpy()[i], np.float32([kps[t].angle for t in j]))
    np.testing.assert_array_equal(resp.numpy()[i], np.float32([kps[t].response for t in j]))
    np.testing.assert_array_equal(des.numpy()[i], cdes[j])

    at_cv2 = orb.compute(
        torch.from_numpy(gray), torch.tensor([k.pt for k in kps], dtype=torch.float32),
        torch.tensor([k.octave for k in kps]), torch.tensor([k.angle for k in kps], dtype=torch.float32),
    )
    np.testing.assert_array_equal(at_cv2.numpy(), cdes)

    for image in {id(rgb): rgb, id(u8): u8}.values():
        jk, jd = jfrontend.extract_features(image)
        tk, td = frontend.extract_features(image, device="cpu")
        assert tk.dtype == np.int32 and td.dtype == np.uint8
        got = sorted((tuple(p), d.tobytes()) for p, d in zip(tk.tolist(), td))
        assert got == sorted((tuple(p), d.tobytes()) for p, d in zip(jk.tolist(), jd))


@pytest.mark.parametrize("kind", ["render", "texture"])
def test_keypoint_order_matches_cv2(kind):
    """The order of the keypoints, level by level, is cv2's: ``retainBest``'s
    ``nth_element`` and ``partition`` (libstdc++'s) from FAST's raster order,
    for the 2n retain and the n retain after Harris, on a render of the SLAM
    fixture and on a texture with ties at all 3000 features; and the port's
    ``extract_features`` lists equal the JAX package's (cv2) in order."""
    rgb = _frame(kind)
    u8 = rgb if rgb.dtype == np.uint8 else (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    gray = cv2.cvtColor(u8, cv2.COLOR_RGB2GRAY)
    pts, octave, _, _, des = orb.detect_and_compute(torch.from_numpy(gray))
    kps, cdes = _cv2_orb().detectAndCompute(gray, None)
    assert list(zip(octave.tolist(), pts.tolist())) == [(k.octave, list(k.pt)) for k in kps]
    np.testing.assert_array_equal(des.numpy(), cdes)
    jk, jd = jfrontend.extract_features(u8)
    tk, td = frontend.extract_features(u8, device="cpu")
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(td, jd)


def test_matcher_matches_jax_on_orb_descriptors():
    """The port's ``match_descriptors`` on the port's ORB descriptors of two
    frames of the SLAM fixture against the JAX package's cv2 ``BFMatcher``
    path (Lowe 0.75, Hamming < 32, one match per side): equal lists; the
    guards (None, one descriptor) give no match on both sides."""
    frames = jsynthetic.synthetic_multidepth_sequence(2, 192, 256, seed=5)[0]
    (k1, d1), (k2, d2) = (frontend.extract_features(f, device="cpu") for f in frames)
    got = frontend.match_descriptors(d1, d2, device="cpu")
    assert got == jfrontend.match_descriptors_cv2(d1, d2)
    assert len(got[0]) > 100
    for a, b in ((None, d2), (d1[:1], d2), (d1, None)):
        assert frontend.match_descriptors(a, b, device="cpu") == ([], []) == jfrontend.match_descriptors(a, b)


H, W = 96, 128


def _hand_built_maps():
    """The same ORB map on both sides, built through each package's
    ``MonoVO.frontend`` (points and the keyframe policy) from hand-made
    keypoints and descriptors: 9 frames whose matches move by sub-pixel
    (non-keyframes) or several pixels (keyframes), with tracks lost and
    born, and the points of the first keyframe retired as a full window
    retires them."""
    rng = np.random.default_rng(11)
    K = jsynthetic.default_intrinsics(H, W)
    n = 90
    kps = np.stack([rng.integers(8, W - 8, n), rng.integers(8, H - 8, n)], 1)
    des = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    shifts = [0.0, 0.3, 3.0, 0.2, 0.4, 4.0, 2.5, 0.1, 5.0]
    sides = []
    for pkg in ("jax", "torch"):
        m = (JaxMap if pkg == "jax" else Map)(
            num_kf=3, max_points=24, **({} if pkg == "jax" else {"device": "cpu"}))
        m.intrinsic3 = K[:3, :3]
        fake = types.SimpleNamespace(mp=m, device=torch.device("cpu"))
        run = JaxMonoVO.frontend if pkg == "jax" else MonoVO.frontend
        sides.append((m, fake, run))
    decisions = [[], []]
    r = np.random.default_rng(12)
    cur_k, cur_d = kps.copy(), des.copy()
    for i, shift in enumerate(shifts):
        if i:
            cur_k = np.clip(cur_k + np.round([shift, 0.5 * shift] + r.normal(0, 0.4, (n, 2))),
                            0, [W - 1, H - 1]).astype(np.int64)
            flips = np.unpackbits(cur_d, axis=1)
            flips[r.random(flips.shape) < 0.02] ^= 1
            cur_d = np.packbits(flips, axis=1)
            lost = r.random(n) < 0.15
            cur_d[lost] = r.integers(0, 256, (int(lost.sum()), 32), dtype=np.uint8)
        perm = r.permutation(n)
        feats = (cur_k[perm].astype(np.int32), cur_d[perm].copy())
        image = r.uniform(size=(H, W, 3)).astype(np.float32)
        depth = r.uniform(1.0, 3.0, (H, W)).astype(np.float32)
        unc = r.uniform(0.0, 0.5, (H, W)).astype(np.float32)
        pose = np.eye(4)
        pose[:3, 3] = [-0.01 * i, 0.002 * i, 0.0]
        c, s = np.cos(0.002 * i), np.sin(0.002 * i)
        pose[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        for side, (m, fake, run) in enumerate(sides):
            decisions[side].append(run(fake, image, depth, unc, pose, (1.0, 0.0), features=feats))
            if i == 6:  # what a full window's marginalization does
                for pt in m.keyframes[0].pts.values():
                    pt.valid = False
    return K, sides[0][0], sides[1][0], decisions


def test_map_orb_functions_match_jax():
    """On the hand-built map: the keyframe decisions (with ``K R K^-1`` and
    with the bare-``R`` fallback), ``keypoints()`` of the window, the
    windowed ``BAProblem`` (every field, capped to 24 tracks so the stable
    longest-first order decides) and the global track arrays are equal."""
    K, jm, tm, decisions = _hand_built_maps()
    assert decisions[0] == decisions[1]
    assert 2 <= sum(decisions[1]) <= 6
    assert [f.id for f in tm.keyframes] == [f.id for f in jm.keyframes]
    assert len(tm.points) == len(jm.points) > 100

    def walk(m, frames):
        return [(p.id, [(f.id, i) for f, i in obs]) for p, obs in m.keypoints(frames).items()]

    window_t, window_j = tm.keyframes[-3:], jm.keyframes[-3:]
    assert walk(tm, window_t) == walk(jm, window_j)
    assert len(walk(tm, tm.keyframes)) > 24

    got, got_pts = tm._build_problem(K, window_t, 24, pad_frames=3)
    want, want_pts = jm._build_problem(K, window_j, 24, pad_frames=3)
    assert [p.id for p in got_pts] == [p.id for p in want_pts]
    for name in ("K", "poses", "depths", "host_uv", "host_idx", "obs_mask", "weight"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    for a, b in zip(got.images, want.images):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    kfs_t = [f for f in tm.frames if f.anchor is f]
    kfs_j = [f for f in jm.frames if f.anchor is f]
    g_t = tm._gather_global_tracks(kfs_t)
    g_j = jm._gather_global_tracks(kfs_j, tm._GLOBAL_POINTS, tm._GLOBAL_OFFSETS)
    assert [p.id for p in g_t[0]] == [p.id for p in g_j[0]]
    assert any(not p.valid for p in g_t[0])  # retired points stay in global BA
    for a, b in zip(g_t[1:], g_j[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    for m in (tm, jm):
        m.intrinsic3 = None
    last_t, last_j = tm.frames[-1], jm.frames[-1]
    assert tm.check_key_frame(last_t) == jm.check_key_frame(last_j)


def test_orb_loop_matches_jax(monkeypatch):
    """``MonoVO(frontend="orb")`` at 96x128 (``num_kf=4``,
    ``max_points=64``, fp32 networks with the same random weights) over 10
    frames of the SLAM fixture, the port fed the JAX package's cv2 features
    (the test's own patch): the same keyframes and points, poses within
    1e-5 m. Then global BA over the port's ORB keyframes runs and keeps the
    trajectory finite, oracle injection is refused, and a ``Frame`` without
    features runs ORB."""
    frames, K, _, _ = jsynthetic.synthetic_multidepth_sequence(
        10, H, W, seed=3, step_translation=0.02, step_rotation=0.004)
    dv, pv = jax_variables("depth"), jax_variables("pose")
    jax_nets = JaxNetworks(dv, pv, image_shape=(H, W), dtype=jnp.float32)
    nets = Networks(depthnet_from_jax(dv), posenet_from_jax(pv), dtype=torch.float32, device="cpu")
    feats = [jfrontend.extract_features(f) for f in frames]

    vo_j = JaxMonoVO(K, networks=jax_nets, image_shape=(H, W), num_kf=4, max_points=64,
                     frontend="orb")
    for f in frames:
        vo_j.process_frame(f)
    traj_j = vo_j.trajectory()

    served = iter(feats)
    monkeypatch.setattr(monovo, "extract_features", lambda image, device=None: next(served))
    vo = MonoVO(K, networks=nets, image_shape=(H, W), num_kf=4, max_points=64, frontend="orb",
                device="cpu")
    assert vo.klt is None
    for f in frames:
        vo.process_frame(f)
    traj = vo.trajectory()

    kf_j = sorted(f.id for f in vo_j.mp.frames if f.anchor is f)
    kf_t = sorted(f.id for f in vo.mp.frames if f.anchor is f)
    assert kf_t == kf_j and len(kf_t) >= 4
    assert vo.n_keyframes == vo_j.n_keyframes
    assert len(vo.mp.points) == len(vo_j.mp.points) > 50
    np.testing.assert_allclose(traj, traj_j, rtol=0, atol=1e-5)
    assert vo.timings["networks"] > 0 and vo.timings["backend_ba"] > 0

    assert vo.mp.global_bundle_adjustment(K)
    assert np.isfinite(vo.trajectory()).all()
    with pytest.raises(ValueError, match="KLT"):
        vo.process_frame(frames[0], oracle_depth=np.ones((H, W), np.float32))
    f = frontend.Frame(vo.mp, frames[0], None, None, np.eye(4))
    np.testing.assert_array_equal(f.kps, frontend.extract_features(frames[0], device="cpu")[0])
