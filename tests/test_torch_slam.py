"""The port's SLAM loop (``slam/``: Frame/Point, Map, KLTFrontend, MonoVO)
and its fixtures against the JAX package on the CPU.

The loop is held as a whole: the same frames of
``synthetic_multidepth_sequence`` at 96x128 go through the JAX ``MonoVO``
and the port's, with ``num_kf=4`` and ``max_points=64``, once from an oracle
initialization (GT depth, GT relative poses with odometry noise, built by
``scripts/ba_ablation.py:make_oracle_inits``) and once driven by the
networks (fp32, the same random weights and random BatchNorm statistics on
both sides, carried from JAX by ``utils/weights.py``). The keyframe ids
must be equal; the trajectories agree to the last bits that the LM solves
amplify (tolerances beside each check).
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deep_visual_slam_tpu.data import synthetic as jsynthetic
from deep_visual_slam_tpu.eval import trajectory as jtrajectory
from deep_visual_slam_tpu.eval.traj_eval import EvalTrajectory as JaxEvalTrajectory
from deep_visual_slam_tpu.slam import MonoVO as JaxMonoVO
from deep_visual_slam_tpu.slam import Networks as JaxNetworks

from deep_visual_slam_torch import ba_ablation
from deep_visual_slam_torch.data import synthetic
from deep_visual_slam_torch.eval import EvalTrajectory, trajectory
from deep_visual_slam_torch.slam import Frame, KLTFrontend, Map, MonoVO, Networks
from deep_visual_slam_torch.utils.weights import depthnet_from_jax, posenet_from_jax

from scripts import ba_ablation as jax_ba_ablation
from scripts.ba_ablation import make_oracle_inits
from test_torch_models import jax_variables

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

H, W = 96, 128
N_FRAMES = 10
SEQ = dict(seed=3, step_translation=0.02, step_rotation=0.004)


@functools.lru_cache(maxsize=None)
def _networks():
    """The JAX networks and the port's, with the same random weights (made
    once per test process)."""
    dv, pv = jax_variables("depth", predict_uncertainty=False), jax_variables("pose")
    jax_nets = JaxNetworks(dv, pv, image_shape=(H, W), dtype=jnp.float32)
    nets = Networks(depthnet_from_jax(dv), posenet_from_jax(pv), dtype=torch.float32,
                    device="cpu")
    return jax_nets, nets


_JAX_KLT_FNS = []


def _jax_monovo(K):
    """A JAX ``MonoVO`` on the shared networks. Its ``KLTFrontend`` jits the
    net+LK step, the pyramid and the detector afresh for each instance;
    every instance after the first takes the first one's (the same
    networks, shapes and settings), saving a compile of ~25 s a loop."""
    vo = JaxMonoVO(K, networks=_networks()[0], image_shape=(H, W), num_kf=4, max_points=64)
    if _JAX_KLT_FNS:
        vo.klt._step_fn, vo.klt._pyramid_fn, vo.klt._detect_fn = _JAX_KLT_FNS
    else:
        _JAX_KLT_FNS.extend([vo.klt._step_fn, vo.klt._pyramid_fn, vo.klt._detect_fn])
    return vo


def _monovo(K, **kwargs):
    return MonoVO(K, networks=_networks()[1], image_shape=(H, W), num_kf=4, max_points=64,
                  device="cpu", **kwargs)


def _run(vo, frames, oracle=None, optimize=True):
    for i, f in enumerate(frames):
        kw = {} if oracle is None else dict(oracle_depth=oracle[0][i], oracle_rel=oracle[1][i])
        vo.process_frame(f, optimize=optimize, **kw)
    return vo.trajectory(), sorted(f.id for f in vo.mp.frames if f.anchor is f)


def _rmse(traj_wc, gt_cw):
    gt_wc = np.linalg.inv(np.asarray(gt_cw, np.float64))
    return float(np.sqrt(np.mean(np.sum((traj_wc[:, :3, 3] - gt_wc[:, :3, 3]) ** 2, -1))))


def test_slam_fixtures_match_jax():
    """``synthetic_multidepth_sequence`` is numpy on both sides: equal
    frames, poses and depths. ``synthetic_slam_sequence`` renders through
    each package's warp: frames within 1e-5, poses within 1e-6. The port's
    copy of the oracle initialization draws the same numbers."""
    j = jsynthetic.synthetic_multidepth_sequence(4, 48, 64, distractor="moving", **SEQ)
    t = synthetic.synthetic_multidepth_sequence(4, 48, 64, distractor="moving", **SEQ)
    assert len(t) == 5 and t[4].any()
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    want = make_oracle_inits(j[2], j[3], 7, 0.3, 0.005, 0.1)
    got = synthetic.make_oracle_inits(j[2], j[3], 7, 0.3, 0.005, 0.1)
    for a, b in zip(got[0] + got[1][1:], want[0] + want[1][1:]):
        np.testing.assert_array_equal(a, b)
    assert got[1][0] is want[1][0] is None
    j = jsynthetic.synthetic_slam_sequence(4, 48, 64, seed=1)
    t = synthetic.synthetic_slam_sequence(4, 48, 64, seed=1, device="cpu")
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_allclose(t[2], j[2], rtol=0, atol=1e-6)


def test_monovo_oracle_loop_matches_jax():
    """Oracle depth and noisy GT odometry (0.3 deg, 5 mm): the same
    keyframes, trajectories within 1e-5 (measured 2.5e-7), and windowed BA
    lowers the translation RMSE against GT as it does in JAX."""
    frames, K, gt, depths = jsynthetic.synthetic_multidepth_sequence(N_FRAMES, H, W, **SEQ)
    oracle = make_oracle_inits(gt, depths, SEQ["seed"], 0.3, 0.005, 0.0)
    traj_j, kf_j = _run(_jax_monovo(K), frames, oracle)
    vo = _monovo(K)
    traj_t, kf_t = _run(vo, frames, oracle)
    assert kf_t == kf_j and len(kf_j) >= 4
    assert vo.n_keyframes == len(kf_t)
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=1e-5)
    no_ba, kf_no_ba = _run(_monovo(K), frames, oracle, optimize=False)
    assert kf_no_ba == kf_t
    assert _rmse(traj_t, gt) < _rmse(no_ba, gt)


def test_monovo_network_loop_matches_jax():
    """Driven by the networks: the same keyframes and tracks, and
    trajectories within 1e-4 (the networks agree to ~1e-5 in depth and
    ~1e-6 in pose, which BA and the chain carry along)."""
    frames, K, _, _ = jsynthetic.synthetic_multidepth_sequence(N_FRAMES, H, W, **SEQ)
    vo_j = _jax_monovo(K)
    traj_j, kf_j = _run(vo_j, frames)
    vo = _monovo(K)
    traj_t, kf_t = _run(vo, frames)
    assert kf_t == kf_j and len(kf_j) >= 3
    np.testing.assert_array_equal(vo.klt.alive, vo_j.klt.alive)
    np.testing.assert_allclose(vo.klt.uv, vo_j.klt.uv, rtol=0, atol=1e-3)
    np.testing.assert_allclose(traj_t, traj_j, rtol=0, atol=1e-4)
    assert vo.timings["networks"] > 0 and vo.timings["backend_ba"] > 0


def test_monovo_lazy_depth_fetch():
    """``fetch_depth=False``: non-keyframes return depth None (their map
    stays on the device); keyframes still fetch theirs for the BA problem,
    and the trajectory is the one the default fetch gives."""
    frames, K, gt, depths = synthetic.synthetic_multidepth_sequence(
        8, H, W, seed=3, step_translation=0.004, step_rotation=0.0008
    )
    # GT odometry, so that the slow sweep has non-keyframes; the depth is
    # the network's, which is what the flag leaves on the device.
    rels = make_oracle_inits(gt, depths, 3, 0.0, 0.0, 0.0)[1]
    trajs = []
    for fetch in (True, False):
        vo = _monovo(K, fetch_depth=fetch)
        out = [vo.process_frame(f, oracle_rel=rel)[0] for f, rel in zip(frames, rels)]
        trajs.append(vo.trajectory())
    skipped = [d for d in out if d is None]
    assert 0 < len(skipped) == len(frames) - vo.n_keyframes
    for d in out:
        assert d is None or (d.shape == (H, W) and np.isfinite(d).all())
    assert all(f.depth is not None for f in vo.mp.keyframes)
    np.testing.assert_array_equal(trajs[0], trajs[1])


def test_global_ba_over_marginalized_keyframes_matches_jax():
    """14 frames of a faster sweep (0.03 m, 0.006 rad a step) from an
    oracle initialization, ``num_kf=4``: the keyframe history outgrows the
    window, and global BA on it (levels (2, 1), 21 iterations) moves
    keyframes already marginalized out of the window while the first stays
    fixed. The port's keyframe poses after it, and the trajectory riding
    them, are within 1e-5 of JAX's (they move by ~1e-3)."""
    frames, K, gt, depths = jsynthetic.synthetic_multidepth_sequence(
        14, H, W, seed=11, step_translation=0.03, step_rotation=0.006
    )
    oracle = make_oracle_inits(gt, depths, 11, 0.3, 0.005, 0.0)
    vo_j, vo = _jax_monovo(K), _monovo(K)
    _run(vo_j, frames, oracle)
    _, kf_ids = _run(vo, frames, oracle)
    kfs = [f for f in vo.mp.frames if f.anchor is f]
    n_marginalized = len(kfs) - len(vo.mp.keyframes)
    assert n_marginalized >= 2 and len(kfs) == len(kf_ids)
    before = np.stack([f.pose for f in kfs])
    assert vo_j.mp.global_bundle_adjustment(K, verbose=False)
    assert vo.mp.global_bundle_adjustment(K)
    after = np.stack([f.pose for f in kfs])
    after_j = np.stack([f.pose for f in vo_j.mp.frames if f.anchor is f])
    moved = np.abs(after - before).max(axis=(1, 2))
    assert moved[0] == 0 and moved[1:n_marginalized].max() > 1e-4, moved
    np.testing.assert_allclose(after, after_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(vo.trajectory(), vo_j.trajectory(), rtol=0, atol=1e-5)


def _walk(seed, n=40):
    """A random camera-to-world walk [n, 4, 4] with rotations."""
    rng = np.random.default_rng(seed)
    rels = [synthetic._perturb_rel(np.eye(4), rng.normal(0, 0.05, 3), rng.normal(0, 0.3, 3))
            for _ in range(n - 1)]
    return trajectory.accumulate_trajectory(rels)


@pytest.mark.parametrize("metric", [
    "accumulate_trajectory", "rpe", "kitti_segment_errors", "scale_correction_factor",
    "EvalTrajectory.metrics", "ba_ablation.evaluate",
])
def test_trajectory_metrics_match_jax(metric):
    """The host-numpy metrics on a 40-pose random walk and a noisy copy of
    it (float64 on both sides): within 1e-12, the ablation's rounded
    numbers equal."""
    gt = _walk(1)
    rng = np.random.default_rng(2)
    pred = np.stack([synthetic._perturb_rel(T, rng.normal(0, 0.01, 3), rng.normal(0, 0.02, 3))
                     for T in gt])
    rel_gt = [np.linalg.inv(a) @ b for a, b in zip(gt[:-1], gt[1:])]
    rel_pred = [np.linalg.inv(a) @ b for a, b in zip(pred[:-1], pred[1:])]
    if metric == "accumulate_trajectory":
        got = trajectory.accumulate_trajectory(rel_pred, T0=pred[0])
        want = jtrajectory.accumulate_trajectory(rel_pred, T0=pred[0])
    elif metric == "rpe":
        got, want = trajectory.rpe(pred, gt, delta=3), jtrajectory.rpe(pred, gt, delta=3)
    elif metric == "kitti_segment_errors":
        kw = dict(lengths=(1.0, 2.0, 4.0), step_size=5)
        got = trajectory.kitti_segment_errors(pred, gt, **kw)
        want = jtrajectory.kitti_segment_errors(pred, gt, **kw)
        assert len(want[0]) > 10
    elif metric == "scale_correction_factor":
        scaled = [T.copy() for T in rel_pred]
        for T in scaled:
            T[:3, 3] *= 0.4
        got = trajectory.scale_correction_factor(rel_gt, scaled)
        want = jtrajectory.scale_correction_factor(rel_gt, scaled)
        assert 2.0 < want < 3.0
    elif metric == "EvalTrajectory.metrics":
        ev, ev_j = EvalTrajectory(), JaxEvalTrajectory()
        for e in (ev, ev_j):
            for i in range(0, len(rel_pred), 8):
                e.update_state(np.stack(rel_pred[i:i + 8]), np.stack(rel_gt[i:i + 8]))
        got, want = ev.metrics(), ev_j.metrics()
        assert "ate_rmse" in want and "rpe_rot_mean_deg" in want
        ev.reset()
        assert ev.metrics() == {} and ev.trajectories()[1] is None
    else:
        kf_ids = list(range(0, 40, 3))
        gt_cw = np.linalg.inv(gt)
        got = ba_ablation.evaluate(pred, gt_cw, kf_ids)
        want = jax_ba_ablation.evaluate(pred, gt_cw, kf_ids)
        assert got == want and "kf_ate_rmse" in want
    _assert_close(got, want)


def _assert_close(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_close(a, b)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_ba_ablation_entry_point(tmp_path):
    """``python3 -m deep_visual_slam_torch.ba_ablation`` at 48x64 on the CPU
    writes the three configurations' numbers; ``--vo_ckpt`` and
    ``--frontend orb`` name what is not ported."""
    out = tmp_path / "ablation.json"
    ba_ablation.main(["--init", "oracle", "--frames", "6", "--size", "64", "96", "--seeds", "100",
                      "--device", "cpu", "--out_json", str(out)])
    record = json.loads(out.read_text())
    scene = record["per_scene"]["100"]
    assert sorted(scene) == ["no_ba", "windowed_ba", "windowed_plus_global_ba"]
    for m in scene.values():
        assert m["keyframes"] >= 3 and np.isfinite(m["kf_ate_rmse"])
    with pytest.raises(NotImplementedError, match="checkpoint"):
        ba_ablation.main(["--vo_ckpt", "weights/vo", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ORB"):
        ba_ablation.main(["--frontend", "orb", "--device", "cpu"])


@pytest.mark.parametrize("align", [True, False])
def test_ate_rmse_matches_jax(align):
    """ATE after a Umeyama sim(3) alignment and the unaligned RMSE (float64
    numpy on both sides): within 1e-12."""
    rng = np.random.default_rng(4)
    gt = np.tile(np.eye(4), (12, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(0, 0.05, (12, 3)), axis=0)
    pred = gt.copy()
    pred[:, :3, 3] = 1.7 * gt[:, :3, 3] @ np.linalg.qr(rng.normal(size=(3, 3)))[0] + 0.3
    pred[:, :3, 3] += rng.normal(0, 0.01, (12, 3))
    got = trajectory.ate_rmse(pred, gt, align)
    want = jtrajectory.ate_rmse(pred, gt, align)
    assert abs(got[0] - want[0]) <= 1e-12
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-12)
    for k, v in want[2].items():
        assert abs(got[2][k] - v) <= 1e-12, k


def test_device_image_cache_bounded_without_keyframes():
    """``register_device_image`` evicts at once: a sequence that adds no
    keyframes holds one image, not one per frame."""
    mp = Map(num_kf=3, device="cpu")
    img = torch.from_numpy(np.random.default_rng(0).uniform(size=(24, 32, 3)).astype(np.float32))
    for fid in range(20):
        mp.register_device_image(fid, img)
        assert len(mp._dev_images) <= len(mp.keyframes) + 1
    assert len(mp._dev_images) <= 1


def test_anchored_pose_propagation():
    """A BA write-back to a keyframe pose moves the non-keyframes anchored
    to it rigidly: relative poses inside the segment do not change (the
    KLT path's registration: ``register_keyframe`` and ``set_anchor``)."""
    m = Map(num_kf=4, device="cpu")
    img = np.zeros((H, W, 3), np.float32)
    depth = np.full((H, W), 2.0, np.float32)
    unc = np.zeros((H, W), np.float32)
    kps = (np.zeros((4, 2), np.int32), None)

    kf = Frame(m, img, depth, unc, np.eye(4), features=kps)
    m.register_keyframe(kf)
    assert kf.anchor is kf
    T1 = np.eye(4)
    T1[0, 3] = 0.1
    T2 = np.eye(4)
    T2[0, 3] = 0.2
    f1 = Frame(m, img, depth, unc, T1, features=kps)
    f1.set_anchor(m.keyframes[-1])
    f2 = Frame(m, img, depth, unc, T2, features=kps)
    f2.set_anchor(m.keyframes[-1])
    assert f1.anchor is kf and f2.anchor is kf
    before_rel = f2.current_pose() @ np.linalg.inv(f1.current_pose())

    corr = np.eye(4)
    corr[:3, :3] = np.array([[0.9950042, -0.0998334, 0], [0.0998334, 0.9950042, 0], [0, 0, 1]])
    corr[1, 3] = 0.05
    kf.pose = corr @ kf.pose
    np.testing.assert_allclose(f1.current_pose(), T1 @ corr, atol=1e-12)
    assert not np.allclose(f1.current_pose(), T1)
    np.testing.assert_allclose(f1.current_pose(), f1.T_rel_anchor @ kf.pose, atol=1e-12)
    after_rel = f2.current_pose() @ np.linalg.inv(f1.current_pose())
    np.testing.assert_allclose(after_rel, before_rel, atol=1e-12)
    np.testing.assert_allclose(kf.current_pose(), kf.pose, atol=1e-12)
    np.testing.assert_allclose(m.relative_to_global()[1], T1 @ corr, atol=1e-12)


def test_entry_points_refuse_what_is_not_there():
    """``device=None`` means CUDA: without a card ``MonoVO`` and
    ``KLTFrontend`` raise instead of running on the CPU. The ORB frontend
    is not ported: ``frontend="orb"`` and a ``Frame`` without keypoints
    raise."""
    K = synthetic.default_intrinsics(H, W)
    with pytest.raises(NotImplementedError, match="ORB"):
        MonoVO(K, frontend="orb", device="cpu")
    with pytest.raises(NotImplementedError, match="ORB"):
        Frame(Map(device="cpu"), np.zeros((H, W, 3)), None, None, np.eye(4))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        MonoVO(K, networks=Networks(dtype=torch.float32, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        KLTFrontend(Networks(dtype=torch.float32, device="cpu"), (H, W), K)
