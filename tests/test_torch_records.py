"""The scripts that record the trained checkpoint's numbers, on the CPU.

- ``prior_pareto`` at 64x96 (one seed, 6 frames, a 1x1 grid beside
  ``no_ba``) equals ``ba_ablation.run_once``/``evaluate`` called directly on
  the same networks and scene, and its percentages follow from them.
- ``record_parity --stages data slam`` on two 5-frame scenes at 64x96
  (set through the module's constants) from a params-only file writes the
  Redwood-layout tree the port's readers take, and a record under the JAX
  package's names (those of ``docs/parity_results_r05.json``).
- ``record_parity``'s NYU-layout fixture at 64x96 is byte-equal, file by
  file, to the one the JAX script writes at the same size.

64x96 rather than 48x64: DepthNet's skip connections need sides divisible
by 32. No JAX computation runs (the NYU fixture is numpy and cv2 on both
sides).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from deep_visual_slam_torch import ba_ablation, prior_pareto, record_parity
from deep_visual_slam_torch.data import synthetic_multidepth_sequence, synthetic_slam_sequence
from deep_visual_slam_torch.data.redwood import load_posegraph_json
from deep_visual_slam_torch.slam import Networks
from deep_visual_slam_torch.training.state import init_vo_models
from deep_visual_slam_torch.utils.checkpoint import save_params_only

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
H, W = 64, 96


def test_prior_pareto_equals_the_ablation_called_directly(tmp_path):
    out = tmp_path / "pareto.json"
    record = prior_pareto.main([
        "--size", str(H), str(W), "--seeds", "100", "--frames", "6", "--weights", "1000",
        "--deltas", "0.11", "--device", "cpu", "--out_json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(record))
    assert list(record["per_config"]) == ["no_ba", "w1000_d0.11"]
    assert record["provenance"]["weights"] == "random-init"

    nn = Networks(seed=0, device="cpu")
    frames, K, gt_cw, _ = synthetic_multidepth_sequence(6, H, W, seed=100, step_translation=0.02,
                                                        step_rotation=0.004)
    want = {}
    for name, optimize in (("no_ba", False), ("w1000_d0.11", True)):
        traj, kf_ids, _ = ba_ablation.run_once(lambda: nn, frames, K, optimize, False,
                                               pose_prior_weight=1e3, huber_delta=0.11)
        want[name] = ba_ablation.evaluate(traj, gt_cw, kf_ids)
        assert record["per_config"][name]["per_seed"] == [want[name]]
    got = record["per_config"]["w1000_d0.11"]["mean"]
    assert got["ate_vs_no_ba_pct"] == round(
        100 * (want["w1000_d0.11"]["ate_rmse"] / want["no_ba"]["ate_rmse"] - 1), 1)
    assert got["rpe_pos_vs_no_ba_pct"] == round(
        100 * (want["w1000_d0.11"]["rpe_pos_mean"] / want["no_ba"]["rpe_pos_mean"] - 1), 1)


def test_record_parity_data_and_slam_keep_the_jax_names(tmp_path, monkeypatch):
    monkeypatch.setattr(record_parity, "SCENES", record_parity.SCENES[:2])
    monkeypatch.setattr(record_parity, "H", H)
    monkeypatch.setattr(record_parity, "W", W)
    monkeypatch.setattr(record_parity, "N_FRAMES", 5)
    monkeypatch.setattr(record_parity, "NYU_TRAIN", 3)
    monkeypatch.setattr(record_parity, "NYU_TEST", 2)
    weights = str(tmp_path / "vo.pt")
    save_params_only({name: m.state_dict() for name, m in zip(("depth", "pose"),
                                                             init_vo_models(3))}, weights)
    out = tmp_path / "parity"
    results = record_parity.main(["--out", str(out), "--stages", "data", "slam", "--vo_ckpt",
                                  weights, "--device", "cpu"])
    assert json.loads((out / "parity_results.json").read_text()) == json.loads(
        json.dumps(results))

    # The tree: the PoseGraph holds the renders' camera-to-world poses.
    _, K, poses_cw = synthetic_slam_sequence(5, H, W, seed=101, step_translation=0.02,
                                             step_rotation=0.004, device="cpu")
    scene = out / "fixture" / "redwood" / "test" / "bedroom"
    np.testing.assert_allclose(load_posegraph_json(str(scene / "bedroom.json")),
                               np.linalg.inv(poses_cw), atol=1e-12)
    assert len(list((scene / "image").glob("*.jpg"))) == 5
    np.testing.assert_array_equal(np.load(out / "fixture" / "redwood" / "intrinsic.npy"),
                                  K[:3, :3])
    assert len(list((out / "fixture" / "nyu_depth_v2" / "test").iterdir())) == 4

    jax = json.loads((ROOT / "docs" / "parity_results_r05.json").read_text())
    assert {"provenance", "device", "timestamp", "slam_fixture"} == set(results)
    slam, jax_slam = results["slam_fixture"], jax["slam_fixture"]
    assert set(slam) == set(jax_slam) and slam["vo_ckpt"] == weights
    assert list(slam["per_scene"]) == ["apartment", "bedroom"]
    for name, runs in slam["per_scene"].items():
        assert set(runs) == set(jax_slam["per_scene"][name])
        for kind, metrics in runs.items():
            assert set(metrics) == set(jax_slam["per_scene"][name][kind])
            assert all(np.isfinite(v) for v in metrics.values())
    assert {k: set(v) for k, v in slam["mean"].items()} == {
        k: set(v) for k, v in jax_slam["mean"].items()}
    with pytest.raises(SystemExit):
        record_parity.main(["--out", str(out), "--stages", "slam", "--device", "cpu"])


def test_record_parity_nyu_fixture_equals_the_jax_scripts(tmp_path, monkeypatch):
    from scripts import record_parity as jax_parity

    for module in (record_parity, jax_parity):
        monkeypatch.setattr(module, "H", H)
        monkeypatch.setattr(module, "W", W)
    record_parity.make_nyu_fixture(str(tmp_path / "torch"), n_train=3, n_test=2)
    jax_parity.make_nyu_fixture(str(tmp_path / "jax"), n_train=3, n_test=2)
    for split, n in (("train", 3), ("test", 2)):
        names = sorted(p.name for p in (tmp_path / "jax" / "nyu_depth_v2" / split).iterdir())
        assert names == sorted(
            p.name for p in (tmp_path / "torch" / "nyu_depth_v2" / split).iterdir())
        assert len(names) == 2 * n
        for name in names:  # exact: every rgb JPEG and depth PNG, byte for byte
            assert (tmp_path / "torch" / "nyu_depth_v2" / split / name).read_bytes() == (
                tmp_path / "jax" / "nyu_depth_v2" / split / name).read_bytes(), name
