"""The trained-checkpoint records driver (``trained_records.main``) on the
CPU, cut to 64x96: packing 3 scenes of 10 frames, one training epoch at B=2
in fp32 with its validation, the drift and key-frame-rate protocols on one
seed of 5 frames, the sweep on one grid point and the parity harness on one
5-frame scene.

- Every record lands under ``--out`` with the card (``cpu``), the
  checkpoint's step and the trainer's summary stamped into its provenance;
  the checkpoint is the one the trainer wrote, and every protocol ran on it.
- The trainer's summary counts the run's steps and K1's launches apart in
  training and validation. The plain path stands in for the kernels here:
  it counts each call as the wrapper's forward launch and each input it
  differentiates as a backward launch, as the card's kernels do, so that a
  train step counts 10 + 8 and a validation step 10 + 0.
- The packed shards are deleted after training.

No JAX computation runs.
"""

import json

import numpy as np
import torch

from deep_visual_slam_torch import prior_pareto, record_parity, trained_records
from deep_visual_slam_torch.ops import photometric_cuda
from deep_visual_slam_torch.utils.checkpoint import load_network_states

torch.set_num_threads(1)

H, W = 64, 96
FRAMES = ["--frames", "5", "--seeds", "100", "--size", str(H), str(W)]


def _counting_plain(monkeypatch):
    k1, plain = photometric_cuda.reprojection_loss, photometric_cuda.reprojection_loss_plain

    def counted(pred, target, ssim_ratio=0.85):
        out = plain(pred, target, ssim_ratio)
        k1.launches += 1
        inputs = int(pred.requires_grad) + int(target.requires_grad)
        if out.requires_grad and inputs:
            def backward(g):
                k1.backward_launches += inputs
            out.register_hook(backward)
        return out

    monkeypatch.setattr(photometric_cuda, "reprojection_loss_plain", counted)


def _cut(monkeypatch):
    monkeypatch.setattr(trained_records, "PACK", dict(n_scenes=3, n_frames=10, size=(H, W)))
    monkeypatch.setattr(trained_records, "TRAIN_OVERRIDES", {"Train": {
        "img_h": H, "img_w": W, "epoch": 1, "batch_size": 2, "compute_dtype": "float32",
        "valid_freq": 1, "num_workers": 0}})
    monkeypatch.setattr(trained_records, "DRIFT", [*trained_records.DRIFT, *FRAMES])
    monkeypatch.setattr(trained_records, "KFRATE", [*trained_records.KFRATE, *FRAMES])
    pareto = prior_pareto.main
    monkeypatch.setattr(prior_pareto, "main", lambda argv: pareto(
        [*argv, *FRAMES, "--weights", "1000", "--deltas", "0.11"]))
    for name, value in (("SCENES", record_parity.SCENES[:1]), ("H", H), ("W", W),
                        ("N_FRAMES", 5), ("NYU_TRAIN", 2), ("NYU_TEST", 2)):
        monkeypatch.setattr(record_parity, name, value)
    vo_config, depth_config = record_parity.vo_config, record_parity.depth_config

    def cut_train(cfg):
        cfg["Train"].update(img_h=H, img_w=W, batch_size=2, epoch=1, num_workers=0)
        return cfg

    def cut_vo(out_root):
        cfg = cut_train(vo_config(out_root))
        cfg["Dataset"]["synthetic"]["length"] = 8
        return cfg

    monkeypatch.setattr(record_parity, "vo_config", cut_vo)
    monkeypatch.setattr(record_parity, "depth_config",
                        lambda out_root, fixture_root, epochs=3: cut_train(
                            depth_config(out_root, fixture_root, epochs=1)))


def test_trained_records_runs_every_stage_and_stamps_each_record(tmp_path, monkeypatch):
    _cut(monkeypatch)
    _counting_plain(monkeypatch)
    out, work = tmp_path / "records", tmp_path / "work"
    trained_records.main(["--device", "cpu", "--out", str(out), "--work", str(work)])

    summary = json.loads((out / "trainer_torch_r13.json").read_text())
    assert summary["card"] == "cpu" and summary["epochs"] == 1
    assert summary["size"] == [H, W] and summary["batch_size"] == 2
    steps = summary["steps"]
    assert steps > 0 and summary["checkpoint_step"] == steps
    assert [e["steps"] for e in summary["per_epoch"]] == [steps]
    assert np.isfinite(summary["first_epoch_losses"]["loss"])
    assert summary["ms_per_iteration"] > 0 and summary["frames_per_second"] > 0
    assert summary["wall_seconds"] >= summary["train_seconds"] + summary["validation_seconds"]
    launches = summary["k1_launches"]
    assert (launches["train_forward"], launches["train_backward"]) == (10 * steps, 8 * steps)
    assert summary["k1_launches_per_step"] == [10, 8]
    assert launches["validation_forward"] > 0 and launches["validation_forward"] % 10 == 0
    assert launches["validation_backward"] == 0
    _, step = load_network_states(summary["checkpoint"])
    assert step == steps
    assert not (work / "packed").exists()

    stamp = {"card": "cpu", "checkpoint_step": steps}
    for name in ("ba_ablation_drift", "ba_ablation_kfrate", "prior_pareto", "parity_results"):
        record = json.loads((out / f"{name}_torch_r13.json").read_text())
        provenance = record["provenance"] if isinstance(record["provenance"], dict) else record
        assert {k: provenance[k] for k in stamp} == stamp, name
        assert provenance["trainer"]["steps"] == steps, name
        assert provenance["trainer"]["card"] == "cpu", name
    for name, step_t in (("drift", 0.003), ("kfrate", 0.0015)):
        record = json.loads((out / f"ba_ablation_{name}_torch_r13.json").read_text())
        assert record["provenance"]["weights"] == summary["checkpoint"]
        assert f"1 seeds x 5 frames, {W}x{H}, step_translation={step_t}" in (
            record["provenance"]["data"])
    pareto = json.loads((out / "prior_pareto_torch_r13.json").read_text())
    assert pareto["provenance"]["weights"] == summary["checkpoint"]
    assert list(pareto["per_config"]) == ["no_ba", "w1000_d0.11"]
    parity = json.loads((out / "parity_results_torch_r13.json").read_text())
    assert parity["slam_fixture"]["vo_ckpt"] == summary["checkpoint"]
    assert {"warmstart", "redwood", "redwood_pose_dtype", "depth"} <= set(parity)
    assert parity["redwood_pose_dtype"] == "float32"
