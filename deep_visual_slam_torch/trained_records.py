"""The trained-checkpoint records on one card: fixture-length VO training,
then the BA ablations, the prior/Huber sweep and the fixture parity harness
on its checkpoint.

    python3 -m deep_visual_slam_torch.trained_records [--out results/trained_records] \\
        [--work build/trained_records]

One fixed sequence of stages:

  pack    ``pack_dataset --synthetic 24 --frames 96`` at 480x640 under
          ``<work>/packed`` (~2 GB)
  train   ``configs/vo_fixture_640.yaml`` for its full 12 epochs (B=8,
          bf16), in this process so that K1's launches are counted; the
          packed shards are deleted after it. Checkpoints stay under
          ``<work>/weights``, logs go under ``<out>/tb``
  drift   ``ba_ablation --init net``: seeds 100 and 101 x 300 frames at
          0.003 m and 0.0006 rad a step (KLT, the other settings at their
          defaults)
  kfrate  ``ba_ablation --init net``: seeds 100-102 x 60 frames at 0.0015 m
          and 0.0003 rad a step
  pareto  ``prior_pareto`` at its defaults
  parity  ``record_parity`` with its default stages, then ``--stages slam``
          on the trained checkpoint

Each record lands as ``<out>/<name>_<TAG>.json`` and carries, beside its
own provenance, the card's name and power limit (``nvidia-smi``), the
checkpoint's step and the trainer's summary (``<out>/trainer_<TAG>.json``:
steps, epochs, wall time, ms per iteration, frames/s, each epoch's mean
losses, K1's launches). Runs on the card (``--device cpu`` runs it on the
CPU, at a size cut through the module's constants and the protocol modules'
own, as ``tests/test_torch_trained_records.py`` does).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import torch

from deep_visual_slam_torch import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TAG = "torch_r13"  # the records' file suffix
CONFIG = os.path.join(ROOT, "configs", "vo_fixture_640.yaml")
PACK = dict(n_scenes=24, n_frames=96, size=(480, 640))
TRAIN_OVERRIDES: dict = {}  # merged over the config; a CPU run cuts it here
DRIFT = ["--frames", "300", "--seeds", "100", "101", "--step_translation", "0.003",
         "--step_rotation", "0.0006"]
KFRATE = ["--frames", "60", "--seeds", "100", "101", "102", "--step_translation", "0.0015",
          "--step_rotation", "0.0003"]


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(work: str, out: str, device: torch.device) -> dict:
    """The full-length VO run; returns its summary."""
    from deep_visual_slam_torch.ops.photometric_cuda import reprojection_loss as k1
    from deep_visual_slam_torch.training.vo_trainer import Trainer
    from deep_visual_slam_torch.utils.config import load_config

    config = load_config(CONFIG, overrides={
        "Directory": {"data_dir": os.path.join(work, "data") + "/",
                      "log_dir": os.path.join(out, "tb"),
                      "weights": os.path.join(work, "weights"),
                      "results": os.path.join(work, "results")},
        "Dataset": {"packed": {"mono": True, "root": os.path.join(work, "packed")}},
        **TRAIN_OVERRIDES,
    })
    trainer = Trainer(config, device=device, use_mesh=False)
    epochs, valid = [], {"launches": [0, 0], "seconds": 0.0}
    mark = {}

    def reset_mark():
        _sync(device)
        mark.update(t=time.perf_counter(), step=trainer.state.step,
                    launches=(k1.launches, k1.backward_launches))

    def on_phase(epoch, phase, metrics):
        # Each part of an epoch is timed and counted from the end of the one
        # before; a checkpoint's save only moves the mark.
        _sync(device)
        seconds = time.perf_counter() - mark["t"]
        launches = (k1.launches - mark["launches"][0],
                    k1.backward_launches - mark["launches"][1])
        if phase == "train":
            epochs.append({"epoch": epoch, "steps": int(trainer.state.step - mark["step"]),
                           "seconds": seconds, "launches": launches,
                           "losses": {k: float(v) for k, v in metrics.items()}})
            print(f"epoch {epoch}: {epochs[-1]['steps']} steps in {seconds:.1f} s", flush=True)
        elif phase == "valid":
            valid["seconds"] += seconds
            valid["launches"] = [a + b for a, b in zip(valid["launches"], launches)]
        reset_mark()

    k1.launches = k1.backward_launches = 0
    reset_mark()
    t0 = mark["t"]
    trainer.train(on_phase)
    _sync(device)
    wall = time.perf_counter() - t0
    steps = sum(e["steps"] for e in epochs)
    train_s = sum(e["seconds"] for e in epochs)
    t = config["Train"]
    fwd, bwd = (sum(e["launches"][i] for e in epochs) for i in (0, 1))
    summary = {
        "config": os.path.relpath(CONFIG, ROOT), "overrides": TRAIN_OVERRIDES,
        "size": [t["img_h"], t["img_w"]], "batch_size": t["batch_size"],
        "compute_dtype": t["compute_dtype"], "epochs": len(epochs), "steps": steps,
        "checkpoint": os.path.relpath(trainer.ckpt.directory),
        "checkpoint_step": trainer.ckpt.latest_step(),
        "wall_seconds": round(wall, 3), "train_seconds": round(train_s, 3),
        "validation_seconds": round(valid["seconds"], 3),
        "ms_per_iteration": round(1e3 * train_s / steps, 3),
        "frames_per_second": round(steps * t["batch_size"] / train_s, 2),
        "first_epoch_losses": epochs[0]["losses"], "last_epoch_losses": epochs[-1]["losses"],
        "per_epoch": [{"epoch": e["epoch"], "steps": e["steps"],
                       "seconds": round(e["seconds"], 3), "loss": e["losses"].get("loss")}
                      for e in epochs],
        "k1_launches": {"train_forward": fwd, "train_backward": bwd,
                        "validation_forward": valid["launches"][0],
                        "validation_backward": valid["launches"][1]},
        "k1_launches_per_step": [fwd / steps, bwd / steps],
    }
    return summary


def _stamp(path: str, extra: dict) -> None:
    """Add ``extra`` to the record at ``path``: into its provenance where
    that is a dict, else at its top level."""
    with open(path) as f:
        record = json.load(f)
    if isinstance(record.get("provenance"), dict):
        record["provenance"].update(extra)
    else:
        record.update(extra)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> None:
    from deep_visual_slam_torch import ba_ablation, pack_dataset, prior_pareto, record_parity

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="results/trained_records")
    ap.add_argument("--work", default="build/trained_records")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must be present)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out, work = args.out, args.work
    os.makedirs(out, exist_ok=True)
    card = card_line(device)
    print(card, flush=True)
    seconds = {}

    def stage(name):
        seconds[name] = time.perf_counter()
        print(f"== {name}", flush=True)

    def done(name):
        seconds[name] = round(time.perf_counter() - seconds[name], 1)
        print(f"== {name}: {seconds[name]} s", flush=True)

    stage("pack")
    pack_dataset.pack_synthetic(os.path.join(work, "packed"), PACK["n_scenes"],
                                PACK["n_frames"], PACK["size"], device=device)
    done("pack")
    stage("train")
    summary = train(work, out, device)
    shutil.rmtree(os.path.join(work, "packed"), ignore_errors=True)
    summary["card"] = card
    with open(os.path.join(out, f"trainer_{TAG}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    done("train")
    print(json.dumps(summary), flush=True)
    ckpt = summary["checkpoint"]
    stamp = {"card": card, "checkpoint_step": summary["checkpoint_step"],
             "trainer": {k: summary[k] for k in (
                 "config", "epochs", "steps", "batch_size", "wall_seconds",
                 "ms_per_iteration", "frames_per_second", "card")}}

    for name, argv_ in (("drift", DRIFT), ("kfrate", KFRATE)):
        stage(name)
        path = os.path.join(out, f"ba_ablation_{name}_{TAG}.json")
        ba_ablation.main(["--vo_ckpt", ckpt, "--init", "net", "--out_json", path,
                          "--device", str(device), *argv_])
        _stamp(path, stamp)
        done(name)
    stage("pareto")
    path = os.path.join(out, f"prior_pareto_{TAG}.json")
    prior_pareto.main(["--vo_ckpt", ckpt, "--out_json", path, "--device", str(device)])
    _stamp(path, stamp)
    done("pareto")
    stage("parity")
    parity = os.path.join(work, "parity")
    shutil.rmtree(parity, ignore_errors=True)
    record_parity.main(["--out", parity, "--device", str(device)])
    record_parity.main(["--out", parity, "--stages", "slam", "--vo_ckpt", ckpt,
                        "--device", str(device)])
    path = os.path.join(out, f"parity_results_{TAG}.json")
    shutil.copy(os.path.join(parity, "parity_results.json"), path)
    _stamp(path, stamp)
    done("parity")
    print(json.dumps({"card": card, "stage_seconds": seconds}), flush=True)


if __name__ == "__main__":
    main()
