"""The harness end to end on the CPU at small sizes: cells found by name,
the verdict on sound runs, on planted faults and on the fp8 control, the
import guard, and the refusal to run without the cards a cell asks for."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, cells, check, run

ROOT = Path(__file__).resolve().parents[2]


# The four-card cell whose traffic, limits and metric the benchmark keeps
# for a later change to list (PERF.md, Open questions).
DDP_CELL = {"name": "vo_train.ddp4.b64", "config": "monodepth2_r18_640",
            "traffic": "ddp4_b16_pool8", "chips": 4, "why": "DDP over four ranks"}


def _copy_root(tmp: Path, compute_dtype=None) -> Path:
    """BENCHMARK.json, with the four-card cell added, and benchmark/ in a
    temporary root (the configurations at ``compute_dtype`` where given)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if DDP_CELL["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(DDP_CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("out", "tests", "__pycache__"))
    if compute_dtype:
        for path in (tmp / "benchmark" / "configs").glob("*.json"):
            config = json.loads(path.read_text())
            config["compute_dtype"] = compute_dtype
            path.write_text(json.dumps(config))
    return tmp


def _run(root: Path, *args, timeout=900):
    # Two threads a process: the test workers share the machine's cores.
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--device", "cpu", "--root", str(root), *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_added_cell_and_metric_are_found_by_name(tmp_path):
    root = _copy_root(tmp_path)
    before = _digests(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "vo_train.b2", "config": "monodepth2_r18_640",
                               "traffic": "closed_b2_pool3", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step entry",
                               "moves": "train_samples_per_s", "workloads": ["vo_train.b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "traffic" / "closed_b2_pool3.json").write_text(json.dumps(
        {"loop": "closed", "ranks": 1, "batch_per_rank": 2, "pool": 3, "warmup_steps": 1,
         "trace_steps": 2}))
    (root / "benchmark" / "limits" / "vo_train.b2.json").write_text(
        (root / "benchmark" / "limits" / "vo_train.b16.json").read_text())
    (root / "benchmark" / "metrics" / "steps_traced.py").write_text(
        "def read(run):\n    return run.traces[0]['steps']\n")
    cell = cells.load("vo_train.b2", root)
    assert [m["name"] for m in cell.per_layer][-1] == "steps_traced"
    line, _ = _run(root, "--workload", "vo_train.b2", "--seed", "9", "--seconds", "0.2",
                   "--trace", "1", "--size", "2x64x64")
    assert line["metrics"]["steps_traced"] == {"value": 2, "unit": "steps"}
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "check"}
    after = _digests(root)
    changed = [p for p, d in before.items() if after.get(p) != d]
    assert changed == [Path("BENCHMARK.json")]


@pytest.mark.parametrize("workload, fault, size", [
    ("vo_train.b16", None, "4x64x96"),
    ("vo_train.b16", "unchanged", "4x64x96"),
    ("vo_train.b16", "half_batch", "4x64x96"),
    ("vo_train.b16", "half_loss", "4x64x96"),
    ("depth_train.b64", None, "4x64x96"),
    ("depth_train.b64", "unchanged", "4x64x96"),
    ("depth_train.b64", "half_batch", "4x64x96"),
    ("depth_train.b64", "half_loss", "4x64x96"),
    ("vo_train.ddp4.b64", None, "1x64x64"),
    ("vo_train.ddp4.b64", "no_exchange", "1x64x64"),
])
def test_a_planted_fault_is_not_correct(tmp_path, workload, fault, size):
    """A whole run at a small size with the program in fp32: sound, it is
    correct under the cell's limits; with a fault under the timed path,
    it is not."""
    root = _copy_root(tmp_path, compute_dtype="float32")
    args = ["--workload", workload, "--seed", "2147483659", "--seconds", "0.2",
            "--size", size]
    line, err = _run(root, *args, *(["--fault", fault] if fault else []))
    assert line["correct"] is (fault is None), err[-2000:]
    assert err.strip().splitlines()[-1].startswith("check ")


def test_ddisp_reads_one_on_the_rows_a_loss_leaves_out():
    """Per sample, the norm of the gradient reaching its disparities at
    every scale (each tensor: the norms of one scale's rows)."""
    ref = [torch.tensor([1.0, 2.0, 3.0, 4.0]), torch.tensor([1.0, 1.0, 1.0, 1.0])]
    assert check._sample_gaps([r.clone() for r in ref], ref) == [0.0] * 4
    keep = torch.tensor([2.0, 2.0, 0.0, 0.0])
    assert check._sample_gaps([r * keep for r in ref], ref) == pytest.approx([1.0] * 4)
    assert check._sample_gaps([r[:2] for r in ref], ref) == [float("inf")]
    assert check._sample_gaps([ref[0], None], ref) == [float("inf")]


@pytest.mark.parametrize("workload", ["vo_train.b16", "depth_train.b64"])
def test_the_fp8_control_is_not_correct(workload):
    cell = cells.load(workload)
    got = calibrate.readings(cell, 2147483671, ["control"], torch.device("cpu"),
                             size=(2, 64, 96))
    ok, lines = check.verdict(check.numbers(got["control"], got["reference"]), cell.limits)
    assert not ok, lines


def test_the_import_guard(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "deep_visual_slam_tpu", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "jax_helpers", object())
    assert run.forbidden_modules() == ["deep_visual_slam_tpu", "jaxlib"]
    code = run.main(["--workload", "depth_train.b64", "--seed", "3", "--seconds", "0.1",
                     "--device", "cpu", "--size", "2x64x64"])
    assert code == 3
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "deep_visual_slam_tpu, jaxlib" in captured.err


def test_no_result_without_the_cards(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "vo_train.b16", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "vo_train.b16",
                          "--seed", "2147483693", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"train_samples_per_s", "step_ms_p95", "peak_mem_gib",
                                    "setup_s"}
