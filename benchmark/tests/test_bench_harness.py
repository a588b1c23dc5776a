"""The harness end to end on the CPU at small sizes: cells found by name,
a network that is not DepthNet added from new files alone, the verdict on
sound runs, on planted faults and on the fp8 control, the import guard, and
the refusal to run without the cards a cell asks for."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import calibrate, cells, check, inputs, run, training, yardsticks

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


def _in_process(monkeypatch, root: Path, *args):
    """``benchmark.run`` in this process on the CPU; its cache directories
    are put back after the test."""
    for key in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.delenv(key, raising=False)
    return run.main(["--device", "cpu", "--root", str(root), *args])


# A stand-in for a network that is not DepthNet, as a later configuration
# brings it: its driver (the program's side: a module with a constant
# buffer, a patch convolution, a token mix by one matrix product, a
# transposed convolution back to the image and a lone [B, H, W] depth, under
# a plain Adam step) and its plain reference.
STANDIN_DRIVER = '''
from types import SimpleNamespace

import torch

from benchmark import cells, inputs
from benchmark.reference import train
from benchmark.training import Networks, TrainDriver


class StandIn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("mean", torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1))
        self.register_buffer("std", torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1))
        self.patch = torch.nn.Conv2d(3, 8, 7, stride=7)
        self.mix = torch.nn.Linear(8, 8)
        self.up = torch.nn.ConvTranspose2d(8, 4, 7, stride=7)
        self.head = torch.nn.Conv2d(4, 1, 3, padding=1)

    def forward(self, image):
        x = self.patch((image.permute(0, 3, 1, 2) - self.mean) / self.std)
        B, C, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)
        t = t + torch.relu(self.mix(t))
        x = torch.relu(self.up(t.transpose(1, 2).reshape(B, C, h, w)))
        return 10 * torch.sigmoid(self.head(x))[:, 0]


class Driver(TrainDriver):
    def networks(self):
        if self.config["networks"] != "standin":
            return super().networks()
        ref = cells.reference(self.cell, "standin")

        def steps(weights, batches, noises, precision):
            return train.run_steps(ref.loss_and_grads, weights, batches, noises, self.optim,
                                   precision)

        return Networks([("standin." + n, s, k) for n, s, k in ref.spec()], steps, ref.flops)

    def build_models(self):
        return {"standin.": StandIn().to(self.device)}

    def build_step(self, mesh):
        model = self.models["standin."]
        opt = torch.optim.Adam(model.parameters(), lr=self.optim["lr"],
                               betas=(self.optim["beta1"], 0.999))

        def step(batch):
            valid = batch["valid_mask"][..., 0]
            diff = torch.log(model(batch["image"])) - torch.log(batch["depth"][..., 0])
            loss = (diff ** 2 * valid).sum() / valid.sum()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return {"loss": loss.detach()}

        return SimpleNamespace(optimizer=opt), step

    def draw_entry(self, gen_batch, gen_noise, B):
        return {"batch": inputs.depth_batch(gen_batch, B, self.height, self.width, self.device),
                "noise": None}

    def call_step(self, entry):
        return self.train_step(entry["batch"])
'''

STANDIN_REFERENCE = '''
import torch

from benchmark.reference import nets


def spec():
    return [("patch.weight", (8, 3, 7, 7), "weight"), ("patch.bias", (8,), "bias"),
            ("mix.weight", (8, 8), "weight"), ("mix.bias", (8,), "bias"),
            ("up.weight", (8, 4, 7, 7), "weight"), ("up.bias", (4,), "bias"),
            ("head.weight", (1, 4, 3, 3), "weight"), ("head.bias", (1,), "bias")]


def forward(P, image, pr=nets.FP32):
    mean = image.new_tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = image.new_tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    x = pr.conv((image.permute(0, 3, 1, 2) - mean) / std, P["patch.weight"], P["patch.bias"], 7)
    B, C, h, w = x.shape
    t = x.flatten(2).transpose(1, 2)
    t = t + torch.relu(pr.matmul(t, P["mix.weight"].t()) + P["mix.bias"])
    x = torch.relu(pr.conv_transpose(t.transpose(1, 2).reshape(B, C, h, w), P["up.weight"],
                                     P["up.bias"], 7))
    return 10 * torch.sigmoid(pr.conv(x, P["head.weight"], P["head.bias"], 1, 1))[:, 0]


def loss_and_grads(params, batch, noise, precision):
    P = {k[len("standin."):]: v for k, v in params.items()}
    depth = forward(P, batch["image"], precision)
    leaf = depth.detach().requires_grad_()
    valid = batch["valid_mask"][..., 0]
    diff = torch.log(leaf) - torch.log(batch["depth"][..., 0])
    loss = (diff ** 2 * valid).sum() / valid.sum()
    loss.backward()
    depth.backward(leaf.grad)
    return loss.detach(), [depth.detach()], [leaf.grad]


def flops(batch, height, width):
    return 3 * nets.forward_flops(spec(), forward, (batch, height, width, 3))
'''

# The stand-in's step over [2, 42, 42] by hand, 2 a multiply-add, times 3:
# the patch conv (2 x 8 x 6 x 6 outputs of 3 x 7 x 7), the token mix
# (2 x 36 x 8 outputs of 8), the transposed conv (2 x 6 x 6 inputs times
# its 8 x 4 x 7 x 7 kernel) and the head (2 x 42 x 42 outputs of 4 x 3 x 3).
STANDIN_FLOPS = 3 * 2 * (2 * 8 * 36 * 147 + 2 * 36 * 8 * 8 + 2 * 36 * 1568 + 2 * 1764 * 36)


def _add_standin(root: Path) -> None:
    """The stand-in's configuration, cell, driver, reference and limits, as
    new files and entries."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "standin_42", "source": "a test",
                             "file": "benchmark/configs/standin_42.json", "reduced": [],
                             "why": "a network that is not DepthNet"})
    bench["workloads"].append({"name": "standin_train.b2", "config": "standin_42",
                               "traffic": "closed_b64_pool4", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    bench_dir = root / "benchmark"
    (bench_dir / "configs" / "standin_42.json").write_text(json.dumps(
        {"name": "standin_42", "driver": "standin_train", "networks": "standin", "height": 42,
         "width": 42, "compute_dtype": "float32",
         "optimizer": {"name": "adam", "lr": 1e-3, "beta1": 0.9, "weight_decay": 0.0}}))
    (bench_dir / "drivers" / "standin_train.py").write_text(STANDIN_DRIVER)
    (bench_dir / "reference" / "standin.py").write_text(STANDIN_REFERENCE)
    (bench_dir / "limits" / "standin_train.b2.json").write_text(json.dumps(
        {"fwd": 1e-3, "ddisp": 1e-2, "loss": 1e-3, "grad": 1e-2, "change": 0.05}))


def test_a_new_network_enters_from_files_alone(tmp_path, monkeypatch, capsys):
    """A network with a lone [B, H, W] output, a buffer that is not
    BatchNorm's, a matrix product and a transposed convolution, at a size
    that is no multiple of 32: its weights, reference steps and FLOP count
    come from its own driver and reference; no file the benchmark has
    changes but BENCHMARK.json."""
    root = _copy_root(tmp_path)
    before = _digests(root)
    _add_standin(root)
    args = ["--workload", "standin_train.b2", "--seed", "2147483677", "--seconds", "0.2",
            "--size", "2x42x42"]
    # Sound and traced, in this process: at a stated peak of 1 TFLOP/s the
    # CPU's run reads step_mfu_pct, and the window's steps and seconds.
    windows = []

    def window(*a, **k):
        windows.append(run_window(*a, **k))
        return windows[-1]

    run_window = run.run_window
    monkeypatch.setattr(run, "run_window", window)
    monkeypatch.setattr(yardsticks, "card_peaks", lambda card: {
        "bytes_per_s": 1e12, "fp32_flops": 1e12, "bf16_flops": 1e12})
    assert _in_process(monkeypatch, root, *args, "--trace", "1") == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, err[-2000:]
    w = windows[0]
    assert line["metrics"]["step_mfu_pct"]["value"] == pytest.approx(
        100.0 * w["steps"] * STANDIN_FLOPS / (w["seconds"] * 1e12), rel=1e-12)
    for fault in ("half_batch", "half_loss"):
        line, err = _run(root, *args, "--fault", fault)
        assert line["correct"] is False, err[-2000:]
    after = _digests(root)
    changed = [p for p, d in before.items() if after.get(p) != d]
    assert changed == [Path("BENCHMARK.json")]


@pytest.mark.parametrize("workload, config", [("depth_train.b64", "depthnet_r18_sup_640"),
                                              ("standin_train.b2", "standin_42")])
def test_a_network_nothing_defines_fails_before_any_step(tmp_path, monkeypatch, workload,
                                                         config):
    """The base driver refuses a ``networks`` it does not know, and so does
    a new driver, which hands any but its own on to it: at set-up, before a
    weight is drawn or a step runs, naming the configuration."""
    root = _copy_root(tmp_path)
    _add_standin(root)
    path = root / "benchmark" / "configs" / f"{config}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), networks="nonesuch")))
    calls = []
    monkeypatch.setattr(inputs, "draw_weights", lambda *a, **k: calls.append("draw"))
    monkeypatch.setattr(training.TrainDriver, "step", lambda *a, **k: calls.append("step"))
    with pytest.raises(SystemExit, match=f"configuration '{config}'.*'nonesuch'"):
        _in_process(monkeypatch, root, "--workload", workload, "--seed", "5", "--seconds",
                    "0.1", "--size", "2x64x64")
    assert calls == []


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
    # The cell's end-to-end metrics alone (on the CPU memory reads none, and
    # a short window may give no percentile); one held under a bound of its
    # own reads as the metric it copies.
    metrics = line["metrics"]
    names = {m["name"] for m in cells.load(workload, root).end_to_end}
    assert "train_samples_per_s" in metrics and set(metrics) <= names
    for name in names:
        base = name.rsplit(".", 1)[0]
        if base != name:
            assert metrics.get(name) == metrics.get(base)


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
