"""The program's spans in the traced run (``benchmark/spans.py``) and the
five metrics that read them, against a chrome trace made by hand."""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import cells, spans

BASE_US = 5_000_000.0  # the trace's baseTimeNanoseconds, in us
WINDOW = (BASE_US + 100, BASE_US + 200)
STEPS = 2

# The program's spans on the realtime clock: (name, start, duration, depth).
PROGRAM = [
    ("net.depth.fwd", BASE_US + 110, 20.0, 1),
    ("loss.photometric", BASE_US + 130, 20.0, 1),
    ("optimizer", BASE_US + 160, 10.0, 1),
    ("step", BASE_US + 100, 90.0, 0),
]

# (name, category, device start, duration, correlation, launch category,
# launch time), times relative to the base: a launch at None is absent.
OPS = [
    ("sm90_xmma_fprop_implicit_gemm_bf16", "kernel", 115, 10, 1, "cuda_driver", 112),
    ("void reprojection_loss_kernel<3>", "kernel", 135, 5, 2, "cuda_runtime", 131),
    ("void at::native::elementwise_kernel<128, 2>", "kernel", 156, 2, 3, "cuda_runtime", 155),
    ("void at::native::multi_tensor_apply_kernel<...>", "kernel", 166, 4, 4, "cuda_runtime", 165),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 180, 1, 5, None, None),
    ("void at::native::vectorized_elementwise_kernel<4>", "kernel", 195, 2, 6, "cuda_runtime",
     195),
]


def _trace(tmp_path):
    events = [{"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 7,
               "ts": 115, "dur": 60}]
    for name, cat, ts, dur, corr, launch_cat, launched in OPS:
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts,
                       "dur": dur, "args": {"correlation": corr}})
        if launch_cat:
            events += [{"ph": "X", "cat": launch_cat, "name": "cudaLaunchKernel", "pid": 1,
                        "tid": 1, "ts": launched, "dur": 1, "args": {"correlation": corr}},
                       {"ph": "s", "cat": "ac2g", "id": corr, "ts": launched}]
    path = tmp_path / "spans.rank0.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": int(BASE_US * 1e3),
                                "traceEvents": events}))
    spans._add_spans(path, PROGRAM, WINDOW, STEPS)
    return path


def _run(*programs):
    return SimpleNamespace(span_windows=list(programs))


def test_each_operation_goes_to_the_span_open_at_its_launch(tmp_path):
    program = spans.load(_trace(tmp_path))
    assert program["window_us"] == WINDOW and program["steps"] == STEPS
    assert sorted(program["spans"]) == sorted(PROGRAM)
    assert spans.op_labels(program) == ["net.depth.fwd", "loss.photometric", "step",
                                        "optimizer", "unmatched", "outside"]
    # A kernel launched inside ``step`` alone, or outside every span, counts
    # in no layer; the one without a launch event, in none either.
    assert spans.split(program)["device"] == {
        "net.depth.fwd": 10, "loss.photometric": 5, "step": 2, "optimizer": 4,
        "unmatched": 1, "outside": 2}


def test_idle_time_is_split_between_the_spans_and_adds_up(tmp_path):
    program = spans.load(_trace(tmp_path))
    idle = spans.split(program)["idle"]
    # [125, 135] crosses net.depth.fwd (125-130) and loss.photometric
    # (130-135); [181, 195] crosses the step's end at 190.
    assert idle == {"step": 10 + 6 + 2 + 10 + 9, "net.depth.fwd": 5 + 5,
                    "loss.photometric": 5 + 10, "optimizer": 6, "outside": 5 + 3}
    busy = 10 + 5 + 2 + 4 + 1 + 2
    assert sum(idle.values()) == pytest.approx(100 - busy)
    report = spans.report(program)
    assert report["window_idle_ms"] == pytest.approx((100 - busy) / 1e3 / STEPS)
    assert sum(report["idle_ms"].values()) == pytest.approx(report["window_idle_ms"])
    assert sum(report["device_ms"].values()) == pytest.approx(report["window_device_ms"])
    assert report["groups"]["K1 reprojection_loss_kernel"] == {
        "loss.photometric": pytest.approx(5 / 1e3 / STEPS)}
    assert report["groups"]["cuDNN convolution"] == {"net.depth.fwd": pytest.approx(0.005)}
    assert report["groups"]["Adam (foreach)"] == {"optimizer": pytest.approx(0.002)}
    assert report["launches_found"] == 5 and report["ops"] == 6
    assert report["launches"] == {label: pytest.approx(1 / STEPS) for label in (
        "net.depth.fwd", "loss.photometric", "step", "optimizer", "unmatched", "outside")}


@pytest.mark.parametrize("metric, us", [
    ("net_ms", 10), ("loss_ms", 5), ("optimizer_ms", 4), ("net_idle_ms", 10),
    ("loss_idle_ms", 15)])
def test_the_five_metrics(tmp_path, metric, us):
    read = cells.metric_reader(cells.load("vo_train.b16"), metric)
    program = spans.load(_trace(tmp_path))
    assert read(_run(program)) == pytest.approx(us / 1e3 / STEPS)
    # The mean over the ranks: a second rank with twice as many steps.
    assert read(_run(program, dict(program, steps=2 * STEPS))) == pytest.approx(
        0.75 * us / 1e3 / STEPS)
    # Nothing from a program without spans, or a trace without the device.
    assert read(_run()) is None
    assert read(_run(dict(program, ops=[]))) is None


def test_the_window_records_the_programs_spans_on_the_cpu(tmp_path):
    """The harness's traced window over a stand-in step that opens the
    program's spans: the running profiler turns them on, the readers find
    them in the trace on disk, and the CPU trace holds no device
    operation. A program without spans gives nothing."""
    from benchmark import run as harness
    from deep_visual_slam_torch.utils import logging as tracing

    class Driver:
        def next_entry(self):
            return torch.ones(8)

        def step(self, x):
            with tracing.span("step"):
                with tracing.span("net.depth.fwd"):
                    return (x * 2).sum()

    tracing.drain()
    out = tmp_path / "benchmark" / "out"
    summary = harness.traced_window(Driver(), 3, 0, out, False, torch.device("cpu"))
    assert tracing.span("step") is tracing.span("x")  # off again after the profiler
    run = SimpleNamespace(cell=SimpleNamespace(root=tmp_path), traces=[summary])
    (got,) = spans.windows(run)
    assert spans.windows(run) == [got]  # read once
    assert [name for name, _, _, _ in got["spans"]] == ["net.depth.fwd", "step"] * 3
    assert got["ops"] == [] and got["steps"] == 3
    assert got["window_us"] == summary["window_us"]
    lo, hi = got["window_us"]
    assert all(lo <= s and s + d <= hi for _, s, d, _ in got["spans"])
    loaded = spans.load(out / "trace.rank0.json")
    assert sorted(loaded["spans"]) == pytest.approx(sorted(got["spans"]))
    assert cells.metric_reader(cells.load("vo_train.b16"), "net_ms")(run) is None
    bare = SimpleNamespace(cell=SimpleNamespace(root=tmp_path), traces=[summary])
    assert spans.windows(bare) == []  # the buffer is drained: as a program without spans
    assert spans.main([str(out / "trace.rank0.json")]) == 0
    plain = tmp_path / "plain.json"
    plain.write_text(json.dumps({"traceEvents": []}))
    assert spans.main([str(plain)]) == 1
