"""The program's spans (``utils/logging.py``) inside the port's train steps,
and the step timer, on the CPU at B=2, 64x96, fp32.

- Tracing off: a VO step and a depth step record nothing and register no
  tensor hook; ``span`` hands back one shared context.
- Tracing on: each step records exactly its spans, each child inside its
  parent, ``loss.bwd`` before ``net.bwd``; a span closed on the thread
  that runs the backward is in the buffer.
- The losses and every parameter after one step are bit-equal with tracing
  on and off.
- A running ``torch.profiler`` turns tracing on without :func:`enable`, and
  off again when it stops; so the VO trainer's profiler traces the steps
  it profiles, and its trace shows the spans by name.
"""

import json
import threading

import pytest
import torch

from deep_visual_slam_torch.data.synthetic import synthetic_vo_batch
from deep_visual_slam_torch.models import DepthNet, PoseNet
from deep_visual_slam_torch.training import (
    TrainState,
    VOLossConfig,
    make_depth_train_step,
    make_vo_train_step,
)
from deep_visual_slam_torch.training.depth_learner import DepthLossConfig
from deep_visual_slam_torch.training.vo_trainer import _start_profiler, _stop_profiler
from deep_visual_slam_torch.utils import logging as tracing

# One thread per test process (see test_torch_models.py).
torch.set_num_threads(1)

B, H, W = 2, 64, 96

VO_SPANS = {"step": 0, "step.input": 1, "net.depth.fwd": 1, "net.pose.fwd": 1, "loss.warp": 1,
            "loss.photometric": 1, "loss.bwd": 1, "net.bwd": 1, "optimizer": 1}
DEPTH_SPANS = {"step": 0, "step.input": 1, "net.depth.fwd": 1, "loss.depth": 1, "loss.bwd": 1,
               "net.bwd": 1, "optimizer": 1}


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _vo_step():
    """A fresh VO state, its step and a batch: the same on every call."""
    g = torch.Generator().manual_seed(0)
    depth, pose = DepthNet(generator=g), PoseNet(generator=g)
    state = TrainState.create(depth, pose, 1e-3, total_steps=0)
    step = make_vo_train_step(depth, pose, VOLossConfig(), torch.float32, device="cpu")
    batch, _ = synthetic_vo_batch(0, B, H, W, device="cpu")
    return state, lambda: step(state, batch, torch.Generator().manual_seed(1))


def _depth_step():
    g = torch.Generator().manual_seed(0)
    depth = DepthNet(generator=g)
    state = TrainState.create(depth, None, 1e-3, total_steps=0)
    step = make_depth_train_step(depth, DepthLossConfig(), torch.float32, device="cpu")
    batch = {"image": torch.rand(B, H, W, 3, generator=g),
             "depth": 0.5 + 5 * torch.rand(B, H, W, 1, generator=g),
             "valid_mask": (torch.rand(B, H, W, 1, generator=g) > 0.1).float()}
    return state, lambda: step(state, batch)


STEPS = {"vo": (_vo_step, VO_SPANS), "depth": (_depth_step, DEPTH_SPANS)}


@pytest.fixture(scope="module", params=list(STEPS))
def two_runs(request):
    """One step from fresh state with tracing off, then one with it on:
    for each, the tensor hooks registered, the spans recorded, the losses
    and the parameters after the step."""
    make, want = STEPS[request.param]
    register = torch.Tensor.register_hook
    runs = {}
    for on in (False, True):
        state, run = make()
        hooks = []
        torch.Tensor.register_hook = lambda t, fn: hooks.append(fn) or register(t, fn)
        tracing.drain()
        (tracing.enable if on else tracing.disable)()
        try:
            losses = run()
        finally:
            tracing.disable()
            torch.Tensor.register_hook = register
        params = [p.detach().clone() for p in state.optimizer.param_groups[0]["params"]]
        runs[on] = {"hooks": hooks, "spans": tracing.drain(), "losses": losses,
                    "params": params}
    return want, runs


def test_tracing_off_records_nothing_and_hooks_nothing(two_runs):
    _, runs = two_runs
    assert runs[False]["spans"] == []
    assert runs[False]["hooks"] == []
    assert runs[True]["hooks"]  # the networks' outputs, while tracing is on
    assert tracing.span("a") is tracing.span("b") is tracing.split_span("a", "b")


def test_tracing_on_records_each_span_inside_its_parent(two_runs):
    want, runs = two_runs
    spans = {name: (start, start + dur, depth)
             for name, start, dur, depth in runs[True]["spans"]}
    assert len(spans) == len(runs[True]["spans"])  # each name once
    assert {name: depth for name, (_, _, depth) in spans.items()} == want
    lo, hi, _ = spans["step"]
    for name, (start, end, _) in spans.items():
        assert lo <= start <= end <= hi, name
    assert spans["loss.bwd"][1] <= spans["net.bwd"][0]
    # The children follow the step's order without overlapping.
    order = sorted((s for s in spans.items() if s[0] != "step"), key=lambda s: s[1][0])
    for (_, (_, end, _)), (_, (start, _, _)) in zip(order, order[1:]):
        assert end <= start
    assert [name for name, _ in order][-3:] == ["loss.bwd", "net.bwd", "optimizer"]


def test_tracing_leaves_the_step_bit_equal(two_runs):
    _, runs = two_runs
    off, on = runs[False], runs[True]
    assert off["losses"].keys() == on["losses"].keys()
    for k in off["losses"]:
        assert torch.equal(off["losses"][k], on["losses"][k]), k
    assert len(off["params"]) == len(on["params"])
    assert all(torch.equal(a, b) for a, b in zip(off["params"], on["params"]))


def test_a_span_closed_on_the_backward_thread_is_in_the_buffer():
    """The backward runs on a thread of its own (as autograd's device
    threads run a card's); the hook closes ``loss.bwd`` there."""
    x = torch.ones(3, requires_grad=True)
    tracing.enable()
    y = x * 2
    tracing.watch_gradients([y])
    threads = []
    y.register_hook(lambda g: threads.append(threading.get_ident()))
    with tracing.span("step"):
        with tracing.split_span("loss.bwd", "net.bwd"):
            worker = threading.Thread(target=lambda: (y * y).sum().backward())
            worker.start()
            worker.join(timeout=30)
    assert not worker.is_alive()
    assert threads and threads[0] != threading.get_ident()
    spans = tracing.drain()
    assert [(name, depth) for name, _, _, depth in spans] == [
        ("loss.bwd", 1), ("net.bwd", 1), ("step", 0)]
    (_, a, da, _), (_, b, _, _) = spans[:2]
    assert a + da <= b
    assert torch.equal(x.grad, torch.full((3,), 8.0))


def test_a_running_profiler_turns_the_spans_on():
    _, run = _depth_step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        run()
    assert tracing.span("a") is tracing.span("b")
    got = {name: depth for name, _, _, depth in tracing.drain()}
    assert got == DEPTH_SPANS
    run()
    assert tracing.drain() == []


def test_the_trainers_profiler_traces_the_spans(tmp_path):
    _, run = _vo_step()
    profiler = _start_profiler(torch.device("cpu"))
    assert tracing.span("step") is not tracing.span("step")
    run()
    _stop_profiler(profiler, torch.device("cpu"), str(tmp_path))
    assert tracing.span("a") is tracing.span("b")
    assert tracing.drain() == []
    events = json.loads((tmp_path / "train_steps.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(VO_SPANS) <= names


def test_step_timer_counts_between_marks(monkeypatch):
    clock = iter([10.0, 12.0, 13.0, 20.0, 21.0])
    monkeypatch.setattr(tracing.time, "perf_counter", lambda: next(clock))
    timer = tracing.StepTimer()
    timer.mark(1)
    assert timer.throughput(4) == 0.0
    timer.mark(11)  # 10 steps in 2 s
    assert timer.throughput(4) == pytest.approx(20.0)
    timer.mark(21)  # 10 steps in 1 s
    assert timer.throughput(4) == pytest.approx(40.0)
    timer.restart()
    timer.mark(1)  # the first mark of an epoch: the last rate stands
    assert timer.throughput(4) == pytest.approx(40.0)
    timer.mark(11)  # 10 steps in 1 s after the restart
    assert timer.throughput(4) == pytest.approx(40.0)
