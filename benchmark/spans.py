"""The program's spans in the traced run: which layer launched each device
operation, and under which layer the device sat idle.

The program's tracing (``deep_visual_slam_torch/utils/logging.py``) is on
while a ``torch.profiler`` records, so the traced window of
``run.traced_window`` records the program's spans (``step``,
``step.input``, ``net.*``, ``loss.*``, ``optimizer``) on the realtime
clock, which is the trace's. The readers here drain them from this
process's buffer after the run, which holds rank 0's: a rank that runs in
another process is not read. They add them to rank 0's trace on disk
(``benchmark/out/trace.rank0.json``, a track of their own).

- Each device operation goes to the innermost span open on the host when
  the host launched it: the operation's ``args.correlation`` names its
  launch, a ``cuda_runtime`` or ``cuda_driver`` event of the trace. An
  operation whose launch the trace lacks goes to ``unmatched``.
- Each instant of the window in which no device operation runs goes to the
  innermost span open at that instant, and to ``outside`` where none is.

So the parts add up: the device time to the summed durations of the
window's operations, the idle time to the window less the union of their
intervals. A program without spans (one older than them) records none, and
the metrics that read them give nothing.

    python3 -m benchmark.spans benchmark/out/trace.rank0.json

prints each span's device and idle ms a step from such a trace, and the
layers that the known kernel groups fell into.
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from benchmark.trace import DEVICE_CATEGORIES, busy_intervals
from benchmark.yardsticks import group_of

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
SPAN_CATEGORY = "program_span"
OUTSIDE, UNMATCHED = "outside", "unmatched"


def _drain_program() -> List[Tuple[str, float, float, int]]:
    """The spans the program recorded in this process; none from a program
    without spans."""
    from deep_visual_slam_torch.utils import logging as tracing

    drain = getattr(tracing, "drain", None)
    return drain() if drain is not None else []


def windows(run) -> List[Dict]:
    """The traced window of each rank whose spans this process holds (rank
    0's): its spans, its device operations with their launch times, the
    window, its steps and its trace's path. Read once a run: the first
    call drains the program's buffer and adds the spans to the trace on
    disk, and the run keeps the result as ``span_windows``."""
    if getattr(run, "span_windows", None) is None:
        run.span_windows = []
        spans = _drain_program() if run.traces else []
        path = run.cell.root / "benchmark" / "out" / "trace.rank0.json"
        if spans and path.exists():
            summary = run.traces[0]
            trace = _add_spans(path, spans, summary["window_us"], summary["steps"])
            run.span_windows.append({
                "spans": spans, "ops": device_ops(trace), "window_us": summary["window_us"],
                "steps": summary["steps"], "path": str(path)})
    return run.span_windows


def _add_spans(path: Path, spans, window, steps: int) -> Dict:
    """The program's spans as events of the trace at ``path`` (a track of
    their own, one row a depth), and the window and its steps as top-level
    keys; returns the trace."""
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    trace["traceEvents"] += [
        {"ph": "X", "cat": SPAN_CATEGORY, "name": name, "pid": "program spans", "tid": depth,
         "ts": start - base, "dur": dur} for name, start, dur, depth in spans]
    trace["programWindowUs"] = list(window)
    trace["programSteps"] = steps
    path.write_text(json.dumps(trace))
    return trace


def device_ops(trace: Dict) -> List[Tuple[str, float, float, Optional[float]]]:
    """The device operations of a chrome trace: (name, start, duration,
    launch time or None), in us on the realtime clock, in order of start."""
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    launches, ops = {}, []
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in LAUNCH_CATEGORIES and corr is not None:
            launches[corr] = base + float(e["ts"])
        elif e.get("cat") in DEVICE_CATEGORIES:
            ops.append((e["name"], base + float(e["ts"]), float(e["dur"]), corr))
    ops = [(name, ts, dur, launches.get(corr)) for name, ts, dur, corr in ops]
    return sorted(ops, key=lambda op: op[1])


def load(path: Path) -> Dict:
    """One rank's window as :func:`windows` reads it, from the trace that
    it added the spans to."""
    trace = json.loads(Path(path).read_text())
    if "programWindowUs" not in trace:
        raise ValueError(f"{path} holds no program spans (a program without them, "
                         "or a trace that the span metrics have not read)")
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    spans = [(e["name"], base + float(e["ts"]), float(e["dur"]), int(e["tid"]))
             for e in trace["traceEvents"] if e.get("cat") == SPAN_CATEGORY]
    return {"spans": spans, "ops": device_ops(trace),
            "window_us": tuple(trace["programWindowUs"]), "steps": trace["programSteps"],
            "path": str(path)}


def timeline(spans, window) -> List[Tuple[float, float, str]]:
    """The window cut at every span's edges into stretches, each labelled
    by the innermost span open over it (the deepest; of two as deep, the
    later opened), or ``outside``."""
    lo, hi = window
    edges = sorted({lo, hi} | {min(max(x, lo), hi) for _, s, d, _ in spans for x in (s, s + d)})
    pieces = []
    for a, b in zip(edges, edges[1:]):
        mid, best, label = (a + b) / 2, None, OUTSIDE
        for name, s, d, depth in spans:
            if s <= mid < s + d and (best is None or (depth, s) >= best):
                best, label = (depth, s), name
        pieces.append((a, b, label))
    return pieces


def op_labels(program: Dict, pieces=None) -> List[str]:
    """Each device operation's label: the innermost span open at its
    launch, ``outside`` or ``unmatched``."""
    pieces = pieces or timeline(program["spans"], program["window_us"])
    starts = [a for a, _, _ in pieces]
    labels = []
    for _, _, _, launched in program["ops"]:
        if launched is None:
            labels.append(UNMATCHED)
            continue
        i = bisect.bisect_right(starts, launched) - 1
        labels.append(pieces[i][2] if 0 <= i and launched < pieces[i][1] else OUTSIDE)
    return labels


def _gaps(program: Dict) -> List[Tuple[float, float]]:
    """The stretches of the window in which no device operation runs."""
    lo, hi = program["window_us"]
    busy = busy_intervals([(n, ts, dur) for n, ts, dur, _ in program["ops"]], (lo, hi))
    return [(a, b) for a, b in zip([lo] + [b for _, b in busy], [a for a, _ in busy] + [hi])
            if b > a]


def split(program: Dict) -> Dict[str, Dict[str, float]]:
    """The window's device and idle us by label (span name, ``outside`` or
    ``unmatched``)."""
    pieces = timeline(program["spans"], program["window_us"])
    device: Dict[str, float] = defaultdict(float)
    for op, label in zip(program["ops"], op_labels(program, pieces)):
        device[label] += op[2]
    idle: Dict[str, float] = defaultdict(float)
    starts = [a for a, _, _ in pieces]
    for a, b in _gaps(program):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(pieces) and pieces[i][0] < b:
            pa, pb, label = pieces[i]
            if min(b, pb) > max(a, pa):
                idle[label] += min(b, pb) - max(a, pa)
            i += 1
    return {"device": dict(device), "idle": dict(idle)}


def layer_ms(run, kind: str, prefix: str) -> Optional[float]:
    """The ms a step of ``kind`` (``device`` or ``idle``) under the spans
    whose names start with ``prefix``, the mean over the ranks read
    (:func:`windows`); None where the run recorded no spans or its trace no
    device operation."""
    programs = windows(run)
    if not programs:
        return None
    per_rank = []
    for program in programs:
        if not program["ops"]:
            return None
        parts = split(program)[kind]
        per_rank.append(sum(v for k, v in parts.items() if k.startswith(prefix))
                        / 1e3 / program["steps"])
    return sum(per_rank) / len(per_rank)


def report(program: Dict) -> Dict:
    """Each label's device and idle ms and device operations a step, the
    window's totals, the host ms a step inside ``step``, and the device ms a
    step of each kernel group by label."""
    per_step = 1e3 * program["steps"]
    parts = split(program)
    launches: Dict[str, float] = defaultdict(float)
    groups: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for (name, _, dur, _), label in zip(program["ops"], op_labels(program)):
        launches[label] += 1 / program["steps"]
        group = group_of(name)
        if group is not None:
            groups[group][label] += dur / per_step
    lo, hi = program["window_us"]
    return {
        "steps": program["steps"],
        "device_ms": {k: v / per_step for k, v in sorted(parts["device"].items())},
        "idle_ms": {k: v / per_step for k, v in sorted(parts["idle"].items())},
        "launches": dict(sorted(launches.items())),
        "window_ms": (hi - lo) / per_step,
        "step_host_ms": sum(d for n, _, d, _ in program["spans"] if n == "step") / per_step,
        "window_device_ms": sum(op[2] for op in program["ops"]) / per_step,
        "window_idle_ms": sum(b - a for a, b in _gaps(program)) / per_step,
        "ops": len(program["ops"]),
        "launches_found": sum(op[3] is not None for op in program["ops"]),
        "groups": {g: dict(v) for g, v in groups.items()},
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    for path in argv:
        try:
            program = load(Path(path))
        except ValueError as e:
            print(e, file=sys.stderr)
            return 1
        print(json.dumps({"trace": path, **report(program)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
