"""The traced window: a few steps under ``torch.profiler``, and what the
metrics read from its trace.

The profiler records the device's activity alone: recording every host
operation as well slows the host enough to starve the device of a step
that launches thousands of kernels. The benchmark keeps its own host spans
on the realtime clock, which is the trace's: the choice of the step's
inputs (``pick_batch``), each call of the program's step (``dispatch``) and
the wait for the device at the end (``readback``). The device's busy time
is the union of the intervals of its kernels, copies and sets, so work that
overlaps on two streams counts once.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def read_chrome_trace(path: Path) -> List[Tuple[str, float, float]]:
    """The device operations of a chrome trace: (name, start, duration),
    in us on the realtime clock, in order of start."""
    trace = json.loads(Path(path).read_text())
    base = trace.get("baseTimeNanoseconds", 0) / 1e3
    kernels = [(e["name"], base + float(e["ts"]), float(e["dur"]))
               for e in trace["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    return sorted(kernels, key=lambda k: k[1])


def busy_intervals(kernels, window) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the window."""
    lo, hi = window
    merged: List[List[float]] = []
    for _, ts, dur in kernels:
        a, b = max(ts, lo), min(ts + dur, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_us(summary: Dict) -> float:
    return sum(b - a for a, b in busy_intervals(summary["kernels"], summary["window_us"]))


def idle_gaps(summary: Dict) -> List[Tuple[str, float]]:
    """Each stretch of the window with no device operation running, in us,
    labelled by the benchmark's host span that overlaps it most
    (``outside_step`` where none does)."""
    lo, hi = summary["window_us"]
    busy = busy_intervals(summary["kernels"], summary["window_us"])
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        best, label = 0.0, "outside_step"
        for name, ts, dur in summary["spans"]:
            overlap = min(b, ts + dur) - max(a, ts)
            if overlap > best:
                best, label = overlap, name
        gaps.append((label, b - a))
    return gaps


def group_ms_per_step(run, group: str):
    """Device ms a step in the kernels of ``group`` (see
    ``yardsticks.GROUPS``), the mean over the ranks; None where the trace
    holds none."""
    from benchmark.yardsticks import group_of

    per_rank = []
    for t in run.traces:
        us = sum(dur for name, _, dur in t["kernels"] if group_of(name) == group)
        per_rank.append(us / 1e3 / t["steps"])
    return sum(per_rank) / len(per_rank) if any(per_rank) else None
