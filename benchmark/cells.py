"""Finds a cell and everything that belongs to it by name, as data.

``BENCHMARK.json`` (at the root of the checkout) lists the cells, the
configurations and the metrics. A cell's configuration is the ``file`` its
``configs`` entry names; its traffic is ``benchmark/traffic/<traffic>.json``;
its limits are ``benchmark/limits/<cell>.json``; the driver of its traffic
is ``benchmark/drivers/<driver>.py``, where the configuration names
``driver``, and a driver finds the plain reference of its network as
``benchmark/reference/<name>.py``; a per-layer metric ``m`` is read by
``benchmark/metrics/<m>.py``. A later change adds a cell, a configuration,
a network or a metric by adding such files and entries; none of this code
needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: Path = field(default=ROOT)

    @property
    def world(self) -> int:
        return self.traffic["ranks"]


def _reports(metric: Dict, cell: str, moved: set) -> bool:
    """A metric with ``workloads`` is the listed cells'; a per-layer one
    without is every cell's that reports the metric it ``moves``; an
    end-to-end one without is every cell's."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in moved


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (known: {known})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    end_to_end = [m for m in bench["end_to_end"] if _reports(m, name, set())]
    moved = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, moved)]
    bench_dir = root / "benchmark"
    return Cell(
        name=name,
        chips=entry["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((bench_dir / "limits" / f"{name}.json").read_text()),
        end_to_end=end_to_end,
        per_layer=per_layer,
        root=root,
    )


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(cell: Cell):
    """The driver class of the cell's configuration."""
    kind = cell.config["driver"]
    return _module(cell.root / "benchmark" / "drivers" / f"{kind}.py",
                   f"benchmark_driver_{kind}").Driver


def reference(cell: Cell, name: str):
    """The plain reference module ``benchmark/reference/<name>.py`` of the
    cell's checkout, found by name as a driver is: a driver of another
    network takes its parameters, checked steps and FLOP count from it."""
    return _module(cell.root / "benchmark" / "reference" / f"{name}.py",
                   f"benchmark_reference_{name}")


def metric_reader(cell: Cell, metric: str) -> Callable:
    """``read(run)`` of the per-layer metric ``metric``."""
    return _module(cell.root / "benchmark" / "metrics" / f"{metric}.py",
                   f"benchmark_metric_{metric.replace('.', '_')}").read
