"""The numbers that decide ``correct``, each a gap between the program's
reading and the plain reference's, and their verdict against the cell's
limits. A cell's limits file names the numbers it compares.

- ``fwd``: over the networks' outputs in the first step (each tensor a
  network returns), the largest relative L2 error of the program's output
  against the reference's; infinite where the program gives another shape.
- ``ddisp``: over the batch's samples, the largest gap between the norms
  of the loss's gradient that reaches the sample's outputs of the first
  network (every output together: the disparities at every scale) in the
  first step, over the reference's. A loss that leaves rows out reads 1 on
  them; infinite where the program gives another shape.
- ``loss``: the largest relative gap of a checked step's loss;
  ``loss1``: that of the first step alone, before any update.
- ``grad``: over the leaves, the largest gap between the norms of the
  program's and the reference's first gradient, over the larger of the
  reference leaf's norm and the median leaf's; ``grad_p90`` and
  ``grad_median``: the 90th percentile and the median of those leaf gaps.
- ``change``, ``change_p90``, ``change_median``: the same of each leaf's
  change over the checked steps. Leaves whose reference gradient is under a
  thousandth of the median leaf's move under Adam by round-off alone and
  are left out.
- ``ranks``: on several cards, the largest difference of any parameter from
  rank 0's after the checked steps; data parallelism keeps them equal.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

STILL_LEAF = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> List[float]:
    floor = statistics.median(ref[k] for k in keys)
    return sorted(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys)


def _worst(xs: List[float]) -> float:
    return math.nan if any(math.isnan(x) for x in xs) else max(xs)


def _quantile(xs: List[float], q: float) -> float:
    """The ``q`` quantile of sorted ``xs``, the nearest rank below."""
    return math.nan if any(math.isnan(x) for x in xs) else xs[int(q * (len(xs) - 1))]


def _relative_error(p, r) -> float:
    if p.shape != r.shape:
        return math.inf
    return float((p.double() - r.double()).norm() / r.double().norm())


def _sample_gaps(prog: List, ref: List) -> List[float]:
    """Each sample's gap between the norms of the gradient reaching its
    outputs, from each output's norms by row (a row is a sample)."""
    if len(prog) != len(ref) or any(p is None or p.shape != r.shape
                                    for p, r in zip(prog, ref)):
        return [math.inf]

    def per_sample(rows):
        return sum(t.double().pow(2) for t in rows).sqrt()

    p, r = per_sample(prog), per_sample(ref)
    return sorted(((p - r).abs() / r).tolist())


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Every number the program's reading gives against the reference's."""
    if prog["grad"].keys() != ref["grad"].keys():
        raise RuntimeError("the program's leaves differ from the reference's")
    steps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    keys = sorted(ref["grad"])
    floor = statistics.median(ref["grad"][k] for k in keys)
    moving = [k for k in keys if ref["grad"][k] >= STILL_LEAF * floor]
    grad = _leaf_gaps(prog["grad"], ref["grad"], keys)
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    ddisp = _sample_gaps(prog["ddisp"], ref["ddisp"])
    out = {"fwd": _worst([_relative_error(p, r) for p, r in zip(prog["outputs"], ref["outputs"])]),
           "ddisp": _worst(ddisp),
           "loss": _worst(steps), "loss1": steps[0]}
    for name, gaps in (("grad", grad), ("change", change)):
        out[name] = _worst(gaps)
        out[f"{name}_p90"] = _quantile(gaps, 0.9)
        out[f"{name}_median"] = _quantile(gaps, 0.5)
    if prog.get("ranks") is not None:
        out["ranks"] = prog["ranks"]
    return out


def verdict(found: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """Whether every number the limits name is within its limit, and one
    line per number."""
    ok, lines = True, []
    for name, limit in limits.items():
        value = found[name]
        good = value <= limit  # False for NaN
        ok = ok and good
        lines.append(f"check {name} {value!r} limit {limit!r} {'ok' if good else 'FAILED'}")
    return ok, lines


def summary(found: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    return {k: {"value": found[k], "limit": v} for k, v in limits.items()}
