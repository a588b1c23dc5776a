"""step_ms_p95: the 95th percentile of every step interval of the window on
every rank, in ms; an interval lies between CUDA events recorded on the
step's stream after consecutive steps."""

import statistics


def read(run):
    xs = [x for w in run.windows for x in w["intervals_s"]]
    if len(xs) < 2:
        return None
    return statistics.quantiles(xs, n=20, method="inclusive")[18] * 1e3
