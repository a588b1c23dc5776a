"""device_idle_pct: the share of the traced window in which no kernel, copy
or set ran on the fullest card: 100 x (1 - the union of the device
operations' intervals / the window)."""

from benchmark.trace import busy_us


def read(run):
    shares = []
    for t in run.traces:
        lo, hi = t["window_us"]
        shares.append(busy_us(t) / (hi - lo))
    return 100.0 * (1.0 - max(shares)) if max(shares) > 0 else None
