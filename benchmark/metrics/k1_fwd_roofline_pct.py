"""k1_fwd_roofline_pct: the least time K1's forward launches of the traced
window could take on this card (each launch's bytes and operations from the
[B, H, W, 3] maps the VO loss hands it, at the data-sheet rates), over the
device time of K1's forward kernels, in %. The launches are counted by the
program's reprojection_loss.launches."""

from benchmark import yardsticks

KERNEL = "reprojection_loss_kernel"


def read(run):
    if run.peaks is None:
        return None
    B, H, W = run.shape
    least = yardsticks.least_seconds(yardsticks.k1_forward_work(B, H, W, 3), run.peaks)
    bound = sum(t["k1_fwd"] for t in run.traces) * least
    spent = sum(d for t in run.traces for n, _, d in t["kernels"] if KERNEL in n) / 1e6
    return 100.0 * bound / spent if bound > 0 and spent > 0 else None
