"""k1_bwd_roofline_pct: the same as k1_fwd_roofline_pct for K1's backward
launches (reprojection_loss.backward_launches) and kernels, with the
backward's bytes (pred, target and the incoming gradient read once, the
gradient written once) and operations."""

from benchmark import yardsticks

KERNEL = "reprojection_grad_kernel"


def read(run):
    if run.peaks is None:
        return None
    B, H, W = run.shape
    least = yardsticks.least_seconds(yardsticks.k1_backward_work(B, H, W, 3), run.peaks)
    bound = sum(t["k1_bwd"] for t in run.traces) * least
    spent = sum(d for t in run.traces for n, _, d in t["kernels"] if KERNEL in n) / 1e6
    return 100.0 * bound / spent if bound > 0 and spent > 0 else None
