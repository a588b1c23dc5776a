"""loss_idle_ms: ms a step in which no device operation ran while the
innermost program span open on the host was a ``loss.*`` span (the warp,
the loss, their backward). From rank 0's program spans in the traced
window (``benchmark/spans.py``)."""

from benchmark.spans import layer_ms


def read(run):
    return layer_ms(run, "idle", "loss.")
