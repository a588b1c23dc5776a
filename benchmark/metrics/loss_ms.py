"""loss_ms: device ms a step launched inside the program's ``loss.*`` spans:
the warp, the VO loss and K1 (or the depth loss), and their backward until
the first gradient reaches a network's output. From rank 0's program spans
in the traced window (``benchmark/spans.py``)."""

from benchmark.spans import layer_ms


def read(run):
    return layer_ms(run, "device", "loss.")
