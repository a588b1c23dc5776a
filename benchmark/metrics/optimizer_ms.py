"""optimizer_ms: device ms a step launched inside the program's ``optimizer``
span (the gradient's norm and Adam's update), every kernel. From rank 0's
program spans in the traced window (``benchmark/spans.py``)."""

from benchmark.spans import layer_ms


def read(run):
    return layer_ms(run, "device", "optimizer")
