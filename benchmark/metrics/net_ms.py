"""net_ms: device ms a step launched inside the program's ``net.*`` spans
(DepthNet's and PoseNet's forward, and the networks' backward from the
first gradient reaching an output): every kernel, copy and set, cuDNN's or
not. From rank 0's program spans in the traced window
(``benchmark/spans.py``)."""

from benchmark.spans import layer_ms


def read(run):
    return layer_ms(run, "device", "net.")
