"""conv_ms: device ms a step in cuDNN's convolution kernels (forward, data
and weight gradients), from the traced window, the mean over the ranks."""

from benchmark.trace import group_ms_per_step


def read(run):
    return group_ms_per_step(run, "cuDNN convolution")
