"""adam_ms: device ms a step in torch.optim's foreach kernels
(multi_tensor_apply: Adam's update and the gradient norm), from the traced
window, the mean over the ranks."""

from benchmark.trace import group_ms_per_step


def read(run):
    return group_ms_per_step(run, "Adam (foreach)")
