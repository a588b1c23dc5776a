"""nccl_ms: device ms a step in NCCL's kernels (DDP's gradient all-reduce,
the synced BatchNorm's all-gathers and all-reduces, the losses' mean), from
the traced window, the mean over the ranks. A collective's kernel runs from
its launch until every peer has joined, so the time holds the waits on
slower ranks."""

from benchmark.trace import group_ms_per_step


def read(run):
    return group_ms_per_step(run, "NCCL")
