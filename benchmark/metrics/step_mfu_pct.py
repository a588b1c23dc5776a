"""step_mfu_pct: the model FLOPs of the window's steps (counted once on the
plain reference networks: 2 a multiply-add of every convolution, times 3
for the forward and the backward) over the window's seconds times the
cards times each card's dense bf16 peak, in %."""


def read(run):
    if run.peaks is None:
        return None
    w = run.windows[0]
    return 100.0 * w["steps"] * run.flops_per_step / (
        w["seconds"] * run.world * run.peaks["bf16_flops"])
