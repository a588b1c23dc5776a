"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window on the
fullest card, reset when the window starts, in GiB. It holds the resident
pool of input batches beside the step's own memory."""


def read(run):
    peak = max(w["peak_bytes"] for w in run.windows)
    return peak / 2**30 if peak else None
