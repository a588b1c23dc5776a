"""dispatch_ms: the benchmark's host span around each call of the program's
train_step, mean over the window's steps on every rank, in ms. Where the
device sets the pace, the host waits inside the call for the launch queue,
so the span also holds that wait."""


def read(run):
    xs = [x for w in run.windows for x in w["dispatch_s"]]
    return sum(xs) / len(xs) * 1e3 if xs else None
