"""train_samples_per_s: training samples (VO snippets or depth images, summed
over the ranks) completed in the window, over the window's host-clock
seconds, which end at the synchronise after the last step."""


def read(run):
    w = run.windows[0]
    return w["steps"] * run.samples_per_step / w["seconds"]
