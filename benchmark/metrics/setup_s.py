"""setup_s: seconds from the process's start to the window's start on rank
0: imports, the build or load of the program's kernels, weights and inputs
drawn on the card, the checked and warm-up steps."""


def read(run):
    return run.setup_s
