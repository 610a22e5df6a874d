"""setup_s: seconds from the process's start to the end of the warm-up:
imports, the kernels' build where the checkout has none, the inputs made
from the seed, one call on each scalar set."""


def read(run):
    return run.setup_s
