"""Seconds from the process's start to the first timed submit: imports,
the kernels' build or load (``nvcc`` on a checkout's first run only,
logged on its own ``build:`` line), the weights, the bundle, the
sessions and their DB entries, the warm-up."""


def read(run):
    return run.setup_s
