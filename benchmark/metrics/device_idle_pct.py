"""The share of the profiled repeat's wall window in which no device
operation (kernel, copy or fill) ran, from the trace's device timeline."""


def read(run):
    tr = run.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
