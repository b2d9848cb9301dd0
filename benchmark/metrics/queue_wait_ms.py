"""Milliseconds a turn waits in the server's queue, as a mean: the
program's ``serve.queue`` span (``serve.py``: from ``submit`` to the
dispatch of its wave), one per turn in its session's PhaseTimer, over the
window."""


def read(run):
    xs = run.phases.get("serve.queue")
    return 1e3 * sum(xs) / len(xs) if xs else None
