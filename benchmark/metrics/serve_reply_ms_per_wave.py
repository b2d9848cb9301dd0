"""Milliseconds of the server's post-wave work, as a mean per dispatch:
the program's ``serve.reply`` phase (``serve.py``: each session's state
written, each future resolved), one per wave in its first session's
PhaseTimer, over the window.  On a failed wave the phase also holds the
quarantine's serial reruns of its turns, seconds each."""


def read(run):
    xs = run.phases.get("serve.reply")
    return 1e3 * sum(xs) / len(xs) if xs else None
