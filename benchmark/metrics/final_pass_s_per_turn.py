"""Seconds of the final passes per turn: the ``final`` phase of every
session's PhaseTimer (synchronised) summed over the window, per turn."""


def read(run):
    xs = run.phases.get("final")
    return sum(xs) / len(run.turns) if xs and run.turns else None
