"""Milliseconds of character-DB writes per turn: the program's ``db.save``
phases (``theater.py::_flush_db_saves``: the PNG and features written,
after their fetch to the host) summed over the window, per turn."""


def read(run):
    xs = run.phases.get("db.save")
    return 1e3 * sum(xs) / len(run.turns) if xs and run.turns else None
