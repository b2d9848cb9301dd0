"""Turns completed per second of the window: every turn of the window
over the window's whole time, from the first submit to the last result
(host clock)."""


def read(run):
    done = sum(1 for t in run.turns if t.get("ok"))
    return done / run.window_s if run.window_s > 0 else None
