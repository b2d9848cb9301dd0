"""What decides ``correct``: served turns against the plain reference.

The turns compared are the first turns of the sessions that
``Traffic.check_sessions`` draws from the seed, as the timed path served
them in the window (a wave's rows, or a lone turn), with the longest
turn of the mix among them.  They depend on nothing the program made
before them: the DB entries they read were written in set-up from
benchmark-made images.  The reference (``reference/turn.py``) runs each
from the same spec, seed, weights and DB images, in fp32, once the
program's state is freed.  Two numbers are compared, each the worst over
the turns compared:

- ``char_gap``: the mean absolute difference of a character's image
  (every character of the turn, [0, 1] pixels);
- ``final_gap``: the mean absolute difference of the turn's image.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

NUMBERS = ("char_gap", "final_gap")


def gaps(ref_out: dict, served) -> Dict[str, float]:
    """The two numbers of one turn: ``served`` a TurnResult."""
    if len(served.so_images) != len(ref_out["so_images"]):
        return dict(char_gap=float("inf"), final_gap=float("inf"))
    char = max(float(np.abs(np.asarray(a, np.float32) - b).mean())
               for a, b in zip(served.so_images, ref_out["so_images"]))
    final = float(np.abs(np.asarray(served.image, np.float32)
                         - ref_out["image"]).mean())
    return dict(char_gap=char, final_gap=final)


def compare(turn, records: List[dict], db_images) -> Dict[str, float]:
    """The worst of each number over ``records`` (records of
    ``Load.round`` holding a result), the reference ``turn`` run on each."""
    worst = {n: 0.0 for n in NUMBERS}
    for rec in records:
        ref = turn.run(rec["spec"], rec["seed"], db_images[rec["session"]])
        for n, v in gaps(ref, rec["result"]).items():
            worst[n] = max(worst[n], v)
        rec["ref_attempts"] = ref["attempts"]
    return worst
