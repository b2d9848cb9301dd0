"""The 90th percentile of the turn latency over every turn of the window
(numpy's linear interpolation); a failed turn counts with its latency."""

import numpy as np


def read(run):
    lat = [t["done"] - t["submit"] for t in run.turns]
    return float(np.percentile(lat, 90)) if lat else None
