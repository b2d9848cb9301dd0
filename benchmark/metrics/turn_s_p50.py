"""The median turn latency: submit to the future's result, images on the
host (host clock), over every turn of the window."""

import numpy as np


def read(run):
    lat = [t["done"] - t["submit"] for t in run.turns]
    return float(np.percentile(lat, 50)) if lat else None
