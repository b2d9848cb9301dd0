"""The ff_geglu kernel's share of its roofline over the profiled repeat:
the summed least time of its calls (operations or bytes from the shapes
the wrapper of its entry point recorded, harness/roofline.py) over the
summed device time of its kernels in the trace."""

from harness.roofline import roofline_share


def read(run):
    return roofline_share(run, "ff_geglu")
