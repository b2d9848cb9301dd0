"""Device milliseconds of a UNet evaluation, as a mean: the summed time
of the device operations that the evaluation's span launched (by the
trace's correlation ids), over the profiled repeat."""


def read(run):
    if run.trace is None:
        return None
    xs = [s["device_s"] for s in run.trace["spans"]
          if s["kind"] in ("unet_ip", "unet")]
    if not xs or sum(xs) <= 0:
        return None
    return 1e3 * sum(xs) / len(xs)
