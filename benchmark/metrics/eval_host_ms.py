"""Host milliseconds of a UNet evaluation, as a mean: the span from the
module's forward pre-hook to its forward hook (the launches; the device
runs behind), over the profiled repeat."""


def read(run):
    if run.trace is None:
        return None
    xs = [s["host_s"] for s in run.trace["spans"]
          if s["kind"] in ("unet_ip", "unet")]
    return 1e3 * sum(xs) / len(xs) if xs else None
