"""Milliseconds the host spends enqueuing one denoising step: the
program's ``char.loop`` and ``final.loop`` phases (a runner's enqueue of
its steps, before the pass's synchronise) summed over the window, over its
``loop.steps`` count (a batched loop's step counts once).  A final step
holds the ControlNet (SD1.5) or T2I-Adapter (SDXL) evaluations besides the
UNet's, and where the device is the slower the enqueue waits on the
launch queue, so the number reads no lower than the device's pace a step.
It is not the host's own work: ``eval_host_ms`` times the UNet alone, and
the two differ by the adapters, the step's other work and that wait."""


def read(run):
    steps = sum(run.phases.get("loop.steps", ()))
    host = sum(run.phases.get("char.loop", ())) + sum(
        run.phases.get("final.loop", ()))
    return 1e3 * host / steps if steps else None
