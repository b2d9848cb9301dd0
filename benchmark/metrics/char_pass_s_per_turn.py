"""Seconds of the character passes per turn: the ``char.denoise_decode``
phase of every session's PhaseTimer (synchronised: the device chain of
the IP UNet loop and the decode) summed over the window, per turn."""


def read(run):
    xs = run.phases.get("char.denoise_decode")
    return sum(xs) / len(run.turns) if xs and run.turns else None
