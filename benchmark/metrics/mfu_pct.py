"""The whole repeat's share of the card's bf16 peak: the operations of
every UNet, ControlNet, T2I-Adapter and VAE-decoder evaluation of the
profiled repeat (counted from their shapes on the plain reference's
modules), over the repeat's wall time times 989 TFLOP/s."""

from harness.roofline import PEAK_BF16_FLOPS


def read(run):
    tr = run.trace
    if tr is None or tr["busy_s"] <= 0:
        return None
    flops = [s["flops"] for s in tr["spans"] if s["flops"] is not None]
    if not flops:
        return None
    return 100.0 * sum(flops) / (tr["window_s"] * PEAK_BF16_FLOPS)
