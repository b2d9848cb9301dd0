"""The yardstick's arithmetic: the card's peaks, the least time a call
could take, and each kernel's operations and bytes from its shapes.

Frozen here so that a change to the program cannot move it.  Peaks are
NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its 700 W
limit.  A kernel's bytes count each input read once and each output
written once, whatever the kernel reads again.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, NamedTuple, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float,
            peak_ops: float = PEAK_BF16_FLOPS) -> float:
    """The least time of a call: the larger of its operations over the
    peak rate and its bytes over the memory bandwidth, in seconds."""
    return max(flops / peak_ops, nbytes / PEAK_BYTES)


def flash_cost(q_shape, k_shape, itemsize: int = 2) -> Tuple[float, float]:
    """Attention ``q [B, Sq, H, D]`` against ``k, v [B, Sk, H, D]``: QK^T
    and PV, 2·Sq·Sk·D multiply-adds each; q, k, v read and the output
    written once."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    return (4.0 * b * h * sq * sk * d,
            2.0 * b * h * d * (sq + sk) * itemsize)


def ff_cost(x_shape, w2_shape, itemsize: int = 2) -> Tuple[float, float]:
    """The whole GEGLU feed-forward, ``x [..., D]``, ``w1 [2K, D]``, ``b1
    [2K]``, ``w2 [D, K]``: the up-projection 2·M·D·2K and the down one
    2·M·K·D; x, w1, b1, w2 read and the output written once."""
    d, k = w2_shape[0], w2_shape[1]
    m = 1
    for s in x_shape[:-1]:
        m *= s
    return (6.0 * m * d * k, itemsize * (2.0 * m * d + 3.0 * d * k + 2.0 * k))


def geglu_cost(hg_shape, w_shape, itemsize: int = 2) -> Tuple[float, float]:
    """Gate and down-projection, ``hg [..., 2K]`` × ``w [N, K]``: the
    product 2·M·K·N; hg and w read, the output [M, N] written once."""
    n, k = w_shape
    m = 1
    for s in hg_shape[:-1]:
        m *= s
    return 2.0 * m * k * n, itemsize * (2.0 * m * k + n * k + m * n)


def group_norm_cost(x_shape, itemsize: int = 2) -> Tuple[float, float]:
    """GroupNorm (+SiLU) of ``x [B, C, H, W]``: x read and the output
    written once (scale and bias are negligible); its operations are
    counted as none, so the bytes bound it."""
    b, c, h, w = x_shape
    return 0.0, 2.0 * b * c * h * w * itemsize


class Kernel(NamedTuple):
    """A hand-written kernel of the program: its entry point (module and
    function of the program's ``ops`` package), the pattern of its device
    kernel's name in a trace, and its cost from the entry's arguments."""

    module: str
    function: str
    pattern: "re.Pattern"
    cost: Callable


KERNELS: Dict[str, Kernel] = {
    "flash_attention": Kernel(
        "ops.flash_attention", "flash_attention",
        re.compile(r"\bflash_fwd_kernel\b"),
        lambda a: flash_cost(a[0], a[1])),
    "ff_geglu": Kernel(
        "ops.geglu_matmul", "ff_matmul",
        re.compile(r"\bff_geglu_kernel\b"),
        lambda a: ff_cost(a[0], a[3])),
    "geglu_matmul": Kernel(
        "ops.geglu_matmul", "geglu_matmul",
        re.compile(r"\bgeglu_matmul_kernel\b"),
        lambda a: geglu_cost(a[0], a[1])),
    "group_norm": Kernel(
        "ops.groupnorm", "fused_group_norm",
        re.compile(r"\bgroup_norm_kernel\b"),
        lambda a: group_norm_cost(a[0])),
}


def roofline_share(run, kernel: str):
    """A kernel's roofline share (%) over a traced run: its calls' summed
    least time over its kernels' summed device time; None where the run
    made no call of it or the trace holds none of its kernels."""
    tr = run.trace
    if tr is None or not tr["kernel_calls"].get(kernel):
        return None
    dev = tr["kernel_device_s"].get(kernel, 0.0)
    if dev <= 0:
        return None
    return 100.0 * tr["kernel_bound_s"][kernel] / dev
