"""GroupNorm (+SiLU) in one kernel: the Hopper counterpart of
``theatergen_tpu/ops/groupnorm.py:140`` (``_gn_fused``, behind
``fused_group_norm``).

:func:`fused_group_norm` takes NCHW ``x`` and per-channel ``scale`` and
``bias``, and computes what the TPU kernel computes: fp32 group
statistics with the centred variance E[(x - mean)²], ``rsqrt(var + eps)``,
``(x - mean) · (inv · scale) + bias`` in fp32, SiLU in fp32 where asked,
and one rounding to x's dtype at the end.  On a CUDA tensor it launches the
hand-written kernel of ``csrc/group_norm.cu`` or raises.  On a CPU tensor
it runs :func:`fused_group_norm_plain`, the same function in plain
PyTorch.

The kernel's bound is bytes: x read once and the output written once,
``4·B·C·H·W`` bytes at 3.35 TB/s (:func:`min_bytes`).  Its design: one
thread-block cluster of C CTAs per (batch, group) slice, each CTA reading
its share of the slice once (into registers, or into shared memory by
bulk copies), per-thread counts, means and centred sums of squares
merged by Chan's formula into the CTA's, and the CTAs' triples pushed to
each other through distributed shared memory and combined in rank order;
then each share normalised and written once (the note in the source has
the rest).  :func:`gn_plan` picks the launch per shape, memoised
(:func:`launch_plan`); a plan the kernel cannot take raises.

The switch has the JAX package's name, values and meaning:
``THEATERGEN_FUSED_GN`` = ``"0"`` (off), ``"1"`` (every supported shape)
or ``"auto"`` (only the shapes :func:`profitable` names).  It is read once,
at import, into :data:`FUSED_MODE`, which tests and scripts may set.
:func:`supported` keeps the TPU gate's rules and size limit, so one
configuration routes the same norm sites in both packages.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .. import _build

# the port's default when THEATERGEN_FUSED_GN is unset.  The JAX package's
# is "0".  On an H100 (chip_smoke.py --profile; PERF.md §6) the kernel won
# the device time per evaluation of both UNets, and in request pairs the
# mean seconds per request under "1" were not above "0", for the
# character pass or for SDXL; those request-time differences lie within
# one standard error of zero
DEFAULT_MODE = "1"
FUSED_MODE = os.environ.get("THEATERGEN_FUSED_GN", DEFAULT_MODE)

# the TPU gate's VMEM budget, kept as the size limit of supported()
_VMEM_BUDGET = 80 * 1024 * 1024

# kernel launches made by fused_group_norm (reset and read by callers)
launches = 0

# the kernel's cluster sizes (the portable ones), CTA widths, load chunks
# and pieces a thread may keep in registers (the route with no chunks)
GN_CLUSTERS = (1, 2, 4, 8)
GN_THREADS = (128, 256, 512)
GN_MAX_CHUNKS = 4
GN_REG_PIECES = 8
# shared memory one CTA may take on an H100 (the opt-in limit) and the
# kernel's static part (mbarriers, block sums, the published statistics)
GN_SMEM_LIMIT = 232448 - 1024
# the planner's rules, fitted to an on-card sweep of every cluster size,
# width and route at the UNets' shapes and at B = 1, 4 and 8
# (scripts/torch_gn_sweep.py; gn_plan has them)
_SMALL_BYTES = 8 * 1024
_ONE_CTA_BYTES = 96 * 1024
_FILL_CTAS = 128
_SMS = 132


class GnPlan(NamedTuple):
    """One launch of the kernel: CTAs per cluster (one cluster per slice),
    threads per CTA, 16-byte pieces per CTA (the last CTA may own fewer),
    bulk-copy chunks per share (0: the share stays in registers, at most
    ``GN_REG_PIECES`` a thread), and dynamic shared memory per CTA."""
    cluster: int
    threads: int
    share: int
    chunks: int
    smem: int


def gn_pieces(c: int, hw: int, groups: int) -> int:
    """16-byte pieces (8 bf16 values) in one (batch, group) slice."""
    return c // groups * hw // 8


def gn_smem(share: int, c: int, hw: int, groups: int, chunks: int) -> int:
    """Dynamic shared memory of a CTA owning ``share`` pieces: the pieces
    (none where ``chunks`` is 0: they stay in registers), then an fp32
    (scale, bias) for each channel such a run can touch."""
    vpc = hw // 8
    return ((16 * share if chunks else 0)
            + 8 * min(c // groups, (share - 1) // vpc + 2))


def gn_plan(b: int, c: int, hw: int, groups: int = 32) -> GnPlan:
    """The kernel's launch for ``x [b, c, H, W]`` (``hw = H·W``).

    Cluster size: 1 for a slice of up to 8 KB; where the slices alone
    fill the card (at least 128), 1 for a slice of up to 96 KB and 8
    above; where two CTAs a slice fill it (CFG's B = 2 at 32 groups), 2;
    otherwise (B = 1) 8.  It doubles while a share does not fit in one
    CTA's shared memory, and past 8 the call raises ValueError.  Shares
    are whole 16-byte pieces, ``ceil(pieces / C)``.  Width: 128 threads
    at C = 8; 256 for a share of up to 16 KB, or where the CTAs outnumber
    the SMs; else 512.  A share of up to 8 pieces a thread stays in
    registers, a larger one loads into shared memory in 4 chunks."""
    pieces = gn_pieces(c, hw, groups)
    slices = b * groups
    if 16 * pieces <= _SMALL_BYTES:
        cl = 1
    elif slices >= _FILL_CTAS:
        cl = 1 if 16 * pieces <= _ONE_CTA_BYTES else 8
    elif 2 * slices >= _FILL_CTAS:
        cl = 2
    else:
        cl = 8
    while True:
        share = -(-pieces // cl)
        if cl == 8:
            threads = 128
        elif 16 * share <= 16 * 1024 or slices * cl > _SMS:
            threads = 256
        else:
            threads = 512
        chunks = 0 if share <= threads * GN_REG_PIECES else GN_MAX_CHUNKS
        smem = gn_smem(share, c, hw, groups, chunks)
        if smem <= GN_SMEM_LIMIT:
            return GnPlan(cl, threads, share, chunks, smem)
        if cl == GN_CLUSTERS[-1]:
            raise ValueError(f"group_norm: a ({c} // {groups})·{hw} slice "
                             f"does not fit in {cl} CTAs' shared memory")
        cl *= 2


# per (b, c, hw, groups): the launch plan
_plans: dict = {}


def launch_plan(b: int, c: int, hw: int, groups: int) -> GnPlan:
    """:func:`gn_plan`, computed once per shape (the wrapper runs 3050
    times a request)."""
    key = (b, c, hw, groups)
    plan = _plans.get(key)
    if plan is None:
        plan = _plans[key] = gn_plan(b, c, hw, groups)
    return plan


def _dims(shape):
    """(C, N) of an NCHW (or [B, C, ...]) shape."""
    return shape[1], math.prod(shape[2:])


def profitable(shape, num_groups: int = 32) -> bool:
    """The ``"auto"`` mode's predicate, the TPU package's: large spatial
    size (N ≥ 4096) or small spatial size at high channel count."""
    c, n = _dims(shape)
    return n >= 4096 or (c >= 1280 and n <= 256)


def supported(shape, dtype: torch.dtype, num_groups: int = 32) -> bool:
    """The TPU gate's rules on an NCHW shape: C % G == 0, N = H·W a
    multiple of 8, and N·C·(4·itemsize + 8) within its budget."""
    c, n = _dims(shape)
    if c % num_groups or n % 8:
        return False
    return n * c * (4 * dtype.itemsize + 8) <= _VMEM_BUDGET


def routes(shape, dtype: torch.dtype, num_groups: int = 32) -> bool:
    """Whether the switch sends a norm of this shape to the kernel."""
    return (FUSED_MODE in ("1", "auto") and len(shape) >= 3
            and supported(shape, dtype, num_groups)
            and (FUSED_MODE != "auto" or profitable(shape, num_groups)))


def _check_act(act: Optional[str]) -> None:
    if act not in (None, "silu"):
        raise ValueError(f"unsupported act {act!r}; expected None or 'silu'")


def fused_group_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, *, num_groups: int = 32,
                           eps: float = 1e-5,
                           act: Optional[str] = None) -> torch.Tensor:
    """Same function in plain PyTorch (the TPU package's ``_reference``):
    fp32 throughout, one rounding to x's dtype at the end."""
    _check_act(act)
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, -1)
    out = out * scale.float()[:, None] + bias.float()[:, None]
    if act == "silu":
        out = F.silu(out)
    return out.reshape(x.shape).to(x.dtype)


def _lib():
    fn = _build.library("group_norm").tg_group_norm_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    return fn


def fused_group_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, *, num_groups: int = 32,
                     eps: float = 1e-5,
                     act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm (optionally + SiLU) of ``x [B, C, H, W]`` over
    ``num_groups`` channel groups."""
    _check_act(act)
    if not x.is_cuda:
        return fused_group_norm_plain(x, scale, bias, num_groups=num_groups,
                                      eps=eps, act=act)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_group_norm: x must be bfloat16, got {x.dtype}")
    if x.ndim < 3 or not supported(x.shape, x.dtype, num_groups):
        raise ValueError(f"fused_group_norm: shape {tuple(x.shape)} with "
                         f"{num_groups} groups is outside the kernel's domain "
                         f"(C % G == 0, H·W % 8 == 0, size limit)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_group_norm: x must be contiguous and 16-byte "
                         "aligned")
    c = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != (c,)
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"fused_group_norm: {name} must be a contiguous "
                             f"bf16 ({c},) tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    b, hw = x.shape[0], math.prod(x.shape[2:])
    out = torch.empty_like(x)
    if b == 0:
        return out
    plan = launch_plan(b, c, hw, num_groups)
    _build.check(_lib()(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, c, hw, num_groups, eps, int(act == "silu"), *plan,
        torch.cuda.current_stream(x.device).cuda_stream,
    ), "fused_group_norm")
    global launches
    launches += 1
    return out


def min_bytes(b: int, c: int, hw: int, itemsize: int = 2) -> float:
    """Bytes of one call: x read once, the output written once (scale and
    bias are negligible)."""
    return 2.0 * b * c * hw * itemsize
