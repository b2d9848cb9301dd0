"""Flash attention: the Hopper counterpart of the four Pallas attention
kernels of ``theatergen_tpu/ops/flash_attention.py``.

:func:`flash_attention` takes q ``[B, Sq, H, D]`` and k, v ``[B, Sk, H,
D]`` (strided views of a projection are fine) and returns ``[B, Sq, H,
D]``.  On a CUDA tensor it launches the hand-written kernel of
``csrc/flash_attention.cu`` (see the note there: one CTA per
(batch·head, 128 query rows), K and V tiles of 128 keys (64 at d = 160)
through a TMA ring, QK^T and PV on wgmma, online softmax in fp32
registers, head dims 40, 64, 80 and 160, Sq ≠ Sk with masked q rows) or
raises; under autograd its gradient is the plain version's, recomputed in
the backward (:class:`FlashAttentionFn`).  On a CPU tensor it runs
:func:`flash_attention_plain`, the same function in plain PyTorch.

The JAX package picks one of four Pallas kernels for an attention call
(its ``route``), under four environment switches that this module reads
from the same variables at import, into attributes that tests and
scripts may set:

======================  ==============================  ===============
route                   JAX kernel (kernel row)         counter
======================  ==============================  ===============
``"packed"``, ``"flat"``  ``_flat_call`` (1)            ``launches``
``"flat_online"``       ``_flat_online_call`` (2)       ``launches_long``
``"bshd"``              ``_flash_attention_bshd`` (3)   ``launches_bshd``
``"copy"``              ``_flash_attention_impl`` (4)   ``launches_copy``
======================  ==============================  ===============

:func:`route` returns the route of a site, or None where the JAX package
leaves attention to XLA and the port to its plain
``multi_head_attention`` (for SD1.5 on a 768-px canvas: level 1, 48² =
2304 tokens, and every shorter self-attention; every cross-attention).
The one kernel here computes every route's function, so each launch
counts on the counter of the route its caller names.

The TPU package folds the 1/sqrt(d) scale, the base-2 exponent and a lane
pad into packed projection weights (a Mosaic layout device); the kernel
here applies the scale to its fp32 logits and reads BSHD directly.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from .. import _build
from . import recompute
from .attention import multi_head_attention

LOG2E = 1.4426950408889634
# the TPU gates' lengths: keys 1024..32768 in steps of 512
# (fa.supported); the whole-K kernel up to 4096 (packed_supported,
# flat_supported) and the online one past it (flat_online_supported)
MIN_SEQ = 1024
MAX_WHOLE_K_SEQ = 4096
MAX_SEQ = 32768
# head dims with a compiled kernel instance (csrc/flash_attention.cu)
KERNEL_HEAD_DIMS = (40, 64, 80, 160)
# the kernel's query rows per CTA and depth of its K/V ring
Q_BLOCK = 128
KV_STAGES = 3
# the TPU gates' scoped-VMEM budget and lane width, kept so that the block
# searches below, copies of the JAX package's, accept the same shapes
_VMEM_BUDGET = 80 * 1024 * 1024
_LANE = 128

# the JAX package's switches (theatergen_tpu/ops/flash_attention.py:39-98)
PACKED = os.environ.get("THEATERGEN_FLASH_PACKED", "1") == "1"
FLAT = os.environ.get("THEATERGEN_FLASH_FLAT", "1") == "1"
FLAT_ONLINE = os.environ.get("THEATERGEN_FLASH_FLAT16K", "1") == "1"
BSHD_NATIVE = os.environ.get("THEATERGEN_FLASH_BSHD", "0") == "1"
DEFAULT_Q_BLOCK = int(os.environ.get("THEATERGEN_FLASH_BQ", "512"))
SWITCHES = {"THEATERGEN_FLASH_PACKED": "PACKED",
            "THEATERGEN_FLASH_FLAT": "FLAT",
            "THEATERGEN_FLASH_FLAT16K": "FLAT_ONLINE",
            "THEATERGEN_FLASH_BSHD": "BSHD_NATIVE",
            "THEATERGEN_FLASH_BQ": "DEFAULT_Q_BLOCK"}

# route -> its launch counter (reset and read by callers)
COUNTERS = {"packed": "launches", "flat": "launches",
            "flat_online": "launches_long", "bshd": "launches_bshd",
            "copy": "launches_copy"}
launches = 0
launches_long = 0
launches_bshd = 0
launches_copy = 0


def _pad_head_dim(d: int) -> int:
    """The TPU kernels' lane pad of the head dim: 64 up to 64, else the
    next multiple of 128."""
    return 64 if d <= 64 else -(-d // 128) * 128


def _flat_q_block(sq: int, sk: int, f: int, itemsize: int = 2) -> int:
    """The whole-K TPU kernel's q block (0: none fits its budget)."""
    kv = 2 * sk * f * itemsize
    for bq in (256, 512, 128):
        if bq > sq or sq % bq:
            continue
        est = (kv + 2 * bq * sk * 4 + bq * sk * itemsize
               + 4 * bq * f * itemsize + 2 * 1024 * 1024)
        if est <= _VMEM_BUDGET:
            return bq
    return 0


def _flat_online_blocks(sq: int, sk: int, h: int, dp: int,
                        itemsize: int = 2) -> tuple:
    """The online TPU kernel's (bq, bk) ((0, 0): none fits its budget)."""
    f = h * dp
    for bk in (4096, 2048, 1024, 512):
        if bk > sk or sk % bk:
            continue
        for bq in (256, 512, 128):
            if bq > sq or sq % bq:
                continue
            est = (2 * 2 * bk * f * itemsize + 2 * 2 * bq * f * itemsize
                   + 2 * bq * bk * 4 + bq * bk * itemsize
                   + 2 * h * bq * _LANE * 4 + bq * f * 4 + 2 * 1024 * 1024)
            if est <= _VMEM_BUDGET:
                return bq, bk
    return 0, 0


def route(sq: int, sk: int, heads: int, head_dim: int, itemsize: int = 2,
          quantized: bool = False) -> Optional[str]:
    """The JAX package's route for attention of ``sq`` queries against
    ``sk`` keys (one of :data:`COUNTERS`), or None where it reaches no
    Pallas kernel.  Reads the switches at call time, in the JAX order:

    1. the packed projections, for self-attention of a float layer
       (``models/layers.py:333-339``, ``packed_supported``);
    2. ``multi_head_attention`` → ``fa.supported``: keys 1024..32768 in
       steps of 512, whatever Sq (``ops/attention.py:120-129``);
    3. ``_flash_attention_impl`` (:604-609): BSHD-native where Sq is a
       multiple of its q block, then flat (Sq = Sk ≤ 4096), then
       flat-online (Sq = Sk > 4096) where their blocks fit, else the
       copy-based kernel."""
    dp = _pad_head_dim(head_dim)
    if (PACKED and not quantized and sq == sk and MIN_SEQ <= sq
            <= MAX_WHOLE_K_SEQ and sq % 512 == 0
            and _flat_q_block(sq, sq, heads * dp, itemsize) > 0):
        return "packed"
    if not (MIN_SEQ <= sk <= MAX_SEQ and sk % 512 == 0):
        return None
    if BSHD_NATIVE and sq % min(DEFAULT_Q_BLOCK, sq) == 0:
        return "bshd"
    if (FLAT and sq == sk and sk <= MAX_WHOLE_K_SEQ
            and _flat_q_block(sq, sk, heads * dp, itemsize) > 0):
        return "flat"
    if (FLAT_ONLINE and sq == sk and sk > MAX_WHOLE_K_SEQ
            and _flat_online_blocks(sq, sk, heads, dp, itemsize) != (0, 0)):
        return "flat_online"
    return "copy"


def supported(sq: int, sk: int, heads: int, head_dim: int,
              itemsize: int = 2, quantized: bool = False) -> bool:
    """Whether the JAX package sends this attention to a Pallas kernel
    (:func:`route` is not None)."""
    return route(sq, sk, heads, head_dim, itemsize, quantized) is not None


def launch_plan(b: int, sq: int, h: int, d: int) -> dict:
    """The kernel's launch for q ``[B, Sq, H, D]``: rows per CTA, keys per
    K/V tile (128 up to d = 80, 64 at d = 160), ring stages and CTAs."""
    return dict(q_block=Q_BLOCK, kv_block=128 if d <= 80 else 64,
                stages=KV_STAGES, ctas=-(-sq // Q_BLOCK) * b * h)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Exact softmax attention in fp32 over BSHD; output in q's dtype."""
    return multi_head_attention(q, k, v)


def _lib():
    lib = _build.library("flash_attention")
    fn = lib.tg_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check_operand(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: {name} must be bfloat16, "
                        f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} shape {tuple(x.shape)} "
                         f"!= {tuple(shape)}")
    if (x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3])
            or x.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} needs unit stride on D, "
                         f"other strides a multiple of 8 and a 16-byte "
                         f"aligned base (strides {x.stride()})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    route: Optional[str] = None) -> torch.Tensor:
    """Attention ``[B, Sq, H, D]`` x ``[B, Sk, H, D]`` → ``[B, Sq, H, D]``.
    ``route`` names the JAX route the call stands for, and so the counter
    a launch adds to; without it the call counts as self-attention does
    under the default switches: row 1 up to 4096 keys, row 2 past it.
    Under autograd (``recompute.needs_grad``) the launch goes through
    :class:`FlashAttentionFn`, whose backward is the plain version's."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    if recompute.needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, route)
    return _launch(q, k, v, route)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel's forward, and the gradient of
    :func:`flash_attention_plain` recomputed from the saved q, k, v (the
    JAX package's ``_flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, route):
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, route)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute.plain_vjp(flash_attention_plain, ctx.saved_tensors,
                                   ctx.needs_input_grad[:3],
                                   grad_out) + (None,)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            route: Optional[str]) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors, counted on ``route``'s
    counter."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if route is None:
        route = "flat" if sk <= MAX_WHOLE_K_SEQ else "flat_online"
    if route not in COUNTERS:
        raise ValueError(f"flash_attention: unknown route {route!r} (have "
                         f"{tuple(COUNTERS)})")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} has no kernel "
                         f"instance (have {KERNEL_HEAD_DIMS})")
    _check_operand("q", q, (b, sq, h, d))
    for name, x in (("k", k), ("v", v)):
        _check_operand(name, x, (b, sk, h, d))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    fn = _lib()
    _build.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        d ** -0.5 * LOG2E, torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_attention")
    counter = COUNTERS[route]
    globals()[counter] += 1
    return out


def flops(b: int, s: int, h: int, d: int, sk: Optional[int] = None) -> float:
    """Operations of one call: QK^T and PV, 2·Sq·Sk·d multiply-adds each
    (Sk = Sq unless given)."""
    return 4.0 * b * h * s * (s if sk is None else sk) * d


def min_bytes(b: int, s: int, h: int, d: int, sk: Optional[int] = None,
              itemsize: int = 2) -> float:
    """Bytes of one call: q, k, v read once and the output written once
    (Sk = Sq unless given)."""
    return 2.0 * b * h * d * (s + (s if sk is None else sk)) * itemsize
