"""Flash self-attention: the Hopper counterpart of
``theatergen_tpu/ops/flash_attention.py::flash_attention_packed``
(``_flat_call``, S ≤ 4096) and ``_flash_attention_flat_online``
(``_flat_online_call``, 4096 < S ≤ 32768).

:func:`flash_attention` takes ``[B, S, H, D]`` q, k, v (strided views of a
projection are fine) and returns ``[B, S, H, D]``.  On a CUDA tensor it
launches the hand-written kernel of ``csrc/flash_attention.cu`` (see the
note there: one block per (batch·head, 64 query rows), online softmax in
fp32 registers over 64-key tiles, QK^T and PV on bf16 tensor cores, head
dims 40 (padded to 48 in shared memory), 64 and 80) or raises.  On a CPU
tensor it runs :func:`flash_attention_plain`, the same function in plain
PyTorch.

The JAX package has two Pallas routes for self-attention: the whole-K
kernel up to 4096 tokens and the online kernel past it.  The one kernel
here is online at every length, so both routes launch it; a call past
4096 tokens counts in :data:`launches_long`, any other in
:data:`launches`.  :func:`supported` is the set of shapes where the JAX
package reaches either Pallas kernel.  Outside it the JAX package leaves
attention to XLA, and the port to its plain ``multi_head_attention``: for
SD1.5 on a 768-px canvas that is level 1 (48² = 2304 tokens, not a
multiple of 512) and every shorter self-attention.  That is the JAX
package's own route, not a fallback.

The TPU package folds the 1/sqrt(d) scale, the base-2 exponent and a lane
pad into packed projection weights (a Mosaic layout device); the kernel
here applies the scale to its fp32 logits and reads BSHD directly.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .attention import multi_head_attention

LOG2E = 1.4426950408889634
# the TPU gates' lengths: self-attention at 1024..32768 tokens in steps of
# 512, the whole-K kernel up to 4096 (packed_supported, flat_supported)
# and the online one past it (flat_online_supported)
MIN_SEQ = 1024
MAX_WHOLE_K_SEQ = 4096
MAX_SEQ = 32768
# head dims with a compiled kernel instance (csrc/flash_attention.cu)
KERNEL_HEAD_DIMS = (40, 64, 80)
# the TPU gates' scoped-VMEM budget and lane width, kept so that the block
# searches below, copies of the JAX package's, accept the same shapes
_VMEM_BUDGET = 80 * 1024 * 1024
_LANE = 128

# kernel launches made by flash_attention at S ≤ 4096 and past it (reset
# and read by callers)
launches = 0
launches_long = 0


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


def supported(sq: int, sk: int, heads: int, head_dim: int,
              itemsize: int = 2) -> bool:
    """Whether the JAX package sends self-attention of this shape to a
    Pallas flash kernel: ``packed_supported`` (equivalently
    ``flat_supported``) up to 4096 tokens, ``fa.supported`` and
    ``flat_online_supported`` past it."""
    if sq != sk or sq % 512 or not MIN_SEQ <= sq <= MAX_SEQ:
        return False
    dp = _pad_head_dim(head_dim)
    if sq <= MAX_WHOLE_K_SEQ:
        return _flat_q_block(sq, sk, heads * dp, itemsize) > 0
    return _flat_online_blocks(sq, sk, heads, dp, itemsize) != (0, 0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Exact softmax attention in fp32 over BSHD; output in q's dtype."""
    return multi_head_attention(q, k, v)


def _lib():
    lib = _build.library("flash_attention")
    fn = lib.tg_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
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


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Self-attention ``[B, S, H, D]`` → ``[B, S, H, D]`` (Sq = Sk)."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v)
    b, s, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} has no kernel "
                         f"instance (have {KERNEL_HEAD_DIMS})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, (b, s, h, d))
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    fn = _lib()
    _build.check(fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        d ** -0.5 * LOG2E, torch.cuda.current_stream(q.device).cuda_stream,
    ), "flash_attention")
    global launches, launches_long
    if s > MAX_WHOLE_K_SEQ:
        launches_long += 1
    else:
        launches += 1
    return out


def flops(b: int, s: int, h: int, d: int) -> float:
    """Operations of one call: QK^T and PV, 2·S²·d multiply-adds each."""
    return 4.0 * b * h * s * s * d


def min_bytes(b: int, s: int, h: int, d: int, itemsize: int = 2) -> float:
    """Bytes of one call: q, k, v read once and the output written once."""
    return 4.0 * b * s * h * d * itemsize

