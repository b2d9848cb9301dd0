"""Flash self-attention: the Hopper counterpart of
``theatergen_tpu/ops/flash_attention.py::flash_attention_packed``.

:func:`flash_attention` takes ``[B, S, H, D]`` q, k, v (strided views of a
projection are fine) and returns ``[B, S, H, D]``.  On a CUDA tensor it
launches the hand-written kernel of ``csrc/flash_attention.cu`` (see the
note there: one block per (batch·head, 64 query rows), online softmax in
fp32 registers, QK^T and PV on bf16 tensor cores, head dims 40 (padded to
48 in shared memory), 64 and 80) or raises.  On a CPU tensor it runs
:func:`flash_attention_plain`, the same function in plain PyTorch.

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
# the domain of the TPU kernel's gate (packed_supported): self-attention
# at 1024..4096 tokens in steps of 512
MIN_SEQ = 1024
MAX_SEQ = 4096
# head dims with a compiled kernel instance (csrc/flash_attention.cu)
KERNEL_HEAD_DIMS = (40, 64, 80)

# kernel launches made by flash_attention (reset and read by callers)
launches = 0


def supported(sq: int, sk: int) -> bool:
    """Whether attention of these lengths is in the flash kernel's domain
    (the TPU gate's: self-attention at 1024..4096 tokens, steps of 512)."""
    return sq == sk and MIN_SEQ <= sq <= MAX_SEQ and sq % 512 == 0


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
    global launches
    launches += 1
    return out


def flops(b: int, s: int, h: int, d: int) -> float:
    """Operations of one call: QK^T and PV, 2·S²·d multiply-adds each."""
    return 4.0 * b * h * s * s * d


def min_bytes(b: int, s: int, h: int, d: int, itemsize: int = 2) -> float:
    """Bytes of one call: q, k, v read once and the output written once."""
    return 4.0 * b * s * h * d * itemsize

