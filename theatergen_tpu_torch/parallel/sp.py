"""Sequence-parallel attention over a mesh axis: the port of
``theatergen_tpu/parallel/sp.py`` ("all-gather KV").

Each rank holds a contiguous ``Sq / n`` slice of the queries, keys and
values; it all-gathers the whole key and value sequence over the axis and
runs the attention of its query slice against it, so its output is its
slice of the whole output and needs no further collective.  The kernel is
row 4's flash route with Sq ≠ Sk (``ops/flash_attention``, route "copy"),
which takes any query count; the plain version is
``ops/attention.multi_head_attention``.
"""

from __future__ import annotations

import torch

from ..ops import attention as attn_ops
from ..ops import flash_attention as fa_ops
from . import collectives


def sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                 axis: str = "dp", *, use_flash: bool = True
                 ) -> torch.Tensor:
    """Attention of this rank's query slice ``q [B, Sq/n, H, D]`` (from
    :func:`sp_sharded`, which raises, with JAX's message, for an Sq that
    does not divide by the axis size) against the whole sequence,
    gathered from every rank's ``k``/``v`` slices ``[B, Sk/n, H, D]`` over
    ``mesh``'s ``axis``; returns this rank's slice of the output.  With
    ``use_flash`` and bf16 inputs of a head dim the kernel has, the flash
    kernel runs the slice on its Sq ≠ Sk route; otherwise the plain
    attention."""
    k_full = collectives.all_gather(mesh, k, axis, dim=1)
    v_full = collectives.all_gather(mesh, v, axis, dim=1)
    if (use_flash and q.dtype == torch.bfloat16
            and q.shape[-1] in fa_ops.KERNEL_HEAD_DIMS):
        return fa_ops.flash_attention(q, k_full, v_full, route="copy")
    return attn_ops.multi_head_attention(q, k_full, v_full)


def sp_sharded(mesh, x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """This rank's slice of a whole ``[B, S, H, D]`` tensor: S cut into the
    axis size's contiguous pieces (JAX places the same slices on its
    devices); an S that does not divide raises, as JAX's
    ``sp_attention`` does."""
    n = mesh.shape[axis]
    if x.shape[1] % n != 0:
        raise ValueError(f"Sq={x.shape[1]} not divisible by {axis}={n}")
    s = x.shape[1] // n
    i = mesh.index(axis)
    return x[:, i * s:(i + 1) * s].contiguous()
