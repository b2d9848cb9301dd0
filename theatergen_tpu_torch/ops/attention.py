"""Attention outside the flash kernel's domain: cross-attention (Sk = 77),
self-attention at 256 and 64 tokens, the VAE mid block and the CLIP text
tower.  Counterpart of ``theatergen_tpu/ops/attention.py::
multi_head_attention``, which left these shapes to XLA; here they are a
plain fp32 matmul + softmax.  Library attention stays out of the port.
"""

from __future__ import annotations

from typing import Optional

import torch


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """BSHD attention ``[B, Sq, H, D] x [B, Sk, H, D] → [B, Sq, H, D]``.

    ``mask`` (broadcastable to ``[B, H, Sq, Sk]``, True = attend) drops
    logits where it is False.  Logits and probabilities are fp32; the
    output takes q's dtype."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
