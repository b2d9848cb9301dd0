"""Attention outside the flash kernel's domain: cross-attention (Sk = 77,
or 77 + the IP tokens), self-attention at 256 and 64 tokens, the VAE mid
block and the CLIP towers.  Counterpart of
``theatergen_tpu/ops/attention.py::{attention_probs, multi_head_attention,
decoupled_attention}``, which left these shapes to XLA; here they are a
plain fp32 matmul + softmax.  Library attention stays out of the port.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_probs(q: torch.Tensor, k: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax probabilities ``[B, H, Sq, Sk]`` in fp32 of BSHD q and k.

    ``mask`` (broadcastable to ``[B, H, Sq, Sk]``, True = attend) drops
    logits where it is False."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, mask: Optional[torch.Tensor] = None,
                         return_probs: bool = False):
    """BSHD attention ``[B, Sq, H, D] x [B, Sk, H, D] → [B, Sq, H, D]``.

    Logits and probabilities are fp32; the output takes q's dtype.  With
    ``return_probs`` returns ``(out, probs [B, H, Sq, Sk])``."""
    p = attention_probs(q, k, mask)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return (out, p) if return_probs else out


def decoupled_attention(q: torch.Tensor, k_text: torch.Tensor,
                        v_text: torch.Tensor, k_ip: torch.Tensor,
                        v_ip: torch.Tensor, ip_scale, *,
                        return_probs: bool = False):
    """IP-Adapter decoupled cross-attention:
    ``Attn(q, k_text, v_text) + ip_scale · Attn(q, k_ip, v_ip)``, the image
    branch an explicit fp32 softmax over the few IP keys.  ``ip_scale`` is
    a float or a 0-dim tensor (one tensor serves a DB hit and a miss with
    no host round trip), or a ``[B]`` tensor, one scale per batch row,
    broadcast over tokens and heads (a batch of characters, DB hits and
    misses together).  With ``return_probs`` returns ``(out, probs)``,
    the probabilities of the text branch only."""
    res = multi_head_attention(q, k_text, v_text, return_probs=return_probs)
    out_text, probs = res if return_probs else (res, None)
    out_ip = multi_head_attention(q, k_ip, v_ip)
    if torch.is_tensor(ip_scale) and ip_scale.ndim == 1:
        ip_scale = ip_scale.view(-1, 1, 1, 1).to(out_ip.dtype)
    out = out_text + ip_scale * out_ip
    return (out, probs) if return_probs else out
