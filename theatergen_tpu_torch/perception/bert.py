"""BERT text encoder, GroundingDINO's text tower: the port of
``theatergen_tpu/perception/bert.py``.

Post-LN transformer with word, position and token-type embeddings
(LayerNorm eps 1e-12, exact-erf GELU).  It takes GroundingDINO's 3-D
block-diagonal self-attention mask (one block per phrase between special
tokens), added as ``(1 - mask) * finfo(float32).min``, and position ids
that restart at each phrase.  Softmax in fp32.  The modules carry
transformers' ``BertModel`` names (``embeddings.LayerNorm``,
``encoder.layer.3.attention.self.query``, ``encoder.layer.3.output.dense``
...), so a published state dict loads almost as it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """transformers' BertConfig (the encoder's part); the defaults are
    bert-base-uncased."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


def tiny_bert_config() -> BertConfig:
    # the vocabulary covers BERT's special ids (101/102/1012/1029)
    return BertConfig(vocab_size=1100, hidden_size=32, num_layers=2,
                      num_heads=2, intermediate_size=64,
                      max_position_embeddings=64)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q·kᵀ/√d + bias)·v over ``[B, H, T, D]`` heads, the softmax
    in fp32 (plain PyTorch: the detector launches none of the port's
    kernels)."""
    logits = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits.float(), dim=-1)
    return probs.to(v.dtype) @ v


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """``[B, T, D]`` → ``[B, H, T, D/H]``."""
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, T, Dh]`` → ``[B, T, H·Dh]``."""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.heads = cfg.num_heads
        self.attention = nn.ModuleDict(dict(
            self=nn.ModuleDict({n: nn.Linear(d, d)
                                for n in ("query", "key", "value")}),
            output=nn.ModuleDict(dict(dense=nn.Linear(d, d),
                                      LayerNorm=nn.LayerNorm(d, eps=eps)))))
        self.intermediate = nn.ModuleDict(dict(
            dense=nn.Linear(d, cfg.intermediate_size)))
        self.output = nn.ModuleDict(dict(
            dense=nn.Linear(cfg.intermediate_size, d),
            LayerNorm=nn.LayerNorm(d, eps=eps)))

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        sa, out = self.attention["self"], self.attention["output"]
        q, k, v = (split_heads(sa[n](x), self.heads)
                   for n in ("query", "key", "value"))
        h = out["dense"](merge_heads(attend(q, k, v, mask)))
        x = out["LayerNorm"](x + h)
        h = F.gelu(self.intermediate["dense"](x))
        h = self.output["dense"](h)
        return self.output["LayerNorm"](x + h)


class BertTextEncoder(nn.Module):
    """``input_ids [B, T]`` (with a bool self-attention mask ``[B, T, T]``
    or ``[B, T]``, token-type and position ids) → the last hidden state
    ``[B, T, D]``."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.embeddings = nn.ModuleDict(dict(
            word_embeddings=nn.Embedding(cfg.vocab_size, d),
            position_embeddings=nn.Embedding(cfg.max_position_embeddings, d),
            token_type_embeddings=nn.Embedding(cfg.type_vocab_size, d),
            LayerNorm=nn.LayerNorm(d, eps=cfg.layer_norm_eps)))
        self.encoder = nn.ModuleDict(dict(layer=nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg.num_layers))))

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, t = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(t, device=dev).expand(b, t)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, t), dtype=torch.long,
                                         device=dev)
        e = self.embeddings
        x = e["LayerNorm"](e["word_embeddings"](input_ids)
                           + e["position_embeddings"](position_ids)
                           + e["token_type_embeddings"](token_type_ids))
        mask = None
        if attention_mask is not None:
            add = (attention_mask[:, None, None, :]
                   if attention_mask.ndim == 2 else attention_mask[:, None])
            mask = (1.0 - add.float()) * torch.finfo(torch.float32).min
        for layer in self.encoder["layer"]:
            x = layer(x, mask)
        return x
