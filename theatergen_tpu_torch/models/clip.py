"""CLIP text tower (PyTorch), the port of
``theatergen_tpu/models/clip.py::CLIPTextEncoder``: quick_gelu (SD1.5,
SDXL tower 1) or exact gelu (SDXL tower 2, OpenCLIP bigG) MLPs, a causal
mask, fp32 by default.  Parameter names follow the HF
``CLIPTextModel`` layout (``embeddings.token_embedding``,
``encoder.layers.0.self_attn.q_proj`` …).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CLIPTextConfig
from ..ops.attention import multi_head_attention


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, intermediate: int, act: str = "quick_gelu"):
        super().__init__()
        self.act = act
        self.fc1 = nn.Linear(dim, intermediate)
        self.fc2 = nn.Linear(intermediate, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.act == "quick_gelu":
            h = h * torch.sigmoid(1.702 * h)
        else:
            h = F.gelu(h)
        return self.fc2(h)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        b, l, c = x.shape
        shape = (b, l, self.num_heads, c // self.num_heads)
        out = multi_head_attention(self.q_proj(x).view(shape),
                                   self.k_proj(x).view(shape),
                                   self.v_proj(x).view(shape), mask=mask)
        return self.out_proj(out.reshape(b, l, c))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        dim = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(dim, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(dim, cfg.intermediate_size, cfg.act)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_length,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_layers)])


class CLIPTextEncoder(nn.Module):
    """``input_ids [B, L]`` → ``(last_hidden_state [B, L, C], pooled [B, P])``;
    pooled is the final-LN state at each row's EOT (highest id) token,
    through ``text_projection`` where the tower has one.  With
    ``return_penultimate`` a third output is the input of the last layer
    (not final-LN'd), which SDXL conditions on."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)
        self.text_projection = (
            nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
            if cfg.use_text_projection
            or cfg.projection_dim != cfg.hidden_size else None)

    def forward(self, input_ids: torch.Tensor,
                return_penultimate: bool = False):
        b, l = input_ids.shape
        emb = self.embeddings
        x = (emb.token_embedding(input_ids)
             + emb.position_embedding.weight[None, :l])
        causal = torch.ones((l, l), dtype=torch.bool,
                            device=input_ids.device).tril()[None, None]
        penultimate = None
        for i, layer in enumerate(self.encoder.layers):
            if i == len(self.encoder.layers) - 1:
                penultimate = x
            x = layer(x, causal)
        x = self.final_layer_norm(x)
        pooled = x[torch.arange(b, device=x.device), input_ids.argmax(-1)]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        if return_penultimate:
            return x, pooled, penultimate
        return x, pooled
