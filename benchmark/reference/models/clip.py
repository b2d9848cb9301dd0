"""CLIP towers (PyTorch), the port of
``theatergen_tpu/models/clip.py::{CLIPTextEncoder, CLIPVisionEncoder}``.

The text tower: quick_gelu (SD1.5, SDXL tower 1) or exact gelu (SDXL
tower 2, OpenCLIP bigG) MLPs, a causal mask, fp32 by default.  The vision
tower (ViT-H/14 for IP-Adapter): a bias-free patch convolution, class and
position embeddings, ``pre_layrnorm``, quick_gelu layers, fp32.  Parameter
names follow HF's ``CLIPTextModel`` / ``CLIPVisionModelWithProjection``
layouts (``embeddings.token_embedding``, ``embeddings.patch_embedding``,
``encoder.layers.0.self_attn.q_proj`` …); OWL-ViT builds its towers
from the same modules (``perception/owl.py``).  :func:`clip_similarity`
scores image against text embeddings.  Attention goes through
``ops.attention.multi_head_attention``, as the JAX package leaves it to
XLA.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CLIPTextConfig, CLIPVisionConfig
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
    def __init__(self, cfg, act: str = "quick_gelu"):
        super().__init__()
        dim = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(dim, cfg.num_heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(dim, cfg.intermediate_size, act)

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
    def __init__(self, cfg, act: str = "quick_gelu"):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg, act) for _ in range(cfg.num_layers)])


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
        self.encoder = _Encoder(cfg, cfg.act)
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


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.position_embedding = nn.Embedding(n + 1, cfg.hidden_size)


class CLIPVisionEncoder(nn.Module):
    """``pixels [B, 3, S, S]`` (CLIP-normalised) → ``(image_embeds [B, P],
    pooled [B, C], penultimate [B, N+1, C])``: ``visual_projection`` of the
    post-LN CLS token (what IP-Adapter's ImageProj takes), that token, and
    the input of the last layer (the plus variant's Resampler input).  With
    ``return_tokens`` a fourth output is ``post_layernorm`` over the whole
    sequence.

    ``pre_norm`` names the pre-norm as the checkpoint does: CLIP's
    ``pre_layrnorm`` (sic), OWL-ViT's ``pre_layernorm``.  Without
    ``projection`` the tower has no ``visual_projection`` (OWL-ViT keeps it
    beside the tower) and ``image_embeds`` is None."""

    def __init__(self, cfg: CLIPVisionConfig, *,
                 pre_norm: str = "pre_layrnorm", projection: bool = True):
        super().__init__()
        self.cfg = cfg
        self.pre_norm = pre_norm
        self.embeddings = _VisionEmbeddings(cfg)
        setattr(self, pre_norm, nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps))
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)
        self.visual_projection = (
            nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)
            if projection else None)

    def forward(self, pixels: torch.Tensor, return_tokens: bool = False):
        emb = self.embeddings
        x = emb.patch_embedding(pixels.to(emb.class_embedding.dtype))
        x = x.flatten(2).transpose(1, 2)                  # [B, N, C]
        cls = emb.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None]
        x = getattr(self, self.pre_norm)(x)
        penultimate = None
        for i, layer in enumerate(self.encoder.layers):
            if i == len(self.encoder.layers) - 1:
                penultimate = x
            x = layer(x)
        normed = self.post_layernorm(x)
        pooled = normed[:, 0]
        embeds = (None if self.visual_projection is None
                  else self.visual_projection(pooled))
        if return_tokens:
            return embeds, pooled, penultimate, normed
        return embeds, pooled, penultimate


def clip_similarity(image_embeds: torch.Tensor, text_embeds: torch.Tensor,
                    logit_scale: float = 100.0) -> torch.Tensor:
    """Cosine-similarity logits ``[Ni, Nt]``, the eval metric's core
    (``CMIGBench/eval/eval.py:97-228``)."""
    a = image_embeds / torch.linalg.vector_norm(image_embeds, dim=-1,
                                                keepdim=True)
    b = text_embeds / torch.linalg.vector_norm(text_embeds, dim=-1,
                                               keepdim=True)
    return logit_scale * a @ b.T
