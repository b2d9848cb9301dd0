"""IP-Adapter image projectors and GLIGEN's grounding-token projector
(PyTorch), the port of ``theatergen_tpu/models/ip_adapter.py::
{ImageProjModel, MLPProjModel, PerceiverAttention, Resampler,
PositionNet}``.

Each maps CLIP image features to context tokens that the IP UNet's
decoupled cross-attention (``to_k_ip``/``to_v_ip``, inside the UNet)
reads: ImageProj (base variant: the projected CLS embed → ``num_tokens``
tokens), MLPProj (full: one token) and the perceiver Resampler (plus:
patch tokens → ``resampler_queries`` tokens).  Parameter names are the JAX
package's (``proj``, ``proj_0``, ``layers.0.attn.to_kv`` …), and every
LayerNorm keeps flax's default epsilon, 1e-6 (diffusers' IP-Adapter uses
1e-5).  :class:`PositionNet` carries diffusers'
``GLIGENTextBoundingboxProjection`` names (``linears.0``/``.2``/``.4``,
``null_positive_feature``, ``null_position_feature``).  Plain PyTorch: no
kernel lies on these paths.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import IPAdapterConfig

# flax nn.LayerNorm's default epsilon, which the JAX modules use
LAYER_NORM_EPS = 1e-6


class ImageProjModel(nn.Module):
    """CLIP image_embeds ``[B, D_clip]`` → ``[B, num_tokens, cross_dim]``."""

    def __init__(self, cfg: IPAdapterConfig):
        super().__init__()
        self.cfg = cfg
        self.proj = nn.Linear(cfg.clip_embeddings_dim,
                              cfg.cross_attention_dim * cfg.num_tokens)
        self.norm = nn.LayerNorm(cfg.cross_attention_dim, eps=LAYER_NORM_EPS)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds).reshape(-1, self.cfg.num_tokens,
                                            self.cfg.cross_attention_dim)
        return self.norm(x)


class MLPProjModel(nn.Module):
    """Per-token exact-GELU MLP projector (the full variant): ``[B, D]`` →
    ``[B, 1, cross_dim]``, ``[B, N, D]`` → ``[B, N, cross_dim]``."""

    def __init__(self, cfg: IPAdapterConfig):
        super().__init__()
        d = cfg.clip_embeddings_dim
        self.proj_0 = nn.Linear(d, d)
        self.proj_2 = nn.Linear(d, cfg.cross_attention_dim)
        self.norm = nn.LayerNorm(cfg.cross_attention_dim, eps=LAYER_NORM_EPS)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.proj_2(F.gelu(self.proj_0(image_embeds))))
        return x[:, None] if x.ndim == 2 else x


class PerceiverAttention(nn.Module):
    """Latents query ``[image_feats ; latents]``, with the reference's
    ``1/sqrt(sqrt(d))`` scale on both q and k."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        b, n_lat, _ = latents.shape
        x = self.norm1(x)
        latents_n = self.norm2(latents)
        q = self.to_q(latents_n)
        k, v = self.to_kv(torch.cat([x, latents_n], dim=1)).chunk(2, dim=-1)

        def heads_first(t):
            return t.reshape(b, -1, self.heads, self.head_dim).transpose(1, 2)

        q, k, v = map(heads_first, (q, k, v))
        scale = float(self.head_dim) ** -0.25
        probs = torch.softmax(((q * scale) @ (k * scale).transpose(-1, -2))
                              .float(), dim=-1)
        out = (probs.to(v.dtype) @ v).transpose(1, 2).reshape(b, n_lat, -1)
        return self.to_out(out)


class _ResamplerLayer(nn.Module):
    def __init__(self, cfg: IPAdapterConfig):
        super().__init__()
        dim = cfg.resampler_dim
        self.attn = PerceiverAttention(dim, cfg.resampler_heads,
                                       dim // cfg.resampler_heads)
        self.ff_norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.ff_1 = nn.Linear(dim, dim * 4, bias=False)
        self.ff_2 = nn.Linear(dim * 4, dim, bias=False)


class Resampler(nn.Module):
    """Perceiver resampler over CLIP patch tokens ``[B, N, embedding_dim]``
    → ``[B, resampler_queries, output_dim]`` (the plus variant)."""

    # seeded init draws the learned queries from N(0, 1), as flax does
    init_std = 1.0

    def __init__(self, cfg: IPAdapterConfig, embedding_dim: int = 1280,
                 output_dim: int = 768):
        super().__init__()
        self.latents = nn.Parameter(
            torch.empty(cfg.resampler_queries, cfg.resampler_dim))
        self.proj_in = nn.Linear(embedding_dim, cfg.resampler_dim)
        self.layers = nn.ModuleList(
            [_ResamplerLayer(cfg) for _ in range(cfg.resampler_depth)])
        self.proj_out = nn.Linear(cfg.resampler_dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        latents = self.latents[None].expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for layer in self.layers:
            latents = latents + layer.attn(x, latents)
            h = layer.ff_2(F.gelu(layer.ff_1(layer.ff_norm(latents))))
            latents = latents + h
        return self.norm_out(self.proj_out(latents))


class PositionNet(nn.Module):
    """GLIGEN's grounding-token projector: per-object phrase embeddings
    ``[B, N, text_dim]`` and normalised xyxy boxes ``[B, N, 4]`` →
    ``objs [B, N, out_dim]``, the tokens the UNet's gated self-attention
    fusers read (``UNet2DCondition(..., gligen=True)``).  The boxes'
    Fourier features keep GLIGEN's ``(freq, sin|cos, coord)`` order, as
    the JAX package's; a slot whose mask is 0 takes the learned null
    phrase and position features in place of its own, so padding to a
    fixed ``max_objects`` leaves the real slots as they are."""

    def __init__(self, out_dim: int, text_dim: int = 768,
                 fourier_freqs: int = 8):
        super().__init__()
        self.fourier_freqs = fourier_freqs
        pos_dim = fourier_freqs * 2 * 4
        self.linears = nn.Sequential(
            nn.Linear(text_dim + pos_dim, 512), nn.SiLU(),
            nn.Linear(512, 512), nn.SiLU(), nn.Linear(512, out_dim))
        self.null_positive_feature = nn.Parameter(torch.zeros(text_dim))
        self.null_position_feature = nn.Parameter(torch.zeros(pos_dim))

    def fourier(self, boxes: torch.Tensor) -> torch.Tensor:
        """``[B, N, 4]`` → ``[B, N, 8·F]`` in ``(freq, sin|cos, coord)``
        order."""
        f = self.fourier_freqs
        freq = 100.0 ** (torch.arange(f, dtype=torch.float32,
                                      device=boxes.device) / f)
        ang = boxes.float()[..., None] * freq               # [B, N, 4, F]
        emb = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
        return emb.permute(0, 1, 3, 4, 2).reshape(*boxes.shape[:2], 8 * f)

    def forward(self, boxes: torch.Tensor, masks: torch.Tensor,
                phrase_embeds: torch.Tensor) -> torch.Tensor:
        dtype = self.linears[0].weight.dtype
        m = masks.to(dtype)[..., None]
        xyxy = self.fourier(boxes).to(dtype)
        xyxy = xyxy * m + (1 - m) * self.null_position_feature
        txt = (phrase_embeds.to(dtype) * m
               + (1 - m) * self.null_positive_feature)
        return self.linears(torch.cat([txt, xyxy], dim=-1))
