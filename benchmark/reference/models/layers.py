"""Building blocks of the UNets, VAE and adapters in plain PyTorch.

A frozen copy of the port's layer code with every kernel route taken
out: GroupNorm is ``F.group_norm`` (in fp32 where the layer asks for it),
the feed-forward is its two linears, and attention is the explicit
softmax of ``ops/attention.py``.  Parameter names are the port's
(diffusers' names), so one state dict loads into both.  W8A8 layers and
the tensor-parallel linears have no place here: a quantized config is
refused.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention as attn_ops

# flax nn.LayerNorm's default epsilon, which the transformer blocks use
LAYER_NORM_EPS = 1e-6


def make_linear(quantized: bool, in_features: int, out_features: int, *,
                bias: bool = True) -> nn.Module:
    if quantized:
        raise ValueError("the plain reference has no W8A8 layers")
    return nn.Linear(in_features, out_features, bias=bias)


def get_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[B] → [B, dim]`` (fp32)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int, quantized: bool = False):
        super().__init__()
        self.linear_1 = make_linear(quantized, in_dim, dim)
        self.linear_2 = make_linear(quantized, dim, dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW with an optional SiLU after it."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 act: Optional[str] = None, fp32: bool = True):
        super().__init__(num_groups, channels, eps=eps)
        if act not in (None, "silu"):
            raise ValueError(f"unsupported act {act!r}")
        self.act = act
        self.fp32 = fp32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fp32:
            out = F.group_norm(x.float(), self.num_groups,
                               self.weight.float(), self.bias.float(),
                               self.eps).to(x.dtype)
        else:
            out = F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                               self.bias.to(x.dtype), self.eps)
        return F.silu(out) if self.act == "silu" else out


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 fast_norm: bool = False, quantized: bool = False):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, act="silu",
                               fp32=not fast_norm)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            make_linear(quantized, temb_channels, out_channels)
            if temb_channels is not None else None)
        self.norm2 = GroupNorm(groups, out_channels, act="silu",
                               fp32=not fast_norm)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, quantized: bool = False):
        super().__init__()
        self.proj = make_linear(quantized, dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU → down projection (``net.0`` / ``net.2``)."""

    def __init__(self, dim: int, mult: int = 4, fused_ff: bool = False,
                 quantized: bool = False):
        super().__init__()
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult, quantized), nn.Identity(),
             make_linear(quantized, dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class CrossAttention(nn.Module):
    """Attention with no-bias q/k/v and a biased output projection; the
    last ``ip_tokens`` rows of a context are IP-Adapter image tokens with
    their own ``to_k_ip``/``to_v_ip``."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, use_flash: bool = True,
                 ip_tokens: int = 0, quantized: bool = False):
        super().__init__()
        inner = heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.head_dim = heads, head_dim
        self.ip_tokens = ip_tokens
        self.to_q = make_linear(quantized, query_dim, inner, bias=False)
        self.to_k = make_linear(quantized, context_dim, inner, bias=False)
        self.to_v = make_linear(quantized, context_dim, inner, bias=False)
        if ip_tokens:
            self.to_k_ip = make_linear(quantized, context_dim, inner,
                                       bias=False)
            self.to_v_ip = make_linear(quantized, context_dim, inner,
                                       bias=False)
        self.to_out = nn.ModuleList([make_linear(quantized, inner, query_dim),
                                     nn.Identity()])

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None, *,
                ip_scale=1.0, return_probs: bool = False):
        b, lq, _ = x.shape
        ctx = x if context is None else context
        shape = (b, -1, self.heads, self.head_dim)
        q = self.to_q(x).view(shape)
        if self.ip_tokens and context is not None:
            text_len = ctx.shape[1] - self.ip_tokens
            text, image = ctx[:, :text_len], ctx[:, text_len:]
            res = attn_ops.decoupled_attention(
                q, self.to_k(text).view(shape), self.to_v(text).view(shape),
                self.to_k_ip(image).view(shape),
                self.to_v_ip(image).view(shape), ip_scale,
                return_probs=return_probs)
        else:
            res = attn_ops.multi_head_attention(
                q, self.to_k(ctx).view(shape), self.to_v(ctx).view(shape),
                return_probs=return_probs)
        out, probs = res if return_probs else (res, None)
        out = self.to_out[0](out.reshape(b, lq, -1))
        return (out, probs) if return_probs else out


class BasicTransformerBlock(nn.Module):
    """self-attn → cross-attn → FF, each behind a pre-LayerNorm; with
    ``capture_probs`` returns the cross-attention's probabilities too."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 use_flash: bool = True, fused_ff: bool = False,
                 ip_tokens: int = 0, quantized: bool = False,
                 gligen: bool = False):
        super().__init__()
        if gligen:
            raise ValueError("the plain reference has no GLIGEN fusers")
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn1 = CrossAttention(dim, heads, head_dim, quantized=quantized)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim,
                                    ip_tokens=ip_tokens, quantized=quantized)
        self.norm3 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.ff = FeedForward(dim, quantized=quantized)

    def forward(self, x: torch.Tensor, context: torch.Tensor, *,
                ip_scale=1.0, capture_probs: bool = False, objs=None):
        x = x + self.attn1(self.norm1(x))
        h = self.attn2(self.norm2(x), context, ip_scale=ip_scale,
                       return_probs=capture_probs)
        h, probs = h if capture_probs else (h, None)
        x = x + h
        x = x + self.ff(self.norm3(x))
        return (x, probs) if capture_probs else x


class Transformer2D(nn.Module):
    """GN → 1×1 proj_in → transformer blocks → 1×1 proj_out, plus the
    residual; with ``capture_layers`` also ``{index: probs}``."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, depth: int = 1, groups: int = 32,
                 fast_norm: bool = False, use_flash: bool = True,
                 fused_ff: bool = False, ip_tokens: int = 0,
                 quantized: bool = False, gligen: bool = False):
        super().__init__()
        self.norm = GroupNorm(groups, channels, fp32=not fast_norm)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, head_dim, context_dim,
                                  ip_tokens=ip_tokens, quantized=quantized,
                                  gligen=gligen)
            for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor, *,
                ip_scale=1.0, capture_layers: Tuple[int, ...] = (),
                objs=None):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        captured = {}
        for i, block in enumerate(self.transformer_blocks):
            if i in capture_layers:
                y, captured[i] = block(y, context, ip_scale=ip_scale,
                                       capture_probs=True)
            else:
                y = block(y, context, ip_scale=ip_scale)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        out = self.proj_out(y) + x
        return (out, captured) if capture_layers else out
