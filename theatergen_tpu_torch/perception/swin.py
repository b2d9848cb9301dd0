"""Swin Transformer backbone, GroundingDINO's vision tower: the port of
``theatergen_tpu/perception/swin.py``.

Swin-T emits its stage-2/3/4 feature maps (NHWC at the boundary, as in the
JAX package).  The numpy constants are those of the JAX package, built once
per shape and device: the shifted-window attention mask on the padded grid
and the relative-position gather index.  Each block partitions always (the
``always_partition`` of transformers' backbone path): the configured
window and shift apply at every resolution, and a resolution that is not a
multiple of the window is padded at the bottom and right first; patch
merging pads an odd resolution and rounds up.  Softmax in fp32.  The
modules carry transformers' ``SwinBackbone`` names
(``embeddings.patch_embeddings.projection``,
``encoder.layers.2.blocks.5.attention.self.relative_position_bias_table``,
``encoder.layers.1.downsample.reduction``, ``hidden_states_norms.stage3``
...).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .bert import attend, merge_heads, split_heads


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """transformers' SwinConfig (the backbone's part); the defaults are
    Swin-T (microsoft/swin-tiny-patch4-window7-224), as
    IDEA-Research/grounding-dino-tiny uses it."""

    image_size: int = 224
    patch_size: int = 4
    num_channels: int = 3
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-5
    # the stages (1-based, transformers' "stage{i}") whose maps are emitted
    out_stages: Tuple[int, ...] = (2, 3, 4)

    def stage_dim(self, stage: int) -> int:
        return int(self.embed_dim * 2 ** (stage - 1))


def tiny_swin_config() -> SwinConfig:
    return SwinConfig(image_size=64, patch_size=4, embed_dim=16,
                      depths=(1, 2), num_heads=(2, 2), window_size=4,
                      out_stages=(1, 2))


def _rel_pos_index(ws: int) -> np.ndarray:
    """``[ws², ws²]`` gather indices into the ``((2ws-1)², heads)`` bias
    table (transformers' ``relative_position_index`` buffer)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Additive -100/0 mask ``[windows, ws², ws²]`` of the shifted windows
    on an ``h × w`` grid (transformers' ``SwinLayer.get_attn_mask``)."""
    img = np.zeros((h, w))
    count = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = count
            count += 1
    img = img.reshape(h // ws, ws, w // ws, ws)
    win = img.transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rel_index_on(ws: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rel_pos_index(ws).reshape(-1)).to(device)


@functools.lru_cache(maxsize=None)
def _shift_mask_on(h: int, w: int, ws: int, shift: int,
                   device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_shift_attn_mask(h, w, ws, shift)).to(device)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """``[B, H, W, C]`` → ``[B·windows, ws², C]``, windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def window_reverse(win: torch.Tensor, ws: int, h: int, w: int
                   ) -> torch.Tensor:
    c = win.shape[-1]
    x = win.reshape(-1, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, w, c)


class SwinSelfAttention(nn.Module):
    def __init__(self, cfg: SwinConfig, dim: int, heads: int):
        super().__init__()
        self.heads, self.ws = heads, cfg.window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * cfg.window_size - 1) ** 2, heads))
        self.query = nn.Linear(dim, dim, bias=cfg.qkv_bias)
        self.key = nn.Linear(dim, dim, bias=cfg.qkv_bias)
        self.value = nn.Linear(dim, dim, bias=cfg.qkv_bias)

    def forward(self, x: torch.Tensor, mask) -> torch.Tensor:
        """``x [windows, T, C]``; ``mask [nw, T, T]`` additive or None."""
        t = x.shape[1]
        rel = self.relative_position_bias_table[_rel_index_on(self.ws,
                                                              x.device)]
        bias = rel.reshape(t, t, self.heads).permute(2, 0, 1)
        q, k, v = (split_heads(m(x), self.heads)
                   for m in (self.query, self.key, self.value))
        if mask is None:
            return merge_heads(attend(q, k, v, bias))
        # the windows of each image share the mask: [B, nw, H, T, ·]
        nw = mask.shape[0]
        q, k, v = (y.reshape(-1, nw, *y.shape[1:]) for y in (q, k, v))
        out = attend(q, k, v, bias + mask[:, None])
        return merge_heads(out.reshape(-1, *out.shape[2:]))


class SwinLayer(nn.Module):
    """W-MSA (``shift`` 0) or SW-MSA block, pre-LN."""

    def __init__(self, cfg: SwinConfig, dim: int, heads: int, shift: int):
        super().__init__()
        eps = cfg.layer_norm_eps
        self.ws, self.shift, self.dim = cfg.window_size, shift, dim
        hidden = int(dim * cfg.mlp_ratio)
        self.layernorm_before = nn.LayerNorm(dim, eps=eps)
        self.attention = nn.ModuleDict(dict(
            self=SwinSelfAttention(cfg, dim, heads),
            output=nn.ModuleDict(dict(dense=nn.Linear(dim, dim)))))
        self.layernorm_after = nn.LayerNorm(dim, eps=eps)
        self.intermediate = nn.ModuleDict(dict(dense=nn.Linear(dim, hidden)))
        self.output = nn.ModuleDict(dict(dense=nn.Linear(hidden, dim)))

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        ws, shift = self.ws, self.shift
        b = x.shape[0]
        shortcut = x
        x = self.layernorm_before(x).reshape(b, h, w, self.dim)
        pad_r, pad_b = (ws - w % ws) % ws, (ws - h % ws) % ws
        if pad_r or pad_b:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _shift_mask_on(hp, wp, ws, shift, x.device)
        win = self.attention["self"](window_partition(x, ws), mask)
        x = window_reverse(self.attention["output"]["dense"](win), ws, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, h * w, self.dim)
        y = F.gelu(self.intermediate["dense"](self.layernorm_after(x)))
        return x + self.output["dense"](y)


class SwinPatchMerging(nn.Module):
    """2×2 neighbourhoods concatenated → LayerNorm → a linear halving."""

    def __init__(self, cfg: SwinConfig, dim: int):
        super().__init__()
        self.dim = dim
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b = x.shape[0]
        x = x.reshape(b, h, w, self.dim)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * self.dim)))


class SwinStage(nn.Module):
    def __init__(self, cfg: SwinConfig, si: int):
        super().__init__()
        dim = cfg.stage_dim(si + 1)
        self.blocks = nn.ModuleList(
            SwinLayer(cfg, dim, cfg.num_heads[si],
                      0 if li % 2 == 0 else cfg.window_size // 2)
            for li in range(cfg.depths[si]))
        self.downsample = (SwinPatchMerging(cfg, dim)
                           if si < len(cfg.depths) - 1 else None)


class SwinBackbone(nn.Module):
    """Patch embedding → stages → a LayerNorm per emitted stage:
    ``pixels [B, S, S, 3]`` → the NHWC maps of ``cfg.out_stages``."""

    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.ModuleDict(dict(
            patch_embeddings=nn.ModuleDict(dict(projection=nn.Conv2d(
                cfg.num_channels, cfg.embed_dim, cfg.patch_size,
                stride=cfg.patch_size))),
            norm=nn.LayerNorm(cfg.embed_dim, eps=1e-5)))
        self.encoder = nn.ModuleDict(dict(layers=nn.ModuleList(
            SwinStage(cfg, si) for si in range(len(cfg.depths)))))
        self.hidden_states_norms = nn.ModuleDict({
            f"stage{s}": nn.LayerNorm(cfg.stage_dim(s), eps=1e-5)
            for s in cfg.out_stages})

    def forward(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        b = pixels.shape[0]
        x = self.embeddings["patch_embeddings"]["projection"](
            pixels.permute(0, 3, 1, 2))
        h, w = x.shape[-2:]
        x = self.embeddings["norm"](x.flatten(2).transpose(1, 2))
        outs = []
        for si, stage in enumerate(self.encoder["layers"]):
            for block in stage.blocks:
                x = block(x, h, w)
            if (si + 1) in self.cfg.out_stages:
                y = self.hidden_states_norms[f"stage{si + 1}"](x)
                outs.append(y.reshape(b, h, w, -1))
            if stage.downsample is not None:
                x = stage.downsample(x, h, w)
                h, w = (h + 1) // 2, (w + 1) // 2
        return tuple(outs)
