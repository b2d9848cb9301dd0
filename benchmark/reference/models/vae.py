"""AutoencoderKL (PyTorch, NCHW), the port of
``theatergen_tpu/models/vae.py``: ResNet stages, one single-head mid
self-attention, GN+silu heads.  Parameter names follow diffusers
(``decoder.mid_block.attentions.0.to_q``, ``post_quant_conv`` …).  The
pipelines apply and remove ``scaling_factor`` themselves.  Norms run in
fp32, as in the JAX package (``GroupNorm(dtype=None)``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from ..config import VAEConfig
from ..ops.attention import multi_head_attention
from .layers import Downsample2D, GroupNorm, ResnetBlock2D, Upsample2D


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels),
                                     nn.Identity()])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, 1, c)
        out = multi_head_attention(self.to_q(y), self.to_k(y), self.to_v(y))
        out = self.to_out[0](out.reshape(b, h * w, c))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _Mid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch, groups=groups),
                                      ResnetBlock2D(ch, ch, groups=groups)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, groups = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        h_ch = boc[0]
        for i, ch in enumerate(boc):
            lvl = _Level()
            for _ in range(cfg.layers_per_block):
                lvl.resnets.append(ResnetBlock2D(h_ch, ch, groups=groups))
                h_ch = ch
            if i < len(boc) - 1:
                lvl.downsamplers = nn.ModuleList([Downsample2D(ch)])
            self.down_blocks.append(lvl)
        self.mid_block = _Mid(boc[-1], groups)
        self.conv_norm_out = GroupNorm(groups, boc[-1], act="silu")
        # mean and logvar of the diagonal Gaussian posterior
        self.conv_out = nn.Conv2d(boc[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for lvl in self.down_blocks:
            for res in lvl.resnets:
                h = res(h)
            if hasattr(lvl, "downsamplers"):
                h = lvl.downsamplers[0](h)
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, groups = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, boc[-1], 3, padding=1)
        self.mid_block = _Mid(boc[-1], groups)
        self.up_blocks = nn.ModuleList()
        h_ch = boc[-1]
        for idx, ch in enumerate(reversed(boc)):
            lvl = _Level()
            for _ in range(cfg.layers_per_block + 1):
                lvl.resnets.append(ResnetBlock2D(h_ch, ch, groups=groups))
                h_ch = ch
            if idx < len(boc) - 1:
                lvl.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(lvl)
        self.conv_norm_out = GroupNorm(groups, boc[0], act="silu")
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for lvl in self.up_blocks:
            for res in lvl.resnets:
                h = res(h)
            if hasattr(lvl, "upsamplers"):
                h = lvl.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """``encode`` image [-1, 1] → (mean, logvar); ``decode`` latent →
    image in [-1, 1]; all NCHW."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)
        self.decoder = Decoder(cfg)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        moments = self.quant_conv(self.encoder(x.to(self.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)))
