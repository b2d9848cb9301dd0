"""ControlNet (PyTorch, NCHW): the port of
``theatergen_tpu/models/controlnet.py``, under diffusers' ``ControlNetModel``
parameter names (``controlnet_cond_embedding.*``,
``controlnet_down_blocks.{i}``, ``controlnet_mid_block``, and the copied
encoder's ``conv_in``, ``time_embedding``, ``down_blocks``,
``mid_block``).

The encoder and mid block are ``models/unet.py::UNetEncoder``, the UNet's
own, so they reach the same kernels at the same shapes (flash
self-attention, the fused FF and the GroupNorm kernel).  The hint's
embedding is added right after ``conv_in``; a 1×1 convolution per skip and
one after the mid block give the residuals, each times
``conditioning_scale``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import ControlNetConfig
from .unet import UNetEncoder, attender


class ConditioningEmbedding(nn.Module):
    """Hint image → a feature map at the latent's resolution: a 3×3 conv
    stack with a stride-2 conv per stage and SiLU between, ending in
    ``conv_out``."""

    def __init__(self, conditioning_channels: int, out_channels: int,
                 embed_channels: Tuple[int, ...]):
        super().__init__()
        self.conv_in = nn.Conv2d(conditioning_channels, embed_channels[0], 3,
                                 padding=1)
        self.blocks = nn.ModuleList()
        for cin, cout in zip(embed_channels[:-1], embed_channels[1:]):
            self.blocks.append(nn.Conv2d(cin, cin, 3, padding=1))
            self.blocks.append(nn.Conv2d(cin, cout, 3, stride=2, padding=1))
        self.conv_out = nn.Conv2d(embed_channels[-1], out_channels, 3,
                                  padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class ControlNet(UNetEncoder):
    """``forward(sample [B, 4, h, w], timesteps, context [B, L, C],
    cond_image [B, 3, H, W] in [0, 1], conditioning_scale) ->
    (down residuals, one per UNet skip, mid residual)``, NCHW in the model
    dtype.  ``cond_embed`` (:meth:`embed_hint` of the same image) takes
    the hint's place, so a loop embeds its fixed hint once."""

    def __init__(self, cfg: ControlNetConfig):
        super().__init__(cfg.unet, unet=False)
        ucfg = cfg.unet
        self.controlnet_cond_embedding = ConditioningEmbedding(
            cfg.conditioning_channels, ucfg.block_out_channels[0],
            cfg.conditioning_embed_channels)
        self.controlnet_down_blocks = nn.ModuleList(
            nn.Conv2d(c, c, 1) for c in self.skip_channels)
        mid = ucfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid, mid, 1)

    def embed_hint(self, cond_image: torch.Tensor) -> torch.Tensor:
        return self.controlnet_cond_embedding(cond_image.to(self.dtype))

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor,
                cond_image: Optional[torch.Tensor] = None,
                conditioning_scale=1.0, *,
                cond_embed: Optional[torch.Tensor] = None):
        if (cond_image is None) == (cond_embed is None):
            raise ValueError("ControlNet: pass cond_image or cond_embed")
        dtype = self.dtype
        h = sample.to(dtype).contiguous()
        temb = self.embed_time(timesteps, h.shape[0])
        if cond_embed is None:
            cond_embed = self.embed_hint(cond_image)
        attend = attender(context.to(dtype))
        h, skips = self.encode(h, temb, attend, cond_hint=cond_embed)
        h = self.middle(h, temb, attend)
        scale = conditioning_scale
        if not isinstance(scale, torch.Tensor):
            # the scale in the model dtype, as the JAX package casts it; a
            # Python number multiplies without a copy to the device
            scale = float(torch.tensor(scale, dtype=dtype, device="cpu"))
        down = tuple(conv(s) * scale
                     for conv, s in zip(self.controlnet_down_blocks, skips))
        return down, self.controlnet_mid_block(h) * scale
