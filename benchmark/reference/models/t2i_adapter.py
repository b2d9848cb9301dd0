"""T2I-Adapter: the SDXL turn's structure conditioning.

Port of ``theatergen_tpu/models/t2i_adapter.py``: the hint (the collage's
lineart, ``[B, 3, H, W]`` in [0, 1]) is pixel-unshuffled to the latent
grid, then each UNet level gets a 3×3 conv stem and residual blocks (an
average pool between levels), and the adapter returns one NCHW feature
map per level.  ``UNet2DCondition.forward(..., level_residuals=...)`` adds
feature i to the hidden state at the end of level i of its encoder.

The JAX package sizes the adapter to its own UNet's levels, not to
diffusers' ``FullAdapterXL`` layout (its module docstring says why), so
the parameter names here are the JAX package's scopes with indices:
``in_conv.{i}``, ``body.{i}.{j}.block1`` / ``block2``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import UNetConfig


def pixel_unshuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """``[B, C, H, W]`` → ``[B, C·f², H/f, W/f]`` in the JAX package's
    channel order: the f×f block flattened as (row, column, channel), so
    output channel ``fy·f·C + fx·C + c`` holds ``x[c, y·f + fy, x·f +
    fx]``.  ``F.pixel_unshuffle`` orders them ``c·f² + fy·f + fx``."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // factor, factor, w // factor, factor)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * factor * factor, h // factor, w // factor)


class AdapterResBlock(nn.Module):
    """``x + conv(relu(conv(x)))``, both 3×3 at ``ch`` channels."""

    def __init__(self, ch: int):
        super().__init__()
        self.block1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.block2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.block2(F.relu(self.block1(x)))


class T2IAdapter(nn.Module):
    """hint ``[B, 3, H, W]`` → one feature ``[B, C_i, h_i, w_i]`` per UNet
    level ``i``, at the latent grid (``H / downscale``) halved per level,
    in the UNet's dtype (the hint is cast to it first)."""

    def __init__(self, unet: UNetConfig, num_res_blocks: int = 2,
                 downscale: int = 8):
        super().__init__()
        self.downscale = downscale
        self.in_conv = nn.ModuleList()
        self.body = nn.ModuleList()
        cin = 3 * downscale * downscale
        for ch in unet.block_out_channels:
            self.in_conv.append(nn.Conv2d(cin, ch, 3, padding=1))
            self.body.append(nn.ModuleList(
                AdapterResBlock(ch) for _ in range(num_res_blocks)))
            cin = ch

    def forward(self, hint: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dtype = self.in_conv[0].weight.dtype
        x = pixel_unshuffle(hint.to(dtype), self.downscale)
        feats = []
        for i, (conv, blocks) in enumerate(zip(self.in_conv, self.body)):
            if i > 0:
                x = F.avg_pool2d(x, 2)
            x = conv(x)
            for blk in blocks:
                x = blk(x)
            feats.append(x)
        return tuple(feats)


def tile_features(feats: Tuple[torch.Tensor, ...], batch: int
                  ) -> Tuple[torch.Tensor, ...]:
    """Adapter features repeated along the batch to a UNet batch of
    ``batch`` rows (the CFG pair, or a cond-only batch), as the JAX
    runners concatenate ``[f] * (batch // len(f))``."""
    reps = batch // feats[0].shape[0]
    return tuple(f.repeat(reps, 1, 1, 1) if reps > 1 else f for f in feats)
