"""Lineart for the ControlNet hint: the weightless extended
difference-of-Gaussians sketch.

The port of ``theatergen_tpu/ops/lineart.py::{gaussian_kernel1d,
gaussian_blur, dog_lineart}``, the lineart of the default path (the
bundle's ``lineart`` annotator is None without a checkpoint).  The
checkpoint-bearing ``LineartNet``/``LineartGenerator`` come with
checkpoint loading.  White lines on black, as ControlNet-lineart expects.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_kernel1d(sigma: float, radius: int, device=None) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur (radius ``max(1, int(3·sigma))``, edges
    repeated) over the two spatial axes of an ``[H, W]`` or ``[H, W, C]``
    image, in fp32."""
    radius = max(1, int(3 * sigma))
    k = gaussian_kernel1d(sigma, radius, img.device)
    squeeze = img.ndim == 2
    x = img.float()
    if squeeze:
        x = x[..., None]
    c = x.shape[-1]
    x = x.permute(2, 0, 1)[None]                              # [1, C, H, W]
    x = F.pad(x, (0, 0, radius, radius), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    x = F.pad(x, (radius, radius, 0, 0), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    x = x[0].permute(1, 2, 0)
    return x[..., 0] if squeeze else x


def dog_lineart(image: torch.Tensor, sigma: float = 1.0, k: float = 1.6,
                tau: float = 0.98, phi: float = 200.0) -> torch.Tensor:
    """Extended difference-of-Gaussians sketch: ``[H, W, 3]`` in [0, 1] →
    lineart ``[H, W, 3]`` in [0, 1], white lines on black."""
    gray = image.float().mean(-1)
    d = gaussian_blur(gray, sigma) - tau * gaussian_blur(gray, sigma * k)
    edges = 1.0 - torch.tanh(torch.clamp(-d, min=0.0) * phi)
    lines = torch.clamp((1.0 - edges) * 2.5, 0.0, 1.0)
    return lines[..., None].expand(*lines.shape, 3).contiguous()
