"""Lineart for the ControlNet hint, the port of
``theatergen_tpu/ops/lineart.py``.

Two backends, both white lines on black, as ControlNet-lineart expects:

- :func:`dog_lineart`, the weightless extended difference-of-Gaussians
  sketch of a bundle without an annotator;
- :class:`LineartGenerator`, the checkpoint-faithful annotator
  (lllyasviel/Annotators ``sk_model.pth``, the reference's
  ``LineartDetector``), loaded from ``lineart.safetensors`` by
  ``models/weights.py::port_lineart``.  Its ConvTranspose weights keep
  torch's ``[in, out, kh, kw]`` layout.  :class:`LineartNet` is the JAX
  package's residual generator of the same shape, without a checkpoint.

The modules take and return NHWC images ``[B, H, W, 3]`` in [0, 1] and run
NCHW inside, in fp32, on cuDNN's deterministic algorithms: with the
others a hint differed in its last bits from one call to the next on an
H100, and through the ControlNet so did the turn's image.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
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


@contextlib.contextmanager
def _deterministic_convolutions():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine parameters: each sample's channels
    normalised over the spatial axes (NCHW), population variance."""
    mean = x.mean((2, 3), keepdim=True)
    var = (x - mean).square().mean((2, 3), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def _reflect(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


def _lines(logits: torch.Tensor) -> torch.Tensor:
    """``[B, 1, H, W]`` logits of dark lines → white lines on black,
    ``[B, H, W, 3]`` (the reference's ``255 - map``)."""
    lines = 1.0 - torch.sigmoid(logits)
    return lines.permute(0, 2, 3, 1).expand(-1, -1, -1, 3).contiguous()


class LineartResidualBlock(nn.Module):
    """Reflect-padded conv → instance norm → ReLU → reflect-padded conv →
    instance norm, plus the input."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3)
        self.conv2 = nn.Conv2d(ch, ch, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(instance_norm(self.conv1(_reflect(x, 1))))
        return x + instance_norm(self.conv2(_reflect(h, 1)))


class LineartGenerator(nn.Module):
    """The annotator's generator: reflect-padded 7×7 stem → two stride-2
    convolutions → ``n_res`` residual blocks → two ConvTranspose2d(3,
    stride 2, padding 1, output_padding 1) → reflect-padded 7×7 head, each
    but the head followed by instance norm and ReLU; the head's sigmoid is
    inverted to white lines on black.  ``sk_model.pth`` is base 64, 3
    blocks."""

    def __init__(self, base: int = 64, n_res: int = 3):
        super().__init__()
        self.base, self.n_res = base, n_res
        self.stem = nn.Conv2d(3, base, 7)
        self.down1 = nn.Conv2d(base, base * 2, 3, stride=2, padding=1)
        self.down2 = nn.Conv2d(base * 2, base * 4, 3, stride=2, padding=1)
        self.res = nn.ModuleList(LineartResidualBlock(base * 4)
                                 for _ in range(n_res))
        self.up1 = nn.ConvTranspose2d(base * 4, base * 2, 3, stride=2,
                                      padding=1, output_padding=1)
        self.up2 = nn.ConvTranspose2d(base * 2, base, 3, stride=2,
                                      padding=1, output_padding=1)
        self.head = nn.Conv2d(base, 1, 7)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        with _deterministic_convolutions():
            return self._forward(image.float().permute(0, 3, 1, 2))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(instance_norm(self.stem(_reflect(x, 3))))
        h = F.relu(instance_norm(self.down1(h)))
        h = F.relu(instance_norm(self.down2(h)))
        for block in self.res:
            h = block(h)
        h = F.relu(instance_norm(self.up1(h)))
        h = F.relu(instance_norm(self.up2(h)))
        return _lines(self.head(_reflect(h, 3)))


class ResBlock(nn.Module):
    """conv → GroupNorm(1) → ReLU → conv → GroupNorm(1), plus the input
    (flax's GroupNorm epsilon, 1e-6)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.norm1 = nn.GroupNorm(1, ch, eps=1e-6)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(1, ch, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.norm1(self.conv1(x)))
        return x + self.norm2(self.conv2(h))


class LineartNet(nn.Module):
    """Residual generator 3 → base → two stride-2 downs → ``n_res``
    :class:`ResBlock` → two nearest ×2 upsamples, each with a 3×3 conv →
    1, zero-padded, white lines on black."""

    def __init__(self, base: int = 64, n_res: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(3, base, 7, padding=3)
        self.down1 = nn.Conv2d(base, base * 2, 3, stride=2, padding=1)
        self.down2 = nn.Conv2d(base * 2, base * 4, 3, stride=2, padding=1)
        self.res = nn.ModuleList(ResBlock(base * 4) for _ in range(n_res))
        self.up1 = nn.Conv2d(base * 4, base * 2, 3, padding=1)
        self.up2 = nn.Conv2d(base * 2, base, 3, padding=1)
        self.conv_out = nn.Conv2d(base, 1, 7, padding=3)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        with _deterministic_convolutions():
            return self._forward(image.float().permute(0, 3, 1, 2))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv_in(x))
        h = F.relu(self.down1(h))
        h = F.relu(self.down2(h))
        for block in self.res:
            h = block(h)
        h = F.relu(self.up1(F.interpolate(h, scale_factor=2.0)))
        h = F.relu(self.up2(F.interpolate(h, scale_factor=2.0)))
        return _lines(self.conv_out(h))
