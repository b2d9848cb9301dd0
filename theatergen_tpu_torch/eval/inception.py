"""InceptionV3 pool3 features for FID, the reference's AFID feature space
(PyTorch), the port of ``theatergen_tpu/eval/inception.py``.

The reference computes crop-set FID with ``pytorch_fid``
(``CMIGBench/eval/eval.py:66-94``), whose InceptionV3 is torchvision's
``inception_v3`` with three FID patches (pytorch_fid ``inception.py``):

- InceptionA/C and Mixed_7b's branch pool use ``avg_pool2d(...,
  count_include_pad=False)``;
- Mixed_7c's branch pool is a **max** pool;
- the features are the 2048-d global-average "pool3" activations.

The modules run NCHW under torchvision's names (``Conv2d_1a_3x3.conv``,
``Mixed_5b.branch1x1.bn``, …), so ``models/weights.py::port_inception``
only drops ``fc``, ``AuxLogits`` and ``num_batches_tracked``.  The
BatchNorms are inference-only, eps 1e-3 as torchvision's ``BasicConv2d``.
The convolutions are cuDNN's (the JAX package leaves them to XLA, outside
any Pallas kernel), fp32 with TF32 off.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import geometry as G
from ..perception.gdino import _exact_fp32

class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm, eps 1e-3, without ``num_batches_tracked``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, 1e-3)


class BasicConv2d(nn.Module):
    """Convolution without bias, frozen BatchNorm, ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool3(x):
    """3×3 stride-1 average pool, ``count_include_pad=False`` (the
    pytorch_fid patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool3s2(x)], 1)


class InceptionE(nn.Module):
    """Mixed_7b pools with the patched average pool, Mixed_7c with a max
    pool (pytorch_fid's FIDInceptionE_1 and FIDInceptionE_2)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (_avg_pool3(x) if self.pool == "avg"
              else F.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """``[B, 3, H, W]`` in **[-1, 1]** → 2048-d pool3 features ``[B,
    2048]``.  Callers resize to 299² bilinear and scale ``2x - 1`` first
    (pytorch_fid's ``resize_input``/``normalize_input``)."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool3s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))       # adaptive average pool → [B, 2048]


class InceptionEmbedder:
    """FID feature extractor with the reference's preprocessing: each
    [0, 1] image resized to ``size``² by the port's ``resize_bilinear``
    (antialiased when it shrinks, as ``jax.image.resize``), scaled to [-1,
    1], pool3 features.  Runs on the card unless ``device`` names another
    device."""

    def __init__(self, weights, size: int = 299, *, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InceptionEmbedder: no CUDA device; pass "
                               "device='cpu' to run it on the CPU")
        with torch.device("meta"):
            model = InceptionV3Features()
        model.load_state_dict(
            {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
             for k, v in weights.items()}, strict=True, assign=True)
        self.model = model.eval().requires_grad_(False)
        self.size = size
        self.device = device

    @classmethod
    def from_weights_dir(cls, weights_dir: str, *, device="cuda"):
        """From ``fid_inception.safetensors`` (pytorch_fid's
        ``pt_inception-2015-12-05`` in torchvision's names)."""
        from ..models.weights import load_state_dict, port_inception

        return cls(port_inception(load_state_dict(os.path.join(
            weights_dir, "fid_inception.safetensors"))), device=device)

    @classmethod
    def random_init(cls, seed: int, size: int = 299, *, device="cuda"):
        """Seeded weights: each convolution N(0, 1/fan_in) from a generator
        on ``device`` seeded with ``seed``, the BatchNorms the identity (as
        the JAX package's init)."""
        from ..pipelines.bundle import build_module

        gen = torch.Generator(device=device).manual_seed(seed)
        model = build_module(InceptionV3Features, None, torch.float32,
                             device, None)
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, nn.Conv2d):
                    m.weight.normal_(0.0, m.weight[0].numel() ** -0.5,
                                     generator=gen)
                elif isinstance(m, FrozenBatchNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
        return cls(model.state_dict(), size, device=device)

    def embed_images(self, images: Sequence, batch_size: int = 50
                     ) -> np.ndarray:
        """``[N, 2048]`` features of ``[H, W, 3]`` images, in chunks of
        ``batch_size`` as ``pytorch_fid`` (one unchunked batch of 299²
        activations would not fit); where there is more than one chunk the
        last is padded to a full one, as the JAX package pads it."""
        outs = []
        for i in range(0, len(images), batch_size):
            chunk = [self._resize(im) for im in images[i:i + batch_size]]
            n = len(chunk)
            if n < batch_size and len(images) > batch_size:
                chunk = chunk + [chunk[-1]] * (batch_size - n)
            batch = torch.stack(chunk)
            with torch.no_grad(), _exact_fp32():
                feats = self.model(batch * 2.0 - 1.0)
            outs.append(feats[:n].cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _resize(self, image) -> torch.Tensor:
        x = torch.as_tensor(image, device=self.device).float()
        return G.resize_bilinear(x.permute(2, 0, 1), self.size, self.size)

