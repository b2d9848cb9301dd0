"""int8 W8A8 serving: the port's copy of ``theatergen_tpu/ops/quant.py``.

Static per-output-channel weight scales and dynamic activation scales,
with an exact int32 sum, in the layers the JAX package quantizes
(attention projections, the FF, the time embeddings: ``QUANT_DENSE_PATTERNS``
over the port's diffusers names).  ``models.layers.QuantLinear``, the
counterpart of ``QuantDense``, holds the int8 weights; ``make_linear``
builds it where a model is configured ``quantized``.

Two routes, chosen by ``THEATERGEN_FUSED_INT8`` with the JAX package's
name, values and default: ``"0"`` (the default) quantizes the activations
with one per-tensor scale and takes the int8 product outside any kernel of
the repo (:func:`per_tensor_linear`: ``torch._int_mm``, as the JAX package
leaves its ``dot_general(preferred_element_type=int32)`` to XLA); ``"1"``
runs ``ops.quant_matmul.quant_matmul`` (per-row scales inside the kernel).
It is read once, at import, into :data:`FUSED_MODE`, which tests and
scripts may set.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import torch

from . import quant_matmul as qm_ops

FUSED_MODE = os.environ.get("THEATERGEN_FUSED_INT8", "0")

# Linear layers worth quantizing inside the UNet (matmul-shaped, large K/N)
QUANT_DENSE_PATTERNS = [
    r"(^|.*\.)(to_q|to_k|to_v|to_k_ip|to_v_ip|to_out\.0)$",
    r"(^|.*\.)ff\.net\.0\.proj$",
    r"(^|.*\.)ff\.net\.2$",
    r"(^|.*\.)time_emb_proj$",
    r"(^|.*\.)time_embedding\.linear_[12]$",
]


def is_quant_path(name: str) -> bool:
    return any(re.match(p, name) for p in QUANT_DENSE_PATTERNS)


def quantize_linear_weight(weight: torch.Tensor):
    """A linear's fp ``[out, in]`` weight → (int8 ``[out, in]``, fp32 scale
    ``[out]``): the JAX package's ``quantize_weight`` on the transposed
    weight, in torch, on the weight's device."""
    w = weight.float()
    scale = torch.clamp_min(qm_ops.div127(w.abs().amax(dim=1)), 1e-8)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_state_dict(sd: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A float UNet's state dict → the quantized UNet's: every linear whose
    name matches :func:`is_quant_path` gets an int8 ``weight`` and an fp32
    ``scale`` (its bias unchanged); the counterpart of the JAX package's
    ``quantize_params``."""
    out = {}
    for key, val in sd.items():
        name = key.rsplit(".", 1)[0]
        if key.endswith(".weight") and val.ndim == 2 and is_quant_path(name):
            out[key], out[f"{name}.scale"] = quantize_linear_weight(val)
        else:
            out[key] = val
    return out


def int8_matmul(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 ``[M, K]`` @ int8 ``w_q [N, K]``^T → int32 ``[M, N]``.  On the
    card ``torch._int_mm`` needs M > 16: zero rows pad it and are cut off."""
    m = xq.shape[0]
    if xq.is_cuda and m <= 16:
        xq = torch.cat([xq, xq.new_zeros(17 - m, xq.shape[1])])
    return torch._int_mm(xq, w_q.t())[:m]


def per_tensor_linear(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor, bias=None, *,
                      amax: torch.Tensor = None) -> torch.Tensor:
    """The JAX ``QuantDense`` default route: one activation scale over the
    whole tensor (both CFG halves), ``max(max|x| / 127, 1e-8)``, the int8
    product, then ``y · (a_scale · scale) + bias`` in fp32 and one rounding
    to x's dtype.  ``amax`` (fp32, 0-dim) replaces ``max|x|``: a
    row-parallel layer's, taken over every rank's columns."""
    n, k = w_q.shape
    xf = x.reshape(-1, k).float()
    if amax is None:
        amax = xf.abs().amax()
    a_scale = torch.clamp_min(qm_ops.div127(amax), 1e-8)
    xq = torch.clamp(torch.round(xf / a_scale), -127, 127).to(torch.int8)
    y = int8_matmul(xq, w_q).float() * (a_scale * scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], n)
