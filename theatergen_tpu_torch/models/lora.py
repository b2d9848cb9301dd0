"""LoRA merging: low-rank adapter deltas added into a UNet's weights.

The port of ``theatergen_tpu/models/lora.py``.  It merges an LCM-LoRA
(arXiv 2311.05556: 4-8 sampling steps in place of 50) or any style or
subject LoRA into the port's UNet, ``W' = W + scale · B·A``, so every
pipeline runs the merged weights unchanged.

Checkpoint conventions:

- **peft/diffusers** (e.g. latent-consistency/lcm-lora-sdv1-5):
  ``unet.{module}.lora_A.weight`` ``[r, in]`` and
  ``unet.{module}.lora_B.weight`` ``[out, r]`` under diffusers' dotted
  module names; a convolution's factors are 4-D (``A [r, in, kh, kw]``,
  ``B [out, r, 1, 1]``).
- **kohya / webui**: ``lora_unet_{module_with_underscores}.lora_down`` /
  ``.lora_up`` and a per-module ``.alpha`` (the delta scaled by ``alpha /
  rank``); the names are turned back into diffusers' dotted form.
  Text-encoder entries (``lora_te_*``, ``text_encoder.*``) are not part of
  the UNet merge and are skipped.

The port's UNet carries diffusers' module names already
(``models/unet.py``), so a LoRA module resolves by name; the one rename is
diffusers' IP-Adapter processor scope (``attn2.processor.to_k_ip`` →
``attn2.to_k_ip``).
"""

from __future__ import annotations

import copy
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

# kohya flattens diffusers module paths with underscores; undo the
# indexed-collection and leaf flattening
_KOHYA_INDEXED = re.compile(
    r"(down_blocks|up_blocks|attentions|resnets|transformer_blocks|"
    r"downsamplers|upsamplers)_(\d+)_")
_KOHYA_LEAVES = [
    ("mid_block_", "mid_block."),
    (re.compile(r"attn(\d)_"), r"attn\1."),
    ("to_out_0", "to_out.0"),
    ("ff_net_0_proj", "ff.net.0.proj"),
    ("ff_net_2", "ff.net.2"),
]


def kohya_module_to_diffusers(name: str) -> str:
    """``down_blocks_0_attentions_1_transformer_blocks_0_attn1_to_q`` →
    ``down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q``."""
    s = _KOHYA_INDEXED.sub(r"\1.\2.", name)
    for pat, rep in _KOHYA_LEAVES:
        s = s.replace(pat, rep) if isinstance(pat, str) else pat.sub(rep, s)
    return s


def extract_lora_pairs(sd: Mapping[str, np.ndarray]
                       ) -> Dict[str, Tuple[np.ndarray, np.ndarray, object]]:
    """State dict → ``{diffusers module name: (A, B, alpha or None)}``;
    modules missing either factor are dropped."""
    pairs: Dict[str, dict] = {}

    def entry(raw_module: str, kohya: bool) -> dict:
        module = kohya_module_to_diffusers(raw_module) if kohya \
            else raw_module
        return pairs.setdefault(module, {})

    for name, w in sd.items():
        if name.startswith(("lora_te", "text_encoder.")):
            continue
        kohya = name.startswith("lora_unet_")
        if kohya:
            name = name[len("lora_unet_"):]
        else:
            name = re.sub(r"^(unet|lora_unet)\.", "", name)
        m = re.fullmatch(r"(.+)\.(lora_A|lora_down)\.weight", name)
        if m:
            entry(m.group(1), kohya)["A"] = np.asarray(w, np.float32)
            continue
        m = re.fullmatch(r"(.+)\.(lora_B|lora_up)\.weight", name)
        if m:
            entry(m.group(1), kohya)["B"] = np.asarray(w, np.float32)
            continue
        m = re.fullmatch(r"(.+)\.alpha", name)
        if m:
            entry(m.group(1), kohya)["alpha"] = float(np.asarray(w))
    return {k: (v["A"], v["B"], v.get("alpha")) for k, v in pairs.items()
            if "A" in v and "B" in v}


def _delta(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The low-rank delta in PyTorch's weight layout: linear ``B @ A``
    ``[out, in]``; convolution ``A [r, in, kh, kw]`` × ``B [out, r, 1, 1]``
    → ``[out, in, kh, kw]``."""
    if a.ndim == 2 and b.ndim == 2:
        return b @ a
    if a.ndim == 4 and b.ndim == 4:
        if b.shape[2:] != (1, 1):
            raise ValueError(f"unsupported conv LoRA up-factor {b.shape}")
        return np.tensordot(b[:, :, 0, 0], a, axes=(1, 0))
    raise ValueError(f"unsupported LoRA factor ranks {a.shape} x {b.shape}")


def _port_module_name(module: str) -> str:
    return module.replace(".processor.", ".")


def _fit(delta: np.ndarray, weight: torch.Tensor, module: str) -> np.ndarray:
    """The delta in the weight's shape: equal, or a 1×1 convolution's
    ``[out, in, 1, 1]`` against a linear's ``[out, in]`` either way (the
    JAX package's ``proj_in``/``proj_out`` mapping)."""
    shape = tuple(weight.shape)
    if delta.shape == shape:
        return delta
    if (delta.ndim == 2 and len(shape) == 4 and shape[2:] == (1, 1)
            and delta.shape == shape[:2]):
        return delta[:, :, None, None]
    if (delta.ndim == 4 and delta.shape[2:] == (1, 1) and len(shape) == 2
            and delta.shape[:2] == shape):
        return delta[:, :, 0, 0]
    raise ValueError(f"LoRA module {module}: delta {delta.shape} does not "
                     f"fit the weight {shape}")


@torch.no_grad()
def apply_lora_unet(unet: nn.Module, lora_sd: Mapping[str, np.ndarray],
                    scale: float = 1.0) -> nn.Module:
    """A copy of ``unet`` with the LoRA deltas merged into its weights
    (``unet`` itself is left as it is).  A kohya ``alpha`` rescales its
    module's delta by ``alpha / rank``; ``scale`` multiplies every delta.
    The delta is formed in fp32 and rounded to the weight's dtype before
    the add, as in the JAX package.  A LoRA module that names no weight of
    the UNet raises (dropping it would fake-apply the adapter), and so does
    an int8 (W8A8) weight."""
    pairs = extract_lora_pairs(lora_sd)
    if not pairs:
        raise ValueError("no lora_A/lora_B pairs found in state dict")
    params = dict(unet.named_parameters())
    deltas = {}
    for module, (a, b, alpha) in pairs.items():
        name = f"{_port_module_name(module)}.weight"
        if name not in params:
            raise ValueError(f"unmapped LoRA module: {module}")
        weight = params[name]
        if not weight.is_floating_point():
            raise ValueError(f"LoRA module {module}: the weight is "
                             f"{weight.dtype}; merge into float weights")
        mscale = scale * (alpha / a.shape[0] if alpha is not None else 1.0)
        deltas[name] = _fit(_delta(a, b) * mscale, weight, module)
    merged = copy.deepcopy(unet)
    for name, param in merged.named_parameters():
        if name in deltas:
            param.add_(torch.from_numpy(deltas[name]).to(param.device,
                                                         param.dtype))
    return merged
