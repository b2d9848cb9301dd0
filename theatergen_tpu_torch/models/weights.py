"""Weight bridge from the JAX package's parameter trees to the port's
state dicts.

``from_flax(kind, params)`` takes a flax tree (nested dicts of arrays) of
the JAX package's UNet (SDXL's ``add_embedding`` and the IP UNet's
``attn2.to_k_ip``/``to_v_ip`` included), ControlNet, VAE, text tower (either of
SDXL's two, ``text_projection`` included), CLIP vision tower, IP-Adapter
projector (``image_proj``, ``mlp_proj``, ``resampler``) or T2I-Adapter
(``t2i_adapter``) and returns the
port's state dict as numpy arrays.  It is written from the two packages'
naming rules:

- scopes: ``down_blocks_0_resnets_1`` → ``down_blocks.0.resnets.1``,
  ``mid_block_attentions_0`` (UNet) and ``mid_attentions_0`` (VAE) →
  ``mid_block.attentions.0``, ``transformer_blocks_0`` →
  ``transformer_blocks.0``, ``to_out_0`` → ``to_out.0``, ``net_0`` →
  ``net.0``, ``layers_3`` (CLIP) → ``encoder.layers.3``,
  ``layers_0_attn`` (Resampler) → ``layers.0.attn``,
  ``controlnet_down_blocks_3`` → ``controlnet_down_blocks.3``, ``blocks_5``
  (the ControlNet's hint embedding) → ``blocks.5``, ``in_conv_2`` and
  ``body_2_1`` (the T2I-Adapter) → ``in_conv.2`` and ``body.2.1``; the
  UNet's and the ControlNet's ``encoder``/``mid`` wrapper scopes vanish,
  the VAE's ``post_quant_conv`` and ``quant_conv`` move out of its
  decoder/encoder, the JAX GroupNorm
  wrapper's inner ``norm`` scope is dropped, and the vision tower's
  ``patch_embedding``, ``class_embedding`` and ``position_embedding`` move
  into ``embeddings``;
- leaves: a 4-D ``kernel`` is HWIO → OIHW, a 2-D ``kernel`` is
  [in, out] → [out, in]; ``scale`` and ``embedding`` become ``weight``.
  In a W8A8 subtree of ``quantize_params`` (``{kernel_q, scale, bias}``)
  the int8 ``kernel_q`` [in, out] becomes ``weight`` [out, in] and
  ``scale`` stays ``scale``, as ``models.layers.QuantLinear`` names them.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np

KINDS = ("unet", "controlnet", "vae", "text", "vision", "image_proj",
         "mlp_proj", "resampler", "t2i_adapter")

_SCOPE_RULES = (
    (re.compile(r"(down_blocks|up_blocks)_(\d+)_"
                r"(resnets|attentions|downsamplers|upsamplers)_(\d+)"),
     r"\1.\2.\3.\4"),
    (re.compile(r"(?:mid_block|mid)_(resnets|attentions)_(\d+)"),
     r"mid_block.\1.\2"),
    (re.compile(r"transformer_blocks_(\d+)"), r"transformer_blocks.\1"),
    (re.compile(r"(to_out|net)_(\d+)"), r"\1.\2"),
    (re.compile(r"layers_(\d+)"), r"encoder.layers.\1"),
    (re.compile(r"layers_(\d+)_(attn|ff_norm|ff_1|ff_2)"), r"layers.\1.\2"),
    (re.compile(r"token_embedding"), r"embeddings.token_embedding"),
    (re.compile(r"(blocks|controlnet_down_blocks|in_conv)_(\d+)"),
     r"\1.\2"),
    (re.compile(r"body_(\d+)_(\d+)"), r"body.\1.\2"),
)


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _scope(name: str) -> str:
    for rx, repl in _SCOPE_RULES:
        if rx.fullmatch(name):
            return rx.sub(repl, name)
    return name


def _leaf(name: str, w: np.ndarray, quantized: bool):
    if name in ("kernel", "kernel_q"):
        if w.ndim == 4:
            return "weight", np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        return "weight", np.ascontiguousarray(w.T)
    if name == "embedding" or (name == "scale" and not quantized):
        return "weight", w
    return name, w


def from_flax(kind: str, params: Mapping) -> Dict[str, np.ndarray]:
    """Port state dict (numpy) of a JAX ``kind`` tree (one of KINDS)."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if "params" in params and len(params) == 1:
        params = params["params"]
    flat = _flatten(params)
    # scopes of W8A8 subtrees, whose scale is not a norm's
    quant_scopes = {path[:-1] for path in flat if path[-1] == "kernel_q"}
    out = {}
    for path, w in flat.items():
        scopes, leaf = list(path[:-1]), path[-1]
        if len(scopes) >= 2 and scopes[-1] == "norm" and leaf in (
                "scale", "bias"):
            scopes.pop()          # the GroupNorm wrapper's inner nn.GroupNorm
        if (kind in ("unet", "controlnet") and scopes
                and scopes[0] in ("encoder", "mid")):
            scopes.pop(0)
        if kind == "vae" and scopes[-1:] in (["post_quant_conv"],
                                             ["quant_conv"]):
            scopes = scopes[-1:]
        if (kind in ("text", "vision") and leaf == "position_embedding"
                and not scopes):
            out["embeddings.position_embedding.weight"] = w
            continue
        if kind == "vision" and leaf == "class_embedding" and not scopes:
            out["embeddings.class_embedding"] = w
            continue
        if kind == "vision" and scopes == ["patch_embedding"]:
            scopes = ["embeddings", "patch_embedding"]
        name, value = _leaf(leaf, w, path[:-1] in quant_scopes)
        out[".".join([_scope(s) for s in scopes] + [name])] = value
    return out
