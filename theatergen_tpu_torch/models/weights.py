"""Checkpoints and weight bridges of the port: published checkpoints →
the port's modules, and the JAX package's parameter trees → the port's
state dicts.

**Files.** :func:`load_safetensors` reads the safetensors format from its
header (an 8-byte little-endian header size, a JSON header, one flat byte
buffer) through a copy-on-write memory map: each tensor is a view of the
mapped file until it is moved to its device.  F64, F32, F16, BF16 and the
integer and bool dtypes, in both directions.  :func:`save_safetensors`
writes the same format (the header padded with spaces to 8 bytes, tensors
ordered by element size, then name, so each one is aligned), which the
``safetensors`` package reads too.  :func:`load_torch_bin` reads a torch
pickle (``weights_only``) and flattens nested dicts into dotted names.

**Published names → the port** (``port_*``, the JAX package's
``models/weights.py`` rule for rule).  Each takes the flat state dict of a
published checkpoint and returns the entries that the JAX map consumes, in
the port's parameter names, with the tensors as read; what the JAX map
ignores (CLIP's ``position_ids``, SAM's mask tower, ...) is dropped.  The
port's modules carry diffusers' and transformers' names, so most rules are
identity.  The others: ``proj_in``/``proj_out`` as a Linear (SDXL files)
are reshaped to the port's 1×1 convolution; the VAE's 2022-era attention
names ``query``/``key``/``value``/``proj_attn`` become ``to_q``/``to_k``/
``to_v``/``to_out.0``; the ``text_model.``/``vision_model.`` prefixes go;
the IP UNet's ``attn2.processor.to_k_ip`` loses its ``processor``; the
IP-Adapter file's ``ip_adapter`` group is indexed in diffusers' processor
order (down blocks, up blocks, mid block last:
:func:`cross_attention_paths`), and its ``image_proj`` group takes the
projectors' names (``proj.0`` → ``proj_0``, ``layers.0.0.to_kv`` →
``layers.0.attn.to_kv``, ...); the lineart annotator's ``sk_model.pth``
Sequential indices name the layers of the port's ``LineartGenerator``,
whose ConvTranspose weights keep torch's layout; GroundingDINO's file
loses its buffers and tied box-head copies and nothing else, OWL-ViT's
its contrastive ``owlvit.logit_scale`` (:func:`port_owl`), pytorch_fid's
InceptionV3 its classifier, auxiliary head and ``num_batches_tracked``
(:func:`port_inception`).  :func:`load_bundle`
assembles a bundle from a directory of such files, each module loaded
with ``strict=True``.

**The JAX package's trees → the port.**  ``from_flax(kind, params)``
takes a flax tree (nested dicts of arrays) of the JAX package's UNet
(SDXL's ``add_embedding``, the IP UNet's ``attn2.to_k_ip``/``to_v_ip`` and
a GLIGEN tree's ``fuser`` subtrees with their scalar ``alpha_attn``/
``alpha_dense`` included), GLIGEN's ``PositionNet`` (``position_net``),
ControlNet, VAE, text tower (either of SDXL's two,
``text_projection`` included), CLIP vision tower, IP-Adapter projector
(``image_proj``, ``mlp_proj``, ``resampler``), T2I-Adapter
(``t2i_adapter``), segmenter (``sam_lite``, ``sam_hf``) or lineart
generator (``lineart``: ``LineartGenerator`` or ``LineartNet``),
GroundingDINO (``gdino``: transformers' names, :data:`_GDINO_SCOPES`),
OWL-ViT (``owl``: transformers' names) or the FID InceptionV3
(``inception``: torchvision's names) and returns the port's state dict as
numpy arrays.  It is written from the two
packages' naming rules:

- scopes: ``down_blocks_0_resnets_1`` → ``down_blocks.0.resnets.1``,
  ``mid_block_attentions_0`` (UNet) and ``mid_attentions_0`` (VAE) →
  ``mid_block.attentions.0``, ``transformer_blocks_0`` →
  ``transformer_blocks.0``, ``to_out_0`` → ``to_out.0``, ``net_0`` →
  ``net.0``, ``layers_3`` (CLIP) → ``encoder.layers.3``,
  ``layers_0_attn`` (Resampler) → ``layers.0.attn``,
  ``controlnet_down_blocks_3`` → ``controlnet_down_blocks.3``,
  ``linears_2`` (``PositionNet``) → ``linears.2``, ``blocks_5``
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
  ``scale`` stays ``scale``, as ``models.layers.QuantLinear`` names them;
- the segmenters and the lineart generators (``_PERCEPTION_RULES``): the
  JAX scopes ``layers_0``, ``blocks_0``, ``res_0`` ... become indices, the
  ``SamHF`` tree takes transformers' nesting (``patch_embed.projection``,
  ``neck.conv1``, ``mask_decoder.transformer.layers.0``,
  ``output_hypernetworks_mlps.0``, ``shared_image_embedding``) and its
  point embeddings one ``nn.Embedding(1, D)`` each; a ConvTranspose kernel,
  stored flipped for ``lax`` (the JAX package's ``convt_kernel``), is
  flipped back to torch's ``[in, out, kh, kw]``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..perception.sam_hf import SamHF, SamHFConfig, tiny_sam_hf_config

KINDS = ("unet", "controlnet", "vae", "text", "vision", "image_proj",
         "mlp_proj", "resampler", "t2i_adapter", "sam_lite", "sam_hf",
         "lineart", "gdino", "owl", "inception", "position_net")

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
    (re.compile(r"linears_(\d+)"), r"linears.\1"),
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
    if kind in _PERCEPTION_RULES:
        return _from_flax_perception(kind, params)
    if kind == "gdino":
        return _from_flax_gdino(params)
    if kind == "owl":
        return _from_flax_owl(params)
    if kind == "inception":
        return _from_flax_inception(params)
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


# ------------------------------------------- segmenters and lineart (flax)

# per kind: (scope-path substitutions, applied in order to the "/"-joined
# scopes; the ConvTranspose modules, by port name)
_PERCEPTION_RULES = {
    "sam_lite": ((
        (r"layers_(\d+)", r"layers/\1"),
        (r"blocks_(\d+)", r"blocks/\1"),
    ), ("decoder.upscale_1", "decoder.upscale_2")),
    "sam_hf": ((
        (r"^vision_encoder/patch_embed$", "vision_encoder/patch_embed/"
         "projection"),
        (r"^vision_encoder/neck_conv(\d)$", r"vision_encoder/neck/conv\1"),
        (r"^vision_encoder/neck_ln(\d)$",
         r"vision_encoder/neck/layer_norm\1"),
        (r"mlp_lin(\d)", r"mlp/lin\1"),
        (r"layers_(\d+)", r"layers/\1"),
        (r"^mask_decoder/(layers|final_attn_token_to_image|"
         r"layer_norm_final_attn)", r"mask_decoder/transformer/\1"),
        (r"hyper_mlps_(\d+)", r"output_hypernetworks_mlps/\1"),
        (r"^prompt_encoder/shared_embedding$", "shared_image_embedding"),
    ), ("mask_decoder.upscale_conv1", "mask_decoder.upscale_conv2")),
    # LineartGenerator's ConvTransposes are its root-level
    # up{1,2}_{kernel,bias} leaves (LineartNet's up{1,2} are convolutions)
    "lineart": ((
        (r"res_(\d+)", r"res/\1"),
    ), ()),
}


def convt_weight(kernel: np.ndarray) -> np.ndarray:
    """A flax ConvTranspose kernel ``[kh, kw, in, out]``, spatially flipped
    (``lax.conv_transpose`` cross-correlates the dilated input) → torch's
    ``ConvTranspose2d`` weight ``[in, out, kh, kw]``."""
    return np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))


def _from_flax_perception(kind: str, params: Mapping
                          ) -> Dict[str, np.ndarray]:
    subs, convt = _PERCEPTION_RULES[kind]
    out = {}
    for path, w in _flatten(params).items():
        scopes, leaf = "/".join(path[:-1]), path[-1]
        m = re.fullmatch(r"(up\d)_(kernel|bias)", leaf)
        root_convt = kind == "lineart" and not scopes and m
        if root_convt:
            scopes, leaf = m.groups()
        for rx, repl in subs:
            scopes = re.sub(rx, repl, scopes)
        module = scopes.replace("/", ".")
        if kind == "sam_hf" and leaf == "point_embed":
            for i, row in enumerate(w):
                out[f"prompt_encoder.point_embed.{i}.weight"] = row[None]
            continue
        if kind == "sam_hf" and leaf in ("not_a_point_embed",
                                         "no_mask_embed"):
            out[f"{module}.{leaf}.weight"] = w[None]
            continue
        if kind == "sam_hf" and leaf in ("iou_token", "mask_tokens"):
            out[f"{module}.{leaf}.weight"] = w
            continue
        if leaf == "kernel" and (root_convt or module in convt):
            leaf, w = "weight", convt_weight(w)
        else:
            leaf, w = _leaf(leaf, w, quantized=False)
        out[f"{module}.{leaf}" if module else leaf] = w
    return out


# the JAX GroundingDINO's scopes ("/"-joined) → the port's module names:
# the first rule that matches, its "/" then made "."
_SWIN = "model.backbone.conv_encoder.model"
_BERT = "model.text_backbone"
_BLOCK = r"^backbone/stage_(\d+)_block_(\d+)"
_GDINO_SCOPES = (
    (r"^text_backbone/(word|position|token_type)_embeddings$",
     rf"{_BERT}.embeddings.\1_embeddings"),
    (r"^text_backbone/embeddings_norm$", f"{_BERT}.embeddings.LayerNorm"),
    (r"^text_backbone/layers_(\d+)/self/", rf"{_BERT}.encoder.layer.\1"
     r".attention.self."),
    (r"^text_backbone/layers_(\d+)/attention_output$",
     rf"{_BERT}.encoder.layer.\1.attention.output.dense"),
    (r"^text_backbone/layers_(\d+)/attention_norm$",
     rf"{_BERT}.encoder.layer.\1.attention.output.LayerNorm"),
    (r"^text_backbone/layers_(\d+)/(intermediate|output)$",
     rf"{_BERT}.encoder.layer.\1.\2.dense"),
    (r"^text_backbone/layers_(\d+)/output_norm$",
     rf"{_BERT}.encoder.layer.\1.output.LayerNorm"),
    (r"^backbone/patch_embed$",
     f"{_SWIN}.embeddings.patch_embeddings.projection"),
    (r"^backbone/embed_norm$", f"{_SWIN}.embeddings.norm"),
    (r"^backbone/out_norm_(\d+)$", rf"{_SWIN}.hidden_states_norms.stage\1"),
    (r"^backbone/downsample_(\d+)/", rf"{_SWIN}.encoder.layers.\1"
     r".downsample."),
    (rf"{_BLOCK}/attention/output$",
     rf"{_SWIN}.encoder.layers.\1.blocks.\2.attention.output.dense"),
    (rf"{_BLOCK}/attention(?=/|$)",
     rf"{_SWIN}.encoder.layers.\1.blocks.\2.attention.self"),
    (rf"{_BLOCK}/(intermediate|output)$",
     rf"{_SWIN}.encoder.layers.\1.blocks.\2.\3.dense"),
    (rf"{_BLOCK}/", rf"{_SWIN}.encoder.layers.\1.blocks.\2."),
    (r"^input_proj_(\d+)_conv$", r"model.input_proj_vision.\1.0"),
    (r"^input_proj_(\d+)_norm$", r"model.input_proj_vision.\1.1"),
    (r"^bbox_embed/layers_(\d+)$", r"bbox_embed.0.layers.\1"),
    (r"^reference_points_head/layers_(\d+)$",
     r"model.decoder.reference_points_head.layers.\1"),
    (r"^decoder_layer_norm$", "model.decoder.layer_norm"),
    (r"^(encoder|decoder)_layers_(\d+)/", r"model.\1.layers.\2."),
    (r"^", "model."),
)


def _from_flax_gdino(params: Mapping) -> Dict[str, np.ndarray]:
    """The port's ``GroundingDinoForDetection`` state dict of a JAX
    ``GroundingDinoForDetection`` tree (:data:`_GDINO_SCOPES`; MLP heads'
    ``layers_{k}`` become ``layers.{k}``, the learned query embedding an
    ``nn.Embedding``)."""
    out = {}
    for path, w in _flatten(params).items():
        scopes, leaf = "/".join(path[:-1]), path[-1]
        if not scopes and leaf == "query_position_embeddings":
            out["model.query_position_embeddings.weight"] = w
            continue
        for rx, repl in _GDINO_SCOPES:
            if re.search(rx, scopes):
                scopes = re.sub(rx, repl, scopes, count=1)
                break
        module = re.sub(r"layers_(\d+)$", r"layers.\1", scopes).replace(
            "/", ".").rstrip(".")
        name, w = _leaf(leaf, w, quantized=False)
        out[f"{module}.{name}"] = w
    return out


def _from_flax_owl(params: Mapping) -> Dict[str, np.ndarray]:
    """The port's ``OwlDetector`` state dict (transformers' names) of a JAX
    ``OwlDetector`` tree: its ``text`` and ``vision`` towers through the
    CLIP rules, under ``owlvit.text_model``/``owlvit.vision_model``, their
    projections beside them and the vision pre-norm spelt
    ``pre_layernorm``; the heads' Dense layers and ``layer_norm`` by the
    leaf rules."""
    out = {}
    for k, w in from_flax("text", params["text"]).items():
        out[f"owlvit.{k}" if k == "text_projection.weight"
            else f"owlvit.text_model.{k}"] = w
    for k, w in from_flax("vision", params["vision"]).items():
        out[f"owlvit.{k}" if k == "visual_projection.weight" else
            "owlvit.vision_model." + k.replace("pre_layrnorm.",
                                               "pre_layernorm.")] = w
    for path, w in _flatten({k: v for k, v in params.items()
                             if k not in ("text", "vision")}).items():
        name, w = _leaf(path[-1], w, quantized=False)
        out[".".join(path[:-1] + (name,))] = w
    return out


def _from_flax_inception(params: Mapping) -> Dict[str, np.ndarray]:
    """The port's ``InceptionV3Features`` state dict (torchvision's names)
    of a JAX ``InceptionV3Features`` tree: each ``BasicConv2d``'s
    ``conv/kernel`` and its ``bn_{scale,bias,mean,var}`` leaves become
    ``conv.weight`` and ``bn.{weight,bias,running_mean,running_var}``."""
    bn = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean": "running_mean",
          "bn_var": "running_var"}
    out = {}
    for path, w in _flatten(params).items():
        module, leaf = ".".join(path[:-1]), path[-1]
        if leaf in bn:
            out[f"{module}.bn.{bn[leaf]}"] = w
        else:
            name, w = _leaf(leaf, w, quantized=False)
            out[f"{module}.{name}"] = w
    return out


# ------------------------------------------------------------------ files

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a safetensors file, CPU tensors that view a
    copy-on-write memory map of it (a tensor whose offset is not a
    multiple of its element size, as files with an unpadded header have,
    is copied)."""
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    n = int.from_bytes(mm[:8].tobytes(), "little")
    header = json.loads(mm[8:8 + n].tobytes())
    base = 8 + n
    raw = torch.from_numpy(mm)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        t = raw[base + start:base + end]
        if (base + start) % t.new_empty((), dtype=dtype).element_size():
            t = t.clone()
        out[name] = t.view(dtype).reshape(meta["shape"])
    return out


def save_safetensors(path: str, tensors: Mapping) -> None:
    """Write ``tensors`` (torch tensors on any device, or numpy arrays) as
    a safetensors file."""
    items = []
    for name, v in tensors.items():
        t = (torch.from_numpy(np.ascontiguousarray(v))
             if isinstance(v, np.ndarray) else v)
        items.append((name, t.detach()))
    items.sort(key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    offset = 0
    for name, t in items:
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    hdr = json.dumps(header, separators=(",", ":")).encode()
    hdr += b" " * (-len(hdr) % 8)
    with open(path, "wb") as f:
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for _, t in items:
            f.write(t.cpu().contiguous().reshape(-1).view(torch.uint8)
                    .numpy().data)


def load_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    """A torch pickle (``.bin``/``.pth``) read with ``weights_only``, nested
    dicts flattened into dotted names, dtypes kept."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    flat: Dict[str, torch.Tensor] = {}

    def walk(prefix, obj):
        if isinstance(obj, Mapping):
            for k, v in obj.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        else:
            flat[prefix] = obj

    walk("", sd)
    return flat


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return load_torch_bin(path)


# ------------------------------------------- published names → the port

def _port(sd: Mapping, rules: Sequence, strip: str = ""
          ) -> Dict[str, torch.Tensor]:
    """The entries of ``sd`` (``strip`` removed from each name) that match
    one of ``rules`` — ``(regex, replacement)`` — under their new names:
    the name itself where the replacement is None, else the match expanded
    by a template or passed to a function."""
    out = {}
    for name, w in sd.items():
        key = name.replace(strip, "") if strip else name
        for rx, repl in rules:
            m = re.fullmatch(rx, key)
            if m:
                out[key if repl is None else repl(m) if callable(repl)
                    else m.expand(repl)] = w
                break
    return out


_WB = r"(?:weight|bias)"
_RESNET = rf"(?:norm[12]|conv[12]|time_emb_proj|conv_shortcut)\.{_WB}"
_TRANSFORMER = (
    rf"(?:norm\.{_WB}|proj_(?:in|out)\.{_WB}|transformer_blocks\.\d+\."
    rf"(?:attn\d\.(?:to_[qkv]\.weight|to_out\.0\.{_WB})"
    rf"|ff\.net\.(?:0\.proj|2)\.{_WB}|norm\d\.{_WB}))")
_ATTENTIONS = r"(?:(?:down|up)_blocks\.\d+\.attentions|mid_block\.attentions)"
_UNET_RULES = (
    (rf"conv_in\.{_WB}", None),
    (rf"(?:time|add)_embedding\.linear_\d\.{_WB}", None),
    (rf"conv_norm_out\.{_WB}", None),
    (rf"conv_out\.{_WB}", None),
    (rf"(?:(?:down|up)_blocks|mid_block)\.(?:\d+\.)?resnets\.\d+\.{_RESNET}",
     None),
    (rf"(?:down|up)_blocks\.\d+\.(?:down|up)samplers\.\d+\.conv\.{_WB}",
     None),
    (rf"{_ATTENTIONS}\.\d+\.{_TRANSFORMER}", None),
    (rf"({_ATTENTIONS}\.\d+\.transformer_blocks\.\d+\.attn\d)\.processor\."
     r"(to_[kv]_ip\.weight)", r"\1.\2"),
)


def _proj_as_conv(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``proj_in``/``proj_out`` weights saved as a Linear ``[out, in]``
    (SDXL) → the 1×1 convolution ``[out, in, 1, 1]`` of the port."""
    for k, w in sd.items():
        if re.search(r"\.proj_(?:in|out)\.weight$", k) and w.ndim == 2:
            sd[k] = w[:, :, None, None]
    return sd


def port_unet(sd: Mapping) -> Dict[str, torch.Tensor]:
    """diffusers ``UNet2DConditionModel`` → ``UNet2DCondition`` (the IP
    UNet's ``attn2.processor.to_{k,v}_ip`` included)."""
    return _proj_as_conv(_port(sd, _UNET_RULES))


def port_controlnet(sd: Mapping) -> Dict[str, torch.Tensor]:
    """diffusers ``ControlNetModel`` → ``ControlNet``: the UNet's encoder
    rules, the zero convolutions and the hint embedding."""
    return _proj_as_conv(_port(sd, _UNET_RULES + (
        (rf"controlnet_down_blocks\.\d+\.{_WB}", None),
        (rf"controlnet_mid_block\.{_WB}", None),
        (rf"controlnet_cond_embedding\.(?:conv_in|conv_out|blocks\.\d+)\."
         rf"{_WB}", None),
    )))


_VAE_LEGACY = {"query": "to_q", "key": "to_k", "value": "to_v",
               "proj_attn": "to_out.0"}


def port_vae(sd: Mapping) -> Dict[str, torch.Tensor]:
    """diffusers ``AutoencoderKL`` → ``AutoencoderKL``; the deprecated
    AttentionBlock names of 2022-era files (sd-vae-ft-mse) renamed as
    diffusers renames them at load."""
    side = r"(?:encoder|decoder)"
    return _port(sd, (
        (rf"{side}\.(?:conv_in|conv_norm_out|conv_out)\.{_WB}", None),
        (rf"{side}\.(?:(?:down|up)_blocks\.\d+|mid_block)\.resnets\.\d+\."
         rf"{_RESNET}", None),
        (rf"{side}\.(?:down|up)_blocks\.\d+\.(?:down|up)samplers\.\d+\.conv"
         rf"\.{_WB}", None),
        (rf"{side}\.mid_block\.attentions\.\d+\.(?:group_norm|to_[qkv]|"
         rf"to_out\.0)\.{_WB}", None),
        (rf"({side}\.mid_block\.attentions\.\d+)\.(query|key|value|"
         rf"proj_attn)\.({_WB})",
         lambda m: f"{m[1]}.{_VAE_LEGACY[m[2]]}.{m[3]}"),
        (rf"(?:post_)?quant_conv\.{_WB}", None),
    ))


_CLIP_LAYERS = (rf"encoder\.layers\.\d+\.(?:self_attn\.(?:q|k|v|out)_proj|"
                rf"layer_norm\d|mlp\.fc\d)\.{_WB}")


def port_clip_text(sd: Mapping) -> Dict[str, torch.Tensor]:
    """HF ``CLIPTextModel`` / ``CLIPTextModelWithProjection`` →
    ``CLIPTextEncoder``."""
    return _port(sd, (
        (r"embeddings\.(?:token|position)_embedding\.weight", None),
        (_CLIP_LAYERS, None),
        (rf"final_layer_norm\.{_WB}", None),
        (r"text_projection\.weight", None),
    ), strip="text_model.")


def port_clip_vision(sd: Mapping) -> Dict[str, torch.Tensor]:
    """HF ``CLIPVisionModelWithProjection`` → ``CLIPVisionEncoder``."""
    return _port(sd, (
        (r"embeddings\.(?:class_embedding|patch_embedding\.weight|"
         r"position_embedding\.weight)", None),
        (rf"(?:pre_layrnorm|post_layernorm)\.{_WB}", None),
        (r"visual_projection\.weight", None),
        (_CLIP_LAYERS, None),
    ), strip="vision_model.")


def port_image_proj(sd: Mapping) -> Dict[str, torch.Tensor]:
    """IP-Adapter ``image_proj`` group → ``ImageProjModel``."""
    return _port(sd, ((rf"(?:proj|norm)\.{_WB}", None),),
                 strip="image_proj.")


def port_mlp_proj(sd: Mapping) -> Dict[str, torch.Tensor]:
    """IP-Adapter-Full ``image_proj`` group (one Sequential: Linear,
    GELU, Linear, LayerNorm) → ``MLPProjModel``."""
    return _port(sd, (
        (rf"proj\.([02])\.({_WB})", r"proj_\1.\2"),
        (rf"proj\.3\.({_WB})", r"norm.\1"),
    ), strip="image_proj.")


def port_resampler(sd: Mapping) -> Dict[str, torch.Tensor]:
    """IP-Adapter-Plus ``image_proj`` group (the Perceiver Resampler) →
    ``Resampler``: ``latents [1, Q, D]`` → ``[Q, D]``; ``layers.{i}.0``
    (the attention) → ``layers.{i}.attn``; ``layers.{i}.1`` (LayerNorm,
    Linear, GELU, Linear) → ``ff_norm``, ``ff_1``, ``ff_2``."""
    out = _port(sd, (
        (r"latents", None),
        (rf"(?:proj_in|proj_out|norm_out)\.{_WB}", None),
        (rf"layers\.(\d+)\.0\.(norm[12]\.{_WB}|to_q\.weight|to_kv\.weight|"
         r"to_out\.weight)", r"layers.\1.attn.\2"),
        (rf"layers\.(\d+)\.1\.0\.({_WB})", r"layers.\1.ff_norm.\2"),
        (r"layers\.(\d+)\.1\.1\.weight", r"layers.\1.ff_1.weight"),
        (r"layers\.(\d+)\.1\.3\.weight", r"layers.\1.ff_2.weight"),
    ), strip="image_proj.")
    if "latents" in out:
        out["latents"] = out["latents"][0]
    return out


def cross_attention_paths(unet: nn.Module) -> list:
    """The module names of ``unet``'s IP cross-attentions (``attn2`` with
    ``to_k_ip``) in diffusers' attention-processor order, by which the
    ``ip_adapter`` group is indexed: down blocks, up blocks, then the mid
    block (``attn_processors`` walks the children in assignment order, and
    diffusers assigns ``up_blocks`` before ``mid_block``)."""
    group = {"down_blocks": 0, "up_blocks": 1, "mid_block": 2}
    names = [n for n, m in unet.named_modules()
             if n.endswith(".attn2") and hasattr(m, "to_k_ip")]
    return sorted(names, key=lambda n: (
        group[n.split(".")[0]], [int(p) for p in n.split(".") if
                                 p.isdigit()]))


def port_ip_adapter(ip_sd: Mapping, unet: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """The ``ip_adapter`` group (``{index}.to_{k,v}_ip.weight``, the
    indices in processor order) → ``to_k_ip``/``to_v_ip`` entries of the
    IP UNet ``unet``'s state dict."""
    by_idx: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, w in ip_sd.items():
        m = re.fullmatch(r"(\d+)\.(to_[kv]_ip)\.weight",
                         name.replace("ip_adapter.", ""))
        if m:
            by_idx.setdefault(int(m.group(1)), {})[m.group(2)] = w
    paths = cross_attention_paths(unet)
    if len(by_idx) != len(paths):
        raise ValueError(f"port_ip_adapter: {len(by_idx)} processor entries "
                         f"for {len(paths)} IP cross-attentions")
    return {f"{path}.{kv}.weight": w
            for idx, path in zip(sorted(by_idx), paths)
            for kv, w in by_idx[idx].items()}


_SAM_ATTN = rf"(?:q|k|v|out)_proj\.{_WB}"
_SAM_MLP = rf"(?:proj_in|proj_out|layers\.\d+)\.{_WB}"


def port_sam(sd: Mapping) -> Dict[str, torch.Tensor]:
    """transformers' ``SamModel`` → ``perception.sam_hf.SamHF`` (its
    names): the box-prompted path, without the prompt encoder's mask tower
    and the prompt encoder's copy of the tied positional embedding."""
    return _port(sd, (
        (rf"vision_encoder\.patch_embed\.projection\.{_WB}", None),
        (r"vision_encoder\.pos_embed", None),
        (r"vision_encoder\.neck\.conv\d\.weight", None),
        (rf"vision_encoder\.neck\.layer_norm\d\.{_WB}", None),
        (rf"vision_encoder\.layers\.\d+\.(?:layer_norm\d|attn\.(?:qkv|proj)|"
         rf"mlp\.lin\d)\.{_WB}", None),
        (r"vision_encoder\.layers\.\d+\.attn\.rel_pos_[hw]", None),
        (r"shared_image_embedding\.positional_embedding", None),
        (r"prompt_encoder\.(?:point_embed\.\d+|not_a_point_embed|"
         r"no_mask_embed)\.weight", None),
        (r"mask_decoder\.(?:iou_token|mask_tokens)\.weight", None),
        (rf"mask_decoder\.(?:upscale_conv\d|upscale_layer_norm)\.{_WB}",
         None),
        (rf"mask_decoder\.transformer\.layers\.\d+\.(?:(?:self_attn|"
         rf"cross_attn_token_to_image|cross_attn_image_to_token)\."
         rf"{_SAM_ATTN}|layer_norm\d\.{_WB}|mlp\.lin\d\.{_WB})", None),
        (rf"mask_decoder\.transformer\.(?:final_attn_token_to_image\."
         rf"{_SAM_ATTN}|layer_norm_final_attn\.{_WB})", None),
        (rf"mask_decoder\.(?:output_hypernetworks_mlps\.\d+|"
         rf"iou_prediction_head)\.{_SAM_MLP}", None),
    ))


def sam_hf_config_of(sd: Mapping) -> SamHFConfig:
    """The ``SamHF`` config whose parameters have the shapes of ``sd`` (a
    :func:`port_sam` state dict): sam-vit-base, as the JAX package's
    ``load_bundle`` builds whatever the config, or the tiny instance of the
    CPU tests.  The file's shapes choose, since they do not hold every
    width (the heads); a SAM of other shapes raises."""
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    for cfg in (SamHFConfig(), tiny_sam_hf_config()):
        with torch.device("meta"):
            ref = SamHF(cfg).state_dict()
        if shapes == {k: tuple(v.shape) for k, v in ref.items()}:
            return cfg
    raise ValueError("sam.safetensors: its shapes are neither sam-vit-base's "
                     "nor the tiny SamHF's")


def port_lineart(sd: Mapping) -> Dict[str, torch.Tensor]:
    """lllyasviel/Annotators ``sk_model.pth`` (controlnet_aux's lineart
    Generator) → ``ops.lineart.LineartGenerator``."""
    return _port(sd, (
        (rf"model0\.1\.({_WB})", r"stem.\1"),
        (rf"model1\.0\.({_WB})", r"down1.\1"),
        (rf"model1\.3\.({_WB})", r"down2.\1"),
        (rf"model2\.(\d+)\.conv_block\.1\.({_WB})", r"res.\1.conv1.\2"),
        (rf"model2\.(\d+)\.conv_block\.5\.({_WB})", r"res.\1.conv2.\2"),
        (rf"model3\.0\.({_WB})", r"up1.\1"),
        (rf"model3\.3\.({_WB})", r"up2.\1"),
        (rf"model4\.1\.({_WB})", r"head.\1"),
    ))


# published GroundingDINO entries the port has no module for: the buffers,
# and the decoder's and the output's copies of the one box head, which
# transformers ties to ``bbox_embed.0`` (the JAX map skips the same)
_GDINO_DROPPED = (r".*\.(?:relative_position_index|position_ids)",
                  r"bbox_embed\.[1-9]\d*\..*", r"model\.decoder\.bbox_embed\..*")


def port_grounding_dino(sd: Mapping) -> Dict[str, torch.Tensor]:
    """transformers' ``GroundingDinoForObjectDetection`` →
    ``perception.gdino.GroundingDinoForDetection`` (transformers' names):
    every entry but the buffers and the tied box-head copies (
    :data:`_GDINO_DROPPED`).  Nothing else is skipped: an entry the module
    lacks fails its ``strict=True`` load, where the JAX map would drop
    it."""
    return {k: v for k, v in sd.items()
            if not any(re.fullmatch(rx, k) for rx in _GDINO_DROPPED)}


# published OWL-ViT entries the detector does not use: the contrastive
# logit scale, and the position-id buffers older files carry
_OWL_DROPPED = (r"owlvit\.logit_scale", r".*\.position_ids")


def port_owl(sd: Mapping) -> Dict[str, torch.Tensor]:
    """transformers' ``OwlViTForObjectDetection`` →
    ``perception.owl.OwlDetector`` (transformers' names): every entry but
    :data:`_OWL_DROPPED`, to be loaded ``strict=True``."""
    return {k: v for k, v in sd.items()
            if not any(re.fullmatch(rx, k) for rx in _OWL_DROPPED)}


def owl_config_of(sd: Mapping):
    """The ``OwlConfig`` whose detector has the shapes of ``sd`` (a
    :func:`port_owl` state dict): owlvit-base-patch32, as the JAX
    package's ``load_bundle`` builds whatever the file, or the tiny
    detector of the CPU tests; other shapes raise."""
    from ..perception.owl import (OwlDetector, owlvit_base_patch32,
                                  tiny_owl_config)

    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    for cfg in (owlvit_base_patch32(), tiny_owl_config()):
        with torch.device("meta"):
            ref = OwlDetector(cfg).state_dict()
        if shapes == {k: tuple(v.shape) for k, v in ref.items()}:
            return cfg
    raise ValueError("owl.safetensors: its shapes are neither "
                     "owlvit-base-patch32's nor the tiny detector's")


def port_inception(sd: Mapping) -> Dict[str, torch.Tensor]:
    """pytorch_fid's / torchvision's ``inception_v3`` →
    ``eval.inception.InceptionV3Features`` (the same names): without the
    classifier (``fc``), the auxiliary head (``AuxLogits``) and the
    BatchNorms' ``num_batches_tracked``."""
    return {k: v for k, v in sd.items()
            if k.split(".")[0] not in ("fc", "AuxLogits")
            and not k.endswith(".num_batches_tracked")}


def gdino_config_of(sd: Mapping):
    """The ``GroundingDinoConfig`` whose detector has the shapes of ``sd``
    (a :func:`port_grounding_dino` state dict): grounding-dino-tiny, as
    the JAX package's ``load_bundle`` builds whatever the file, or the tiny
    instance of the CPU tests; other shapes raise."""
    from ..perception.gdino import (GroundingDinoConfig,
                                    GroundingDinoForDetection,
                                    tiny_gdino_config)

    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    for cfg in (GroundingDinoConfig(), tiny_gdino_config()):
        with torch.device("meta"):
            ref = GroundingDinoForDetection(cfg).state_dict()
        if shapes == {k: tuple(v.shape) for k, v in ref.items()}:
            return cfg
    raise ValueError("gdino.safetensors: its shapes are neither "
                     "grounding-dino-tiny's nor the tiny detector's")


def load_into(module: nn.Module, sd: Mapping, *, partial: bool = False
              ) -> nn.Module:
    """Load a port state dict into ``module``, each tensor cast to the
    dtype and device of the entry it replaces, ``strict=True``; with
    ``partial`` the entries ``sd`` lacks keep their values (every key of
    ``sd`` must still be the module's)."""
    ref = module.state_dict()
    unknown = sorted(set(sd) - set(ref))
    if unknown:
        raise KeyError(f"{type(module).__name__} has no {unknown[:5]} "
                       f"({len(unknown)} entries)")
    full = dict(ref) if partial else {}
    full.update({k: torch.as_tensor(v).to(device=ref[k].device,
                                          dtype=ref[k].dtype)
                 for k, v in sd.items()})
    module.load_state_dict(full, strict=True)
    return module


# ------------------------------------------------------------ load_bundle

# IP-Adapter checkpoint stems per variant (SD1.5 and SDXL files share the
# group format)
IP_FILES = {
    "base": ("ip-adapter_sd15", "ip-adapter_sdxl"),
    "plus": ("ip-adapter-plus_sd15", "ip-adapter-plus_sdxl_vit-h"),
    "full": ("ip-adapter-full-face_sd15",),
}
EXPECTED = ("unet", "vae", "text", "controlnet", "vision", "ip_adapter")


def load_bundle(cfg, weights_dir: str, *, ip_variant: Optional[str] = None,
                device="cuda"):
    """A bundle assembled from a directory of published checkpoints:
    ``unet.safetensors`` (into ``unet`` and ``unet_ip``, whose
    ``to_k_ip``/``to_v_ip`` keep their init until the IP file loads),
    ``vae.safetensors``, ``text_encoder.safetensors``,
    ``text_encoder_2.safetensors`` (SDXL), ``controlnet.safetensors``,
    ``image_encoder.safetensors``, the IP-Adapter file of the variant
    (``.bin`` or ``.safetensors``), ``sam.safetensors`` (a ``SamHF`` of
    the file's shapes: :func:`sam_hf_config_of`), ``lineart.safetensors`` (a
    ``LineartGenerator``), ``gdino.safetensors`` and tokenizer assets
    (``merges.txt``, ``vocab.json``).  The rest of the bundle is ``init_bundle(cfg, 0,
    with_ip=True, with_controlnet=True, with_vision=True)``, as in the JAX
    package (so SDXL gets a ControlNet and no T2I-Adapter); a part whose
    file is missing keeps those random weights, with a warning.

    ``ip_variant``: "base", "plus" or "full"; by default "plus" where only
    a plus file is present, else "base".  ``gdino.safetensors`` with
    ``gdino_vocab.txt`` (BERT's vocabulary) becomes the bundle's detector, a
    ``GroundingDinoBackend`` in fp32 (grounding-dino-tiny, or the tiny
    detector whose shapes the file has: :func:`gdino_config_of`), and
    ``"gdino"`` joins the loaded parts; without the vocabulary the file is
    not loaded, as in the JAX package, with a warning.
    ``owl.safetensors`` becomes the detector where no GroundingDINO loaded,
    or over it under ``THEATERGEN_DETECTOR=owl`` (JAX
    ``weights.py:1252-1274``): an ``OwlBackend`` in fp32
    (owlvit-base-patch32, or the tiny detector whose shapes the file has:
    :func:`owl_config_of`) with the bundle's CLIP tokenizer
    (``load_tokenizer(weights_dir)``; without BPE assets the hash
    tokenizer over the detector's vocabulary, so the tiny detector's ids
    stay in range), and ``"owl"`` joins the loaded parts.  Runs on the card unless ``device`` names another device."""
    from ..pipelines.bundle import build_lineart, build_sam, init_bundle

    gdino_path = os.path.join(weights_dir, "gdino.safetensors")
    vocab_path = os.path.join(weights_dir, "gdino_vocab.txt")
    with_gdino = os.path.exists(gdino_path) and os.path.exists(vocab_path)
    if getattr(cfg.unet, "quantized", False):
        raise NotImplementedError(
            "load_bundle: a published float UNet into a W8A8 UNet is not "
            "supported")

    def have(variant):
        return any(os.path.exists(os.path.join(weights_dir, stem + ext))
                   for stem in IP_FILES[variant]
                   for ext in (".bin", ".safetensors"))

    if ip_variant is None:
        ip_variant = "plus" if have("plus") and not have("base") else "base"
    bundle = init_bundle(cfg, 0, device=device, with_ip=True,
                         with_controlnet=True, with_vision=True,
                         tokenizer_assets=weights_dir, ip_variant=ip_variant)

    def maybe(name):
        p = os.path.join(weights_dir, name)
        return load_state_dict(p) if os.path.exists(p) else None

    loaded = []
    for fname, field, port in (
            ("unet.safetensors", "unet", port_unet),
            ("vae.safetensors", "vae", port_vae),
            ("text_encoder.safetensors", "text", port_clip_text),
            ("text_encoder_2.safetensors", "text2", port_clip_text),
            ("controlnet.safetensors", "controlnet", port_controlnet),
            ("image_encoder.safetensors", "vision", port_clip_vision)):
        module = getattr(bundle, field)
        sd = maybe(fname) if module is not None else None
        if not sd:
            continue
        ported = port(sd)
        load_into(module, ported)
        if field == "unet" and bundle.unet_ip is not None:
            load_into(bundle.unet_ip, ported, partial=True)
        loaded.append(field)
    dev = bundle.device
    sd = maybe("sam.safetensors")
    if sd:
        ported = port_sam(sd)
        bundle.sam = load_into(build_sam(cfg, dev,
                                         hf_cfg=sam_hf_config_of(ported)),
                               ported)
        loaded.append("sam")
    sd = maybe("lineart.safetensors")
    if sd:
        bundle.lineart = load_into(build_lineart(dev), port_lineart(sd))
        loaded.append("lineart")
    if with_gdino:
        sd = port_grounding_dino(load_state_dict(gdino_path))
        if sd:
            from ..perception.gdino import (GroundingDinoBackend,
                                            WordPieceTokenizer)

            bundle.detector = GroundingDinoBackend(
                gdino_config_of(sd), sd, WordPieceTokenizer(vocab_path),
                device=dev)
            loaded.append("gdino")
    elif os.path.exists(gdino_path):
        print("[load_bundle] WARNING: gdino.safetensors without "
              "gdino_vocab.txt is not loaded; the turn detects from the "
              "attention maps")
    sd = maybe("owl.safetensors")
    if sd and (bundle.detector is None
               or os.environ.get("THEATERGEN_DETECTOR") == "owl"):
        from ..perception.owl import OwlBackend
        from ..utils.tokenizer import load_tokenizer

        sd = port_owl(sd)
        cfg_owl = owl_config_of(sd)
        bundle.detector = OwlBackend(
            cfg_owl, sd, load_tokenizer(weights_dir, cfg_owl.text.vocab_size),
            max_length=cfg_owl.text.max_length, device=dev)
        loaded.append("owl")
    ip = None
    for stem in IP_FILES[bundle.ip_variant]:
        ip = maybe(stem + ".bin") or maybe(stem + ".safetensors")
        if ip:
            break
    if ip:
        port_proj = {"base": port_image_proj, "plus": port_resampler,
                     "full": port_mlp_proj}[bundle.ip_variant]
        load_into(bundle.image_proj, port_proj(
            {k: v for k, v in ip.items() if k.startswith("image_proj")}))
        load_into(bundle.unet_ip, port_ip_adapter(
            {k: v for k, v in ip.items() if k.startswith("ip_adapter")},
            bundle.unet_ip), partial=True)
        loaded.append("ip_adapter")
    missing = [e for e in EXPECTED if e not in loaded]
    if missing:
        print(f"[load_bundle] WARNING: no checkpoints for {missing} — "
              "those components keep RANDOM weights")
    return bundle
