"""The port's modules written as published checkpoint files: the inverse
of ``models/weights.py``'s ``port_*`` maps (GroundingDINO's file and its
vocabulary, or OWL-ViT's file, where the bundle carries that detector).

:func:`published_state_dicts` gives the state dicts, in the published
names, of the files :func:`models.weights.load_bundle` reads, and
:func:`export_checkpoint_dir` writes them into a directory.  The tests and
``chip_smoke.py`` make their synthetic checkpoint directories with it; the
parity tests hold each file it writes against the JAX package's
``port_*`` maps and ``load_bundle``, so a wrong inverse rule shows there.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Sequence

import torch

from ..perception.gdino import GroundingDinoBackend
from ..perception.owl import OwlBackend
from ..perception.sam_hf import SamHF
from .weights import (IP_FILES, _VAE_LEGACY, cross_attention_paths,
                      save_safetensors)


def _published(sd: Mapping, rules: Sequence, dtype=None
               ) -> Dict[str, torch.Tensor]:
    """``sd`` renamed by ``rules`` (``(regex, template)``, the first match
    applies; no match keeps the name), cast to ``dtype`` where given."""
    out = {}
    for k, v in sd.items():
        for rx, repl in rules:
            m = re.fullmatch(rx, k)
            if m:
                k = m.expand(repl)
                break
        out[k] = v if dtype is None else v.to(dtype)
    return out


def published_state_dicts(bundle) -> Dict[str, Dict[str, torch.Tensor]]:
    """The files :func:`load_bundle` reads, as state dicts in the published
    names, from ``bundle``'s modules: the inverse of the ``port_*`` maps.
    The diffusers and transformers towers, the ControlNet and the
    IP-Adapter file in fp16, as most SD1.5 files ship, the VAE with the
    2022-era attention names of sd-vae-ft-mse; SAM and the annotator in
    their modules' fp32, as sam-vit-base and ``sk_model.pth`` ship.  Keyed
    by file name; the IP-Adapter file is the nested dict ``torch.save``
    writes."""
    dtype = torch.float16
    linear = bundle.cfg.unet.addition_embed_type == "text_time"

    def unet_like(module):
        sd = {k: v for k, v in module.state_dict().items()
              if not re.search(r"\.to_[kv]_ip\.", k)}
        for k, v in sd.items():
            if linear and re.search(r"\.proj_(?:in|out)\.weight$", k):
                sd[k] = v[:, :, 0, 0]     # SDXL files: Linear projections
        return {k: v.to(dtype) for k, v in sd.items()}

    out = {"unet.safetensors": unet_like(bundle.unet)}
    out["vae.safetensors"] = _published(bundle.vae.state_dict(), tuple(
        (rf"(.*\.mid_block\.attentions\.\d+)\.{re.escape(new)}\.(\w+)",
         rf"\1.{old}.\2") for old, new in _VAE_LEGACY.items()), dtype)
    for fname, field in (("text_encoder.safetensors", "text"),
                         ("text_encoder_2.safetensors", "text2")):
        module = getattr(bundle, field)
        if module is not None:
            out[fname] = _published(module.state_dict(), (
                (r"(text_projection\.weight)", r"\1"),
                (r"(.*)", r"text_model.\1")), dtype)
    if bundle.controlnet is not None:
        out["controlnet.safetensors"] = unet_like(bundle.controlnet)
    if bundle.vision is not None:
        out["image_encoder.safetensors"] = _published(
            bundle.vision.state_dict(), (
                (r"(visual_projection\.weight)", r"\1"),
                (r"(.*)", r"vision_model.\1")), dtype)
    if bundle.unet_ip is not None:
        proj = _published(bundle.image_proj.state_dict(), {
            "base": (),
            "full": ((r"proj_([02])\.(\w+)", r"proj.\1.\2"),
                     (r"norm\.(\w+)", r"proj.3.\1")),
            "plus": ((r"layers\.(\d+)\.attn\.(.*)", r"layers.\1.0.\2"),
                     (r"layers\.(\d+)\.ff_norm\.(\w+)", r"layers.\1.1.0.\2"),
                     (r"layers\.(\d+)\.ff_1\.weight", r"layers.\1.1.1.weight"),
                     (r"layers\.(\d+)\.ff_2\.weight",
                      r"layers.\1.1.3.weight")),
        }[bundle.ip_variant], dtype)
        if "latents" in proj:
            proj["latents"] = proj["latents"][None]
        ip_sd = bundle.unet_ip.state_dict()
        groups = {f"{2 * pos + 1}.{kv}.weight":
                  ip_sd[f"{path}.{kv}.weight"].to(dtype)
                  for pos, path in enumerate(cross_attention_paths(
                      bundle.unet_ip)) for kv in ("to_k_ip", "to_v_ip")}
        stem = IP_FILES[bundle.ip_variant][0]
        out[stem + ".bin"] = {"image_proj": proj, "ip_adapter": groups}
    if isinstance(bundle.sam, SamHF):
        sd = dict(bundle.sam.state_dict())
        # SamModel's state dict also holds the prompt encoder's tied copy
        sd["prompt_encoder.shared_embedding.positional_embedding"] = sd[
            "shared_image_embedding.positional_embedding"]
        out["sam.safetensors"] = sd
    if bundle.lineart is not None:
        out["lineart.safetensors"] = _published(
            bundle.lineart.state_dict(), (
                (r"stem\.(\w+)", r"model0.1.\1"),
                (r"down1\.(\w+)", r"model1.0.\1"),
                (r"down2\.(\w+)", r"model1.3.\1"),
                (r"res\.(\d+)\.conv1\.(\w+)", r"model2.\1.conv_block.1.\2"),
                (r"res\.(\d+)\.conv2\.(\w+)", r"model2.\1.conv_block.5.\2"),
                (r"up1\.(\w+)", r"model3.0.\1"),
                (r"up2\.(\w+)", r"model3.3.\1"),
                (r"head\.(\w+)", r"model4.1.\1")))
    if isinstance(bundle.detector, GroundingDinoBackend):
        out["gdino.safetensors"] = gdino_published(bundle.detector.model)
    if isinstance(bundle.detector, OwlBackend):
        out["owl.safetensors"] = owl_published(bundle.detector.model)
    return out


def owl_published(model) -> Dict[str, torch.Tensor]:
    """An ``OwlDetector``'s state dict as transformers'
    ``OwlViTForObjectDetection`` holds it: its names, plus the contrastive
    ``owlvit.logit_scale`` (CLIP's initial value, log(1/0.07)), which
    ``port_owl`` drops."""
    sd = dict(model.state_dict())
    sd["owlvit.logit_scale"] = torch.tensor(2.6592)
    return sd


def gdino_published(model) -> Dict[str, torch.Tensor]:
    """A ``GroundingDinoForDetection``'s state dict as transformers'
    ``GroundingDinoForObjectDetection`` holds it (fp32): its names, plus
    the box head's tied copies (``bbox_embed.{i}`` and
    ``model.decoder.bbox_embed.{i}`` for every decoder layer) and each
    Swin block's ``relative_position_index`` buffer, which
    ``port_grounding_dino`` drops."""
    from ..perception.swin import _rel_pos_index

    sd = dict(model.state_dict())
    head = {k: v for k, v in sd.items() if k.startswith("bbox_embed.0.")}
    for i in range(model.cfg.decoder_layers):
        for k, v in head.items():
            rest = k[len("bbox_embed.0."):]
            sd[f"bbox_embed.{i}.{rest}"] = v
            sd[f"model.decoder.bbox_embed.{i}.{rest}"] = v
    index = torch.from_numpy(_rel_pos_index(model.cfg.swin.window_size))
    for k in list(sd):
        if k.endswith(".relative_position_bias_table"):
            sd[k.replace("_bias_table", "_index")] = index
    return sd


def export_checkpoint_dir(bundle, out_dir: str) -> Dict[str, int]:
    """Write :func:`published_state_dicts` of ``bundle`` into ``out_dir``
    (safetensors files, the IP-Adapter file by ``torch.save``): a
    directory :func:`load_bundle` reads.  Returns the bytes of each
    file."""
    os.makedirs(out_dir, exist_ok=True)
    sizes = {}
    for fname, sd in published_state_dicts(bundle).items():
        path = os.path.join(out_dir, fname)
        if fname.endswith(".bin"):
            torch.save({g: {k: v.cpu() for k, v in d.items()}
                        for g, d in sd.items()}, path)
        else:
            save_safetensors(path, sd)
        sizes[fname] = os.path.getsize(path)
    if isinstance(bundle.detector, GroundingDinoBackend):
        # BERT's vocabulary, one token a line in id order
        path = os.path.join(out_dir, "gdino_vocab.txt")
        vocab = bundle.detector.tokenizer.vocab
        with open(path, "w", encoding="utf-8") as f:
            f.write("".join(t + "\n" for t in sorted(vocab, key=vocab.get)))
        sizes["gdino_vocab.txt"] = os.path.getsize(path)
    return sizes
