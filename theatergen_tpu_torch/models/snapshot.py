"""Bundle snapshots, the port of ``theatergen_tpu/models/snapshot.py`` in
the port's own format: save an assembled bundle's modules once, reload them
directly on later starts::

    bundle = load_bundle(cfg, weights_dir)           # once: port_* maps
    save_bundle_snapshot(bundle, "/ckpt/snap")
    bundle = load_bundle_snapshot(cfg, "/ckpt/snap")  # every start

A snapshot directory holds ``modules/<field>.safetensors``, one per module
of the bundle (its state dict, in the module's dtypes), and then, written
last as the commit marker, ``bundle_meta.json``: the format, the module
fields, the IP-Adapter variant, and what rebuilds the segmenter and the
annotator (their kind and config, which ``cfg`` does not say: a bundle
loaded from ``sam.safetensors`` carries a ``SamHF`` whatever
``cfg.sam.backend`` is).  Loading builds the skeleton of ``cfg`` on the
meta device and assigns the saved tensors (``load_state_dict(assign=True)``
on the target device), so no random weights are drawn and nothing is held
twice; a module the cfg needs and the snapshot lacks fails loudly, and so
does a directory written by the JAX package (orbax).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import List, Optional

import torch

from ..perception.sam_hf import SamHF, SamHFConfig
from .weights import load_safetensors, save_safetensors

FORMAT = "theatergen_tpu_torch.bundle_snapshot.v1"
# every module field of a Bundle
MODULE_FIELDS = ("unet", "vae", "text", "text2", "unet_ip", "image_proj",
                 "vision", "controlnet", "t2i_adapter", "sam", "lineart")
_META = "bundle_meta.json"
_MODULES = "modules"


def save_bundle_snapshot(bundle, out_dir: str) -> List[str]:
    """Write every module of ``bundle`` under ``out_dir``; returns the saved
    fields.  Refuses to overwrite a snapshot; a ``modules`` directory
    without the meta file (a save cut short) is reclaimed."""
    fields = [f for f in MODULE_FIELDS if getattr(bundle, f) is not None]
    if not fields:
        raise ValueError("bundle has no modules to snapshot")
    out_dir = os.path.abspath(out_dir)
    meta_path = os.path.join(out_dir, _META)
    mod_dir = os.path.join(out_dir, _MODULES)
    if os.path.exists(meta_path):
        raise FileExistsError(f"snapshot exists: {out_dir}")
    if os.path.exists(mod_dir):
        shutil.rmtree(mod_dir)
    os.makedirs(mod_dir)
    for f in fields:
        save_safetensors(os.path.join(mod_dir, f + ".safetensors"),
                         getattr(bundle, f).state_dict())
    meta = {"format": FORMAT, "fields": fields,
            "ip_variant": bundle.ip_variant}
    if bundle.sam is not None:
        kind = "hf" if isinstance(bundle.sam, SamHF) else "lite"
        meta["sam"] = {"kind": kind,
                       "config": dataclasses.asdict(bundle.sam.cfg)}
    if bundle.lineart is not None:
        meta["lineart"] = {"base": bundle.lineart.base,
                           "n_res": bundle.lineart.n_res}
    tmp = meta_path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh, indent=1)
    os.replace(tmp, meta_path)
    return sorted(fields)


def load_bundle_snapshot(cfg, snap_dir: str, *,
                         tokenizer_assets: Optional[str] = None,
                         device="cuda"):
    """Rebuild a bundle from ``cfg`` and a :func:`save_bundle_snapshot`
    directory, on the card unless ``device`` names another device."""
    from ..pipelines.bundle import build_lineart, build_sam, init_bundle

    snap_dir = os.path.abspath(snap_dir)
    with open(os.path.join(snap_dir, _META)) as fh:
        meta = json.load(fh)
    if meta.get("format") != FORMAT:
        if (os.path.isdir(os.path.join(snap_dir, "params"))
                or any(str(f).endswith("_params")
                       for f in meta.get("fields", ()))):
            raise ValueError(
                f"{snap_dir} is a snapshot of the JAX package (orbax param "
                f"trees); the port reads only its own snapshots")
        raise ValueError(f"{snap_dir}: not a bundle snapshot of the port "
                         f"(format {meta.get('format')!r})")
    fields = meta["fields"]
    unknown = set(fields) - set(MODULE_FIELDS)
    if unknown:
        raise ValueError(f"snapshot has unknown fields: {sorted(unknown)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_bundle_snapshot: no CUDA device; pass "
                           "device='cpu' to load the bundle on the CPU")
    bundle = init_bundle(
        cfg, device="meta", tokenizer_assets=tokenizer_assets,
        with_ip="unet_ip" in fields, with_vision="vision" in fields,
        with_controlnet="controlnet" in fields,
        with_t2i_adapter="t2i_adapter" in fields,
        ip_variant=meta.get("ip_variant", "base"))
    if "sam" in meta:
        sam_cfg = meta["sam"]
        if sam_cfg["kind"] == "hf":
            hf = dict(sam_cfg["config"])
            hf["global_attn_indexes"] = tuple(hf["global_attn_indexes"])
            bundle.sam = build_sam(cfg, "meta", hf_cfg=SamHFConfig(**hf))
        else:
            bundle.sam = build_sam(dataclasses.replace(
                cfg, sam=dataclasses.replace(cfg.sam, **sam_cfg["config"])),
                "meta")
    if "lineart" in meta:
        bundle.lineart = build_lineart("meta", **meta["lineart"])
    for f in fields:
        module = getattr(bundle, f)
        if module is None:
            raise ValueError(f"snapshot {snap_dir} holds {f!r}, which this "
                             f"cfg does not build")
        sd = load_safetensors(os.path.join(snap_dir, _MODULES,
                                           f + ".safetensors"))
        ref = module.state_dict()
        for k, v in sd.items():
            if k in ref and (v.dtype != ref[k].dtype
                             or v.shape != ref[k].shape):
                raise ValueError(
                    f"snapshot {snap_dir}: {f}.{k} is {v.dtype} "
                    f"{tuple(v.shape)}, this cfg builds {ref[k].dtype} "
                    f"{tuple(ref[k].shape)}")
        module.load_state_dict({k: v.to(device) for k, v in sd.items()},
                               strict=True, assign=True)
    # nothing may stay on the meta device: a module the cfg builds and the
    # snapshot lacks would fail at its first use
    for f in MODULE_FIELDS:
        module = getattr(bundle, f)
        if module is not None and any(
                t.is_meta for t in (*module.parameters(), *module.buffers())):
            raise ValueError(
                f"snapshot {snap_dir} does not cover {f!r}, which this cfg "
                f"needs (saved fields: {sorted(fields)})")
    return bundle
