"""Model bundle: UNet, VAE, text tower(s) and tokenizer in one object.

Port of ``theatergen_tpu/pipelines/bundle.py`` for the txt2img slices
(SD1.5; SDXL adds the second text tower ``text2``).
:func:`init_bundle` builds the modules on the target device with seeded
random weights (no checkpoint ships with the repo); :meth:`Bundle.load_flax`
loads the JAX package's parameter trees through ``models/weights.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config import TheaterConfig
from ..models.clip import CLIPTextEncoder
from ..models.layers import get_dtype
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..models.weights import from_flax
from ..utils.tokenizer import load_tokenizer


@dataclasses.dataclass
class Bundle:
    """Everything the pipelines need; the modules hold their weights."""

    cfg: TheaterConfig
    tokenizer: Any
    unet: UNet2DCondition
    vae: AutoencoderKL
    text: CLIPTextEncoder
    # SDXL's second tower (OpenCLIP bigG), built where cfg.text2 is set
    text2: Optional[CLIPTextEncoder] = None

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @torch.no_grad()
    def text_embed(self, input_ids) -> torch.Tensor:
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                              device=self.device)
        return self.text(ids)[0]

    @torch.no_grad()
    def load_flax(self, *, unet: Optional[Mapping] = None,
                  vae: Optional[Mapping] = None,
                  text: Optional[Mapping] = None,
                  text2: Optional[Mapping] = None) -> "Bundle":
        """Load JAX-package param trees (nested dicts of arrays); every key
        must match (``load_state_dict(strict=True)``)."""
        for kind, module, tree in (("unet", self.unet, unet),
                                   ("vae", self.vae, vae),
                                   ("text", self.text, text),
                                   ("text", self.text2, text2)):
            if tree is None:
                continue
            if module is None:
                raise ValueError("load_flax: text2 given, but the bundle's "
                                 "config has no second text tower")
            ref = module.state_dict()
            sd = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
                      dtype=ref[k].dtype if k in ref else torch.float32,
                      device=self.device)
                  for k, v in from_flax(kind, tree).items()}
            module.load_state_dict(sd, strict=True)
        return self


def _seeded_init(module: nn.Module, gen: torch.Generator) -> None:
    """Fill every parameter from ``gen``: Linear/Conv weights N(0, 1/fan_in)
    (lecun normal, as flax's default), embeddings N(0, 0.02²), norm scales
    one, biases zero."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


def _build(cls, cfg, dtype: torch.dtype, device: torch.device,
           gen: torch.Generator) -> nn.Module:
    with torch.device("meta"):
        module = cls(cfg)
    module = module.to(dtype=dtype).to_empty(device=device)
    with torch.no_grad():
        _seeded_init(module, gen)
    return module.eval().requires_grad_(False)


def init_bundle(cfg: TheaterConfig, seed: int = 0, *,
                device="cuda", tokenizer_assets: Optional[str] = None
                ) -> Bundle:
    """Random-weight bundle built directly on ``device`` (default the card;
    there is no fallback to the CPU: pass ``device="cpu"`` to ask for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_bundle: no CUDA device; pass device='cpu' "
                           "to build the bundle on the CPU")
    gen = torch.Generator(device=device).manual_seed(seed)
    return Bundle(
        cfg=cfg,
        tokenizer=load_tokenizer(tokenizer_assets, cfg.text.vocab_size),
        unet=_build(UNet2DCondition, cfg.unet, get_dtype(cfg.unet.dtype),
                    device, gen),
        vae=_build(AutoencoderKL, cfg.vae, get_dtype(cfg.vae.dtype),
                   device, gen),
        text=_build(CLIPTextEncoder, cfg.text, get_dtype(cfg.text.dtype),
                    device, gen),
        text2=(None if cfg.text2 is None else _build(
            CLIPTextEncoder, cfg.text2, get_dtype(cfg.text2.dtype), device,
            gen)),
    )
