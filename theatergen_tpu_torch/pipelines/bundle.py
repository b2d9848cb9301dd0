"""Model bundle: UNet, VAE, text tower(s) and tokenizer in one object.

Port of ``theatergen_tpu/pipelines/bundle.py`` for the txt2img slices
(SD1.5; SDXL adds the second text tower ``text2``), the IP-Adapter
character pass (``unet_ip``, ``image_proj`` and the CLIP vision tower), the
final pass (``controlnet``), the SDXL turn's structure conditioning
(``t2i_adapter``), the character masks' segmenter (``sam``) and the lineart
annotator (``lineart``).
:func:`init_bundle` builds the modules on the target device with seeded
random weights (no checkpoint ships with the repo);
``models/weights.py::load_bundle`` loads published checkpoints into them
and ``models/snapshot.py`` saves and reloads a whole bundle;
:meth:`Bundle.load_flax` loads the JAX package's parameter trees.  A
config with ``unet.quantized`` builds W8A8 UNets: their int8 weights are
the float bundle's of the same seed, quantized, and ``load_flax`` takes a
``quantize_params`` tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from ..config import TheaterConfig
from ..models.clip import CLIPTextEncoder, CLIPVisionEncoder
from ..models.controlnet import ControlNet
from ..models.ip_adapter import ImageProjModel, MLPProjModel, Resampler
from ..models.layers import QuantLinear, get_dtype
from ..models.t2i_adapter import T2IAdapter
from ..models.unet import UNet2DCondition
from ..models.vae import AutoencoderKL
from ..models.weights import from_flax
from ..ops.lineart import LineartGenerator
from ..perception.sam import SAMLite
from ..perception.sam_hf import SamHF, SamHFConfig, tiny_sam_hf_config
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
    # the IP-Adapter UNet: its own weights, with to_k_ip/to_v_ip
    unet_ip: Optional[UNet2DCondition] = None
    image_proj: Optional[nn.Module] = None  # ImageProj / MLPProj / Resampler
    ip_variant: str = "base"                # "base" | "plus" | "full"
    vision: Optional[CLIPVisionEncoder] = None
    controlnet: Optional[ControlNet] = None
    # the SDXL turn's final-pass conditioning, in place of the ControlNet
    t2i_adapter: Optional[T2IAdapter] = None
    # the character masks' segmenter (SAMLite or SamHF); None: the
    # attention fallback
    sam: Optional[nn.Module] = None
    # the lineart annotator (LineartGenerator); None: dog_lineart
    lineart: Optional[nn.Module] = None
    # the turn's open-vocabulary detector, from load_bundle:
    # perception.gdino's GroundingDinoBackend (a Detection) or
    # perception.owl's OwlBackend (a (box, confidence, ok) tuple); None:
    # attention detection
    detector: Any = None

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
                  text2: Optional[Mapping] = None,
                  unet_ip: Optional[Mapping] = None,
                  image_proj: Optional[Mapping] = None,
                  vision: Optional[Mapping] = None,
                  controlnet: Optional[Mapping] = None,
                  t2i_adapter: Optional[Mapping] = None,
                  sam: Optional[Mapping] = None,
                  lineart: Optional[Mapping] = None) -> "Bundle":
        """Load JAX-package param trees (nested dicts of arrays); every key
        must match (``load_state_dict(strict=True)``).  ``sam`` is the tree
        of the bundle's segmenter (``SAMLite`` or ``SamHF``), ``lineart``
        that of its annotator."""
        sam_kind = "sam_hf" if isinstance(self.sam, SamHF) else "sam_lite"
        for name, kind, tree in (
                ("unet", "unet", unet), ("vae", "vae", vae),
                ("text", "text", text), ("text2", "text", text2),
                ("unet_ip", "unet", unet_ip),
                ("image_proj", PROJ_KINDS[self.ip_variant], image_proj),
                ("vision", "vision", vision),
                ("controlnet", "controlnet", controlnet),
                ("t2i_adapter", "t2i_adapter", t2i_adapter),
                ("sam", sam_kind, sam), ("lineart", "lineart", lineart)):
            if tree is None:
                continue
            module = getattr(self, name)
            if module is None:
                raise ValueError(f"load_flax: {name} given, but the bundle "
                                 f"has no {name} (see init_bundle)")
            ref = module.state_dict()
            sd = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
                      dtype=ref[k].dtype if k in ref else torch.float32,
                      device=self.device)
                  for k, v in from_flax(kind, tree).items()}
            module.load_state_dict(sd, strict=True)
        return self


# from_flax kind of each IP-Adapter variant's projector
PROJ_KINDS = {"base": "image_proj", "full": "mlp_proj", "plus": "resampler"}


def _seeded_init(module: nn.Module, gen: torch.Generator,
                 dtype: torch.dtype) -> None:
    """Fill every parameter from ``gen``: Linear/Conv weights N(0, 1/fan_in)
    (lecun normal, as flax's default), embeddings N(0, 0.02²), norm scales
    one, biases zero; a module's own parameters (the vision tower's class
    embedding, the Resampler's queries) N(0, init_std²), init_std 0.02
    unless the module sets it.  A ``QuantLinear`` draws the ``dtype``
    weight of the ``nn.Linear`` it replaces, from the same place in the
    stream, and quantizes it: a quantized model's int8 weights are its
    float twin's quantized."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, QuantLinear):
            w = torch.empty(m.weight.shape, dtype=dtype,
                            device=m.weight.device)
            m.set_float_weight(w.normal_(0.0, m.in_features ** -0.5,
                                         generator=gen))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        else:
            for p in m.parameters(recurse=False):
                p.normal_(0.0, getattr(m, "init_std", 0.02), generator=gen)


def build_module(cls, cfg, dtype: torch.dtype, device,
                 gen: Optional[torch.Generator] = None, **kwargs
                 ) -> nn.Module:
    """``cls(cfg, **kwargs)`` (``cls(**kwargs)`` where ``cfg`` is None) in
    ``dtype`` on ``device``, in eval mode and without gradients: its
    parameters drawn from ``gen``, or left uninitialised without one (on
    the meta device, a skeleton without storage)."""
    with torch.device("meta"):
        module = cls(**kwargs) if cfg is None else cls(cfg, **kwargs)
    module = module.to(dtype=dtype)
    if torch.device(device).type != "meta":
        module = module.to_empty(device=device)
        if gen is not None:
            with torch.no_grad():
                _seeded_init(module, gen, dtype)
    return module.eval().requires_grad_(False)


def init_bundle(cfg: TheaterConfig, seed: int = 0, *,
                device="cuda", tokenizer_assets: Optional[str] = None,
                with_ip: bool = False, with_vision: bool = False,
                with_controlnet: bool = False,
                with_t2i_adapter: bool = False, with_sam: bool = False,
                ip_variant: str = "base") -> Bundle:
    """Random-weight bundle built directly on ``device`` (default the card;
    there is no fallback to the CPU: pass ``device="cpu"`` to ask for it;
    on ``"meta"`` a skeleton without weights).

    ``with_ip`` adds the IP-Adapter UNet (``unet_ip``, its own weights,
    ``ip_num_tokens`` = ``num_tokens``, ``resampler_queries`` or 1 for the
    base, plus and full variants) and the variant's projector;
    ``with_vision`` adds the CLIP vision tower; ``with_controlnet`` the
    ControlNet of ``cfg.controlnet``; ``with_t2i_adapter`` the T2I-Adapter
    of the UNet's levels at the VAE's scale, in the UNet's dtype;
    ``with_sam`` the segmenter of ``cfg.sam.backend``: ``SAMLite`` at
    ``cfg.sam``'s widths ("lite") or ``SamHF`` ("hf": sam-vit-base, the
    tiny instance where ``cfg.sam.image_size <= 64``).  The ControlNet, the
    adapter and then the segmenter are drawn last, so every other part
    keeps the weights of a bundle without them."""
    if ip_variant not in PROJ_KINDS:
        raise ValueError(f"ip_variant must be one of {tuple(PROJ_KINDS)}, "
                         f"got {ip_variant!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_bundle: no CUDA device; pass device='cpu' "
                           "to build the bundle on the CPU")
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    b = Bundle(
        cfg=cfg,
        tokenizer=load_tokenizer(tokenizer_assets, cfg.text.vocab_size),
        unet=build_module(UNet2DCondition, cfg.unet,
                          get_dtype(cfg.unet.dtype), device, gen),
        vae=build_module(AutoencoderKL, cfg.vae, get_dtype(cfg.vae.dtype),
                         device, gen),
        text=build_module(CLIPTextEncoder, cfg.text,
                          get_dtype(cfg.text.dtype), device, gen),
        text2=(None if cfg.text2 is None else build_module(
            CLIPTextEncoder, cfg.text2, get_dtype(cfg.text2.dtype), device,
            gen)),
    )
    if with_ip:
        ip = cfg.ip_adapter
        if ip_variant == "plus":
            n_tokens, proj, kw = ip.resampler_queries, Resampler, dict(
                embedding_dim=cfg.vision.hidden_size,
                output_dim=cfg.unet.cross_attention_dim)
        elif ip_variant == "full":
            n_tokens, proj, kw = 1, MLPProjModel, {}
        else:
            n_tokens, proj, kw = ip.num_tokens, ImageProjModel, {}
        b.ip_variant = ip_variant
        b.unet_ip = build_module(
            UNet2DCondition,
            dataclasses.replace(cfg.unet, ip_num_tokens=n_tokens),
            get_dtype(cfg.unet.dtype), device, gen)
        b.image_proj = build_module(proj, ip, torch.float32, device, gen,
                                    **kw)
    if with_vision:
        b.vision = build_module(CLIPVisionEncoder, cfg.vision,
                                get_dtype(cfg.vision.dtype), device, gen)
    if with_controlnet:
        b.controlnet = build_module(ControlNet, cfg.controlnet,
                                    get_dtype(cfg.controlnet.unet.dtype),
                                    device, gen)
    if with_t2i_adapter:
        b.t2i_adapter = build_module(T2IAdapter, cfg.unet,
                                     get_dtype(cfg.unet.dtype), device, gen,
                                     downscale=cfg.pipeline.vae_scale)
    if with_sam:
        b.sam = build_sam(cfg, device, gen)
    return b


def sam_hf_config(cfg: TheaterConfig) -> SamHFConfig:
    """The ``SamHF`` of a config: sam-vit-base, or the tiny instance where
    ``cfg.sam.image_size <= 64``."""
    return (tiny_sam_hf_config() if cfg.sam.image_size <= 64
            else SamHFConfig())


def build_sam(cfg: TheaterConfig, device, gen=None,
              hf_cfg: Optional[SamHFConfig] = None) -> nn.Module:
    """The segmenter of ``cfg.sam.backend`` (see :func:`init_bundle`), or
    a ``SamHF`` of ``hf_cfg`` where it is given."""
    if hf_cfg is None and cfg.sam.backend == "hf":
        hf_cfg = sam_hf_config(cfg)
    if hf_cfg is not None:
        return build_module(SamHF, hf_cfg, torch.float32, device, gen)
    return build_module(SAMLite, cfg.sam, get_dtype(cfg.sam.dtype), device,
                        gen)


def build_lineart(device, gen=None, **kwargs) -> nn.Module:
    """The lineart annotator (``LineartGenerator(**kwargs)``), fp32."""
    return build_module(LineartGenerator, None, torch.float32, device, gen,
                        **kwargs)
