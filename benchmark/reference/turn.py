"""One story turn in plain PyTorch: the yardstick a served turn is held to.

The serial path of a TheaterGen turn, written out once, in fp32 (TF32
off) and without any kernel: for each unique character of the turn its
IP-Adapter pass (CFG, the sampler of the config, the word token's
cross-attention maps captured at the guidance keys), the VAE decode, the
attention detection with up to three attempts, the mask from the
step-mean maps; then the composition of the characters' trajectories, the
pixel collage and its lineart, and the final pass (ControlNet or
T2I-Adapter plus the IP UNet, the masked region frozen for the first
``frozen_step_ratio`` of the steps), and the decode.

The noise streams are the served system's convention, which is a
function of the turn's seed: a generator on the device seeded by numpy's
``SeedSequence`` of ``(seed, *stream)``; a character's starting latents
from ``(seed, 0, idx)``, an ancestral step's noise from ``(seed, 1, idx,
attempt)``, the final pass's from ``(seed, 2)``, the composition's
background from ``(seed, 4)``.

``RefModels.build(cfg, states, device, precision)`` loads the weights the
benchmark made; ``precision="fp8"`` rounds every linear and convolution of
the modules the configuration runs in bf16 (their weights per tensor
once, their inputs per call) to float8 e4m3 before an fp32 product: the
control, which a sound check must tell apart from the served system.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import TheaterConfig
from .models.clip import CLIPTextEncoder, CLIPVisionEncoder
from .models.controlnet import ControlNet
from .models.ip_adapter import ImageProjModel
from .models.t2i_adapter import T2IAdapter, tile_features
from .models.unet import UNet2DCondition
from .models.vae import AutoencoderKL
from .ops import geometry as G
from .ops import latents as L
from .ops import scheduler as sched_ops
from .ops.lineart import dog_lineart
from .perception import detector as det
from .utils import parse
from .utils.tokenizer import find_phrase_token_indices, load_tokenizer

ATTN_AGG_START = 10
MAX_REGEN_ATTEMPTS = 3
FINAL_NEG_PREFIX = "incohesive, edge shadow, blurry, "
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
FP8_MAX = 448.0


def module_specs(cfg: TheaterConfig) -> Dict[str, tuple]:
    """``{name: (class, config, kwargs, dtype name)}`` of every module a
    bundle of ``cfg`` may hold, by the bundle's names, in the order the
    weights are made."""
    ip_unet = dataclasses.replace(cfg.unet,
                                  ip_num_tokens=cfg.ip_adapter.num_tokens)
    specs = {
        "unet": (UNet2DCondition, cfg.unet, {}, cfg.unet.dtype),
        "vae": (AutoencoderKL, cfg.vae, {}, cfg.vae.dtype),
        "text": (CLIPTextEncoder, cfg.text, {}, cfg.text.dtype),
    }
    if cfg.text2 is not None:
        specs["text2"] = (CLIPTextEncoder, cfg.text2, {}, cfg.text2.dtype)
    specs["unet_ip"] = (UNet2DCondition, ip_unet, {}, cfg.unet.dtype)
    specs["image_proj"] = (ImageProjModel, cfg.ip_adapter, {}, "float32")
    specs["vision"] = (CLIPVisionEncoder, cfg.vision, {}, cfg.vision.dtype)
    specs["controlnet"] = (ControlNet, cfg.controlnet, {},
                           cfg.controlnet.unet.dtype)
    specs["t2i_adapter"] = (T2IAdapter, cfg.unet,
                            dict(downscale=cfg.pipeline.vae_scale),
                            cfg.unet.dtype)
    return specs


def build_skeleton(spec) -> nn.Module:
    """A module of ``spec`` on the meta device (shapes, no storage)."""
    cls, mcfg, kwargs, _ = spec
    with torch.device("meta"):
        return cls(mcfg, **kwargs)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, in fp32."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _fp8_module(module: nn.Module) -> None:
    """Every linear and convolution of ``module`` computes on float8
    weights and inputs."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            with torch.no_grad():
                m.weight.copy_(_fp8(m.weight))
            m.register_forward_pre_hook(
                lambda _m, args: (_fp8(args[0]),) + tuple(args[1:]))


class RefModels:
    """The plain modules of one configuration, fp32 on ``device``."""

    def __init__(self, cfg: TheaterConfig, modules: Dict[str, nn.Module],
                 device):
        self.cfg, self.device = cfg, torch.device(device)
        self.tokenizer = load_tokenizer(None, cfg.text.vocab_size)
        for name in ("text", "text2", "unet_ip", "image_proj", "vision",
                     "vae", "controlnet", "t2i_adapter"):
            setattr(self, name, modules.get(name))

    @classmethod
    def build(cls, cfg: TheaterConfig, states: Dict[str, dict], device,
              precision: str = "fp32") -> "RefModels":
        """Modules from the state dicts ``states`` (by the bundle's module
        names; the served dtype's values, cast here to fp32)."""
        specs = module_specs(cfg)
        modules = {}
        for name, sd in states.items():
            if name == "unet" or name not in specs:
                continue
            m = build_skeleton(specs[name])
            m.load_state_dict({k: v.to(device, torch.float32)
                               for k, v in sd.items()}, strict=True,
                              assign=True)
            m = m.eval().requires_grad_(False)
            if precision == "fp8" and specs[name][3] == "bfloat16":
                _fp8_module(m)
            modules[name] = m
        return cls(cfg, modules, device)


def noise_generator(device, seed: int, *stream: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def cfg_combine(eps: torch.Tensor, scale: float) -> torch.Tensor:
    eps_u, eps_c = eps.chunk(2, dim=0)
    return eps_u + scale * (eps_c - eps_u)


def _step_noise(gen: torch.Generator, shape, device) -> torch.Tensor:
    n = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return n.to(device).permute(0, 3, 1, 2)


def aggregate_attn(ref_attn: Sequence[torch.Tensor], num_steps: int
                   ) -> List[torch.Tensor]:
    start = min(ATTN_AGG_START, max(num_steps - 1, 0))
    return [m[start:].float().mean(0) for m in ref_attn]


def attn_mask(maps: Sequence[torch.Tensor], hint: torch.Tensor, h: int,
              w: int, H: int, W: int):
    """(latent mask [h, w], pixel mask [H, W]) from the step-mean maps:
    above 0.3 of their maximum, or 0.1 inside the box ``hint``."""
    agg = torch.zeros((h, w), dtype=torch.float32, device=hint.device)
    for m in maps:
        mm = m.float().mean(-2)
        side = int(round(mm.shape[-1] ** 0.5))
        agg = agg + G.resize_bilinear(mm.reshape(side, side), h, w)
    agg = agg / (agg.amax((-2, -1), keepdim=True) + 1e-8)
    box_m = G.box_mask(hint.float(), h, w)
    m_lat = torch.maximum((agg > 0.3).float(), box_m * (agg > 0.1).float())
    return m_lat, G.upsample_nearest(m_lat, H, W)


class Turn:
    """The serial turn over :class:`RefModels`."""

    def __init__(self, models: RefModels):
        self.m, self.cfg = models, models.cfg
        self.dev = models.device
        pl = self.cfg.pipeline
        for knob in ("cfg_cutoff_fraction", "deepcache_interval",
                     "controlnet_interval", "fast_after_steps"):
            if getattr(pl, knob) is not None:
                raise ValueError(f"the plain turn has no {knob}")
        self.is_xl = self.cfg.unet.addition_embed_type == "text_time"
        self.sampler = sched_ops.make_sampler(
            self.cfg.scheduler, pl.num_steps, kind=pl.scheduler_type)
        self.init_sigma = float(self.sampler.init_noise_sigma)

    # ---------------------------------------------------------------- parts

    def tokens(self, texts: List[str], **kw) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray(self.m.tokenizer(texts,
                                        max_length=self.cfg.text.max_length,
                                        **kw)),
            dtype=torch.long, device=self.dev)

    def encode_text(self, prompt: str, negative: str):
        texts = [negative, prompt]
        if not self.is_xl:
            return self.m.text(self.tokens(texts))[0], {}
        _, _, pen1 = self.m.text(self.tokens(texts), return_penultimate=True)
        _, pooled, pen2 = self.m.text2(self.tokens(texts, pad_token_id=0),
                                       return_penultimate=True)
        pl = self.cfg.pipeline
        tids = torch.tensor([[pl.height, pl.width, 0, 0, pl.height,
                              pl.width]], dtype=torch.float32,
                            device=self.dev).expand(2, 6)
        return (torch.cat([pen1, pen2], dim=-1),
                dict(pooled_text=pooled, time_ids=tids))

    def encode_image(self, image: torch.Tensor) -> torch.Tensor:
        """RGB [0, 1] ``[1, H, W, 3]`` → the projected CLS embed ``[1, P]``."""
        size = self.cfg.vision.image_size
        x = image.to(self.dev, torch.float32).permute(0, 3, 1, 2)
        x = F.interpolate(x, size=(size, size), mode="bilinear",
                          align_corners=False, antialias=True)
        mean = torch.tensor(CLIP_MEAN, device=self.dev)[:, None, None]
        std = torch.tensor(CLIP_STD, device=self.dev)[:, None, None]
        return self.m.vision((x - mean) / std)[0]

    def ip_context(self, text_ctx: torch.Tensor, embeds: torch.Tensor):
        embeds = embeds.to(self.dev, torch.float32)
        tokens = torch.cat([self.m.image_proj(torch.zeros_like(embeds)),
                            self.m.image_proj(embeds)], dim=0)
        return torch.cat([text_ctx, tokens.to(text_ctx.dtype)], dim=1)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        vae = self.m.vae
        img = vae.decode((latents / self.cfg.vae.scaling_factor)
                         .permute(0, 3, 1, 2))
        img = img.float().permute(0, 2, 3, 1)
        return torch.clamp(img / 2 + 0.5, 0.0, 1.0)

    # ----------------------------------------------------------- the passes

    def character_pass(self, init_lat, ctx, extra, ip_scale, word: int,
                       gen: Optional[torch.Generator]):
        """→ (trajectory [S+1, 1, h, w, 4], per key maps [S, heads, HW])."""
        steps = self.sampler.on(self.dev)
        gs = self.cfg.pipeline.guidance_scale
        keys = tuple(tuple(k) for k in self.cfg.guidance.attn_keys)
        ip = torch.as_tensor(ip_scale, dtype=torch.float32, device=self.dev)
        lat = init_lat.to(self.dev, torch.float32).permute(0, 3, 1, 2)
        s_total = self.sampler.num_steps
        traj, refs = [], [[] for _ in keys]
        for i in range(s_total):
            traj.append(lat.permute(0, 2, 3, 1))
            scaled = steps.scale_model_input(lat, i)
            x_in = torch.cat([scaled, scaled])
            t = steps.timesteps[i].expand(2)
            eps, captured = self.m.unet_ip(x_in, t, ctx, capture_keys=keys,
                                           ip_scale=ip, **extra)
            for r, k in zip(refs, keys):
                r.append(captured[k][1, :, :, word].float())
            eps = cfg_combine(eps.float(), gs)
            n = (_step_noise(gen, (1,) + tuple(traj[0].shape[1:]), self.dev)
                 if self.sampler.draws(i) else None)
            lat = steps.step(eps, i, lat, n)
        traj.append(lat.permute(0, 2, 3, 1))
        return torch.stack(traj), [torch.stack(r) for r in refs]

    def final_pass(self, comp, frozen_mask, frozen_steps: int, ctx, cn_ctx,
                   cond_img, extra, gen: Optional[torch.Generator]):
        steps = self.sampler.on(self.dev)
        gs = self.cfg.pipeline.guidance_scale
        ip = torch.as_tensor(self.cfg.pipeline.ip_scale_final,
                             dtype=torch.float32, device=self.dev)
        comp = comp.to(self.dev, torch.float32).permute(0, 1, 4, 2, 3)
        fm = torch.clamp(frozen_mask.float(), 0.0, 1.0)[None, None]
        cond = cond_img.to(self.dev, torch.float32).permute(2, 0, 1)[None]
        lev = None
        if self.m.t2i_adapter is not None and self.is_xl:
            lev = tile_features(self.m.t2i_adapter(cond), 2)
        cn = self.m.controlnet if lev is None else None
        cond_embed = cn.embed_hint(cond) if cn is not None else None
        lat = comp[0]
        for i in range(self.sampler.num_steps):
            scaled = steps.scale_model_input(lat, i)
            x_in = torch.cat([scaled, scaled])
            t = steps.timesteps[i].expand(2)
            res = dict(extra)
            if lev is not None:
                res["level_residuals"] = lev
            if cn is not None:
                down, mid = cn(x_in, t, cn_ctx, conditioning_scale=1.0,
                               cond_embed=cond_embed)
                res.update(down_residuals=down, mid_residual=mid)
            eps = self.m.unet_ip(x_in, t, ctx, ip_scale=ip, **res)
            eps = cfg_combine(eps.float(), gs)
            n = (_step_noise(gen, (1,) + tuple(lat.permute(0, 2, 3, 1)
                                               .shape[1:]), self.dev)
                 if self.sampler.draws(i) else None)
            nxt = steps.step(eps, i, lat, n)
            lat = (comp[i + 1] * fm + nxt * (1.0 - fm)
                   if frozen_steps > i else nxt)
        return lat.permute(0, 2, 3, 1)

    # ----------------------------------------------------------------- turn

    def character(self, plan: parse.ObjectPlan, extra_neg: str, seed: int,
                  idx: int, db: Dict[int, torch.Tensor]) -> dict:
        pl = self.cfg.pipeline
        h, w, H, W = pl.latent_height, pl.latent_width, pl.height, pl.width
        centered = G.centered_box(torch.tensor(plan.box, dtype=torch.float32))
        so_prompt = f"full-body picture of {plan.phrase}"
        neg = parse.DEFAULT_SO_NEGATIVE_PROMPT
        if extra_neg:
            neg = f"{extra_neg}, {neg}"
        token_pos = find_phrase_token_indices(
            self.m.tokenizer, so_prompt, plan.word, self.cfg.text.max_length)
        if not token_pos:
            so_prompt = f"{so_prompt} | {plan.phrase}"
            token_pos = find_phrase_token_indices(
                self.m.tokenizer, so_prompt, plan.word,
                self.cfg.text.max_length)
        text_ctx, extra = self.encode_text(so_prompt, neg)
        hit = plan.obj_id in db
        if hit:
            ip_scale = pl.ip_scale_hit
            embed = self.encode_image(db[plan.obj_id][None])
        else:
            ip_scale = 0.0
            embed = torch.zeros((1, self.cfg.ip_adapter.clip_embeddings_dim),
                                device=self.dev)
        ctx = self.ip_context(text_ctx, embed)
        word = token_pos[-1] if token_pos else 0
        gen = noise_generator(self.dev, seed, 0, idx)
        for attempt in range(MAX_REGEN_ATTEMPTS):
            init = L.input_latents_for_boxes(
                gen, centered[None].to(self.dev), h, w,
                fg_blending_ratio=pl.fg_blending_ratio,
                init_noise_sigma=self.init_sigma)[0][0]
            step_gen = (noise_generator(self.dev, seed, 1, idx, attempt)
                        if self.sampler.needs_noise else None)
            traj, refs = self.character_pass(init, ctx, extra, ip_scale,
                                             word, step_gen)
            image = self.decode(traj[-1])
            agg = aggregate_attn(refs, self.sampler.num_steps)
            detection = det.attention_detect(agg, None)
            if bool(detection.ok):
                break
        ok = bool(detection.ok)
        box = detection.box if ok else centered.to(self.dev)
        m_lat, m_pix = attn_mask(agg, box, h, w, H, W)
        if not hit:
            embed = self.encode_image(image)
        return dict(trajectory=traj, image=image, mask_lat=m_lat,
                    mask_pix=m_pix, detected=ok, attempts=attempt + 1,
                    embed=embed)

    @torch.no_grad()
    def run(self, spec: dict, seed: int, db: Dict[int, torch.Tensor]) -> dict:
        """One turn → ``{image [H, W, 3], so_images [[H, W, 3]...],
        detections, attempts}`` (numpy, [0, 1]); ``db`` maps the ids the
        character DB holds to their images ``[H, W, 3]``."""
        prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._run(spec, seed, db)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev_tf32

    def _run(self, spec, seed, db):
        cfg, pl = self.cfg, self.cfg.pipeline
        plan = parse.convert_spec(spec, pl.height, pl.width)
        extra_neg = spec.get("extra_neg_prompt") or ""
        seen, cache, order = set(), {}, []
        for idx, oplan in enumerate(plan.object_plans):
            key = (oplan.prompt, oplan.obj_id)
            order.append(key)
            if key not in seen:
                seen.add(key)
                cache[key] = self.character(oplan, extra_neg, seed, idx, db)
        chars = [cache[k] for k in order]
        if not chars:
            raise ValueError("the plain turn needs characters")
        k = pl.max_objects
        n = min(len(chars), k)
        pad = k - n

        def stack(key):
            xs = [chars[i][key] for i in range(n)]
            return torch.stack(xs + [torch.zeros_like(xs[0])] * pad)

        boxes = torch.tensor(
            [plan.object_plans[i].box for i in range(n)] + [(0.0,) * 4] * pad,
            dtype=torch.float32, device=self.dev)
        bg = torch.randn((1, pl.latent_height, pl.latent_width, 4),
                         generator=noise_generator(self.dev, seed, 4),
                         device=self.dev) * self.init_sigma
        traj_a, masks_a, _ = L.align_with_boxes(
            stack("trajectory"), stack("mask_lat"), boxes)
        composed, fg_idx = L.compose_trajectories(traj_a, masks_a, bg)
        images = torch.stack([chars[i]["image"][0] for i in range(n)]
                             + [torch.zeros_like(chars[0]["image"][0])] * pad)
        collage, _ = L.collage_images(images, stack("mask_pix"), boxes,
                                      torch.arange(k, device=self.dev) < n)
        cond_img = dog_lineart(collage)
        neg = parse.DEFAULT_OVERALL_NEGATIVE_PROMPT
        if extra_neg:
            neg = f"{extra_neg}, {neg}"
        overall_ctx, extra = self.encode_text(plan.overall_prompt,
                                              FINAL_NEG_PREFIX + neg)
        ctx = self.ip_context(overall_ctx, chars[0]["embed"])
        frozen = min(int(round(pl.frozen_step_ratio * pl.num_steps)),
                     self.sampler.num_steps)
        gen = (noise_generator(self.dev, seed, 2)
               if self.sampler.needs_noise else None)
        final = self.final_pass(composed, (fg_idx > 0).float(), frozen, ctx,
                                overall_ctx, cond_img, extra, gen)
        image = self.decode(final)[0]
        return dict(
            image=image.float().cpu().numpy(),
            so_images=[c["image"][0].float().cpu().numpy() for c in chars],
            detections=[c["detected"] for c in chars],
            attempts=[c["attempts"] for c in chars])
