"""Per-character generation: the IP-Adapter-conditioned CFG pass with
optional latent guidance and reference-attention capture.

Port of ``theatergen_tpu/pipelines/character.py`` (``theater.py`` builds
it with ``use_ip=True, capture_ref_attn=True``): the IP UNet conditions on
the projected CLIP image features of the character, ``ip_scale`` weights
them (0.4 on a character-DB hit, 0.0 on a miss), the whole latent
trajectory is kept on the device, and the guidance keys' cross-attention
maps of the character's word token are captured each step, for the mask
and the detection of a turn.  The runner steps the config's sampler
(DDIM, Euler-Ancestral or LCM) and takes the JAX package's knobs: CFG
cutoff, DeepCache, and LCM's cond-only steps.  On an SDXL bundle it takes
the micro-conditioning (``extra_cond``: pooled text and time ids).  With
``guided`` each step ``i < guidance_steps`` first descends the latents on
the guidance energy (``pipelines/guidance.py``; the reference's
``latent_backward_guidance``), through a full cond-only UNet forward
whatever DeepCache does.

NHWC at the boundary, as in the JAX package: latents ``[1, h, w, 4]``,
images ``[B, H, W, 3]`` in [0, 1].  :func:`make_batched_character_pipeline`
runs B characters as one batch (the JAX package's ``vmap`` of this
runner): per element its own context, IP scale, word token, noise stream
and guidance problem.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops import scheduler as sched_ops
from . import guidance as guidance_lib
from .bundle import Bundle
from .sd import cfg_combine, check_noise, step_noise

# CLIP's image normalisation
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass
class CharacterResult:
    latents: torch.Tensor                       # [1, h, w, 4] final
    trajectory: torch.Tensor                    # [S+1, 1, h, w, 4]
    ref_attn: Optional[Tuple[torch.Tensor, ...]]  # per key [S, heads, HW]


@torch.no_grad()
def encode_ip_image(bundle: Bundle, image: torch.Tensor) -> torch.Tensor:
    """RGB [0, 1] ``[B, H, W, 3]`` → CLIP features for the IP projector: the
    projected CLS embed ``[B, P]`` (base and full variants) or the
    penultimate tokens ``[B, N+1, C]`` (plus).  The resize to the tower's
    size is bilinear and antialiased when it shrinks, as
    ``jax.image.resize(..., "bilinear")`` is."""
    if bundle.vision is None:
        raise ValueError("encode_ip_image: the bundle has no vision tower "
                         "(init_bundle(..., with_vision=True))")
    size = bundle.cfg.vision.image_size
    dev = bundle.device
    x = image.to(dev, torch.float32).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    mean = torch.tensor(CLIP_MEAN, device=dev)[:, None, None]
    std = torch.tensor(CLIP_STD, device=dev)[:, None, None]
    embeds, _, patch_tokens = bundle.vision((x - mean) / std)
    return patch_tokens if bundle.ip_variant == "plus" else embeds


def uncond_ip_features(bundle: Bundle) -> Optional[torch.Tensor]:
    """Features for the unconditional IP branch: None for the base variant
    (it projects zero embeds), else the features of a black image."""
    if bundle.ip_variant == "base" or bundle.vision is None:
        return None
    size = bundle.cfg.vision.image_size
    return encode_ip_image(bundle, torch.zeros((1, size, size, 3)))


@torch.no_grad()
def ip_context(bundle: Bundle, text_context: torch.Tensor,
               image_embeds: torch.Tensor,
               uncond_features: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Append IP tokens to the ``[2, L, C]`` uncond ++ cond text context:
    the cond row gets the projected image tokens, the uncond row the
    projection of zeros (base) or of ``uncond_features`` (plus/full)."""
    dev = text_context.device
    embeds = image_embeds.to(dev, torch.float32)
    if uncond_features is None:
        uncond_features = torch.zeros_like(embeds)
    tokens = torch.cat([bundle.image_proj(uncond_features.to(embeds)),
                        bundle.image_proj(embeds)], dim=0)
    return torch.cat([text_context, tokens.to(text_context.dtype)], dim=1)


def make_character_pipeline(bundle: Bundle, num_steps: int, *,
                            use_ip: bool = True, guided: bool = False,
                            capture_ref_attn: bool = False,
                            guidance_scale: Optional[float] = None,
                            cfg_cutoff_fraction: Optional[float] = None,
                            deepcache_interval: Optional[int] = None):
    """Build the per-character runner; returns ``(run, sampler)``.

    ``run(input_latents [1, h, w, 4], context [2, L(+n), C], ip_scale,
    word_token=0, generator=None, *, noise=None, extra_cond=None,
    gin=None) -> CharacterResult``;
    ``ip_scale`` is a float or a 0-dim tensor, made a tensor on the device
    once per run, so one runner serves a DB hit and a miss.  The reference
    maps are captured at the prompt position ``word_token``: in a turn the
    last token of the character's phrase (the JAX runner's
    ``gin.word_token[0]``, set by ``Theater._character_prep``), 0 where no
    phrase is given.  The sampler is ``cfg.pipeline.scheduler_type``'s; an
    Euler-Ancestral or LCM step draws its noise from ``generator`` (NHWC
    ``[1, h, w, 4]`` per step, on the generator's device) unless ``noise``
    (``[S, 1, h, w, 4]``) is injected.  ``extra_cond`` (an SDXL bundle's
    ``{"pooled_text": [2, P], "time_ids": [2, 6]}``, uncond row first) goes
    to every UNet evaluation; a cond-only evaluation takes its trailing
    rows, as the JAX runner does.

    ``cfg_cutoff_fraction``: CFG for the first ``ceil(frac·S)`` steps,
    then cond-only, the reference maps taken from the cond row (index 0)
    there.  LCM runs every step cond-only.  ``deepcache_interval``: a full
    UNet forward every N-th step (step 0 always), a shallow forward from
    the cached deep feature in between; a shallow step's reference maps
    are the last full step's (the captured layers lie in the skipped deep
    blocks), and at the cutoff the cache keeps its cond rows.  The loop
    copies nothing from the host per step: the sampler's tables are
    indexed on the device.

    ``guided``: before each step ``i < cfg.guidance.guidance_steps``, the
    guidance update (``guidance.guidance_update``) of the latents on the
    energy of ``gin`` (a ``GuidanceInputs``, required then), through a
    full cond-only UNet forward on the cond context ``context[1:2]`` (an
    SDXL bundle's cond rows of ``extra_cond``), its loss threaded from
    step to step; the trajectory holds the guided latents.  Only the
    update records a graph."""
    loop, sampler = _character_loop(
        bundle, num_steps, use_ip=use_ip, guided=guided,
        capture_ref_attn=capture_ref_attn, guidance_scale=guidance_scale,
        cfg_cutoff_fraction=cfg_cutoff_fraction,
        deepcache_interval=deepcache_interval)

    def run(input_latents: torch.Tensor, context: torch.Tensor,
            ip_scale=0.0, word_token: int = 0,
            generator: Optional[torch.Generator] = None, *,
            noise: Optional[torch.Tensor] = None,
            extra_cond: Optional[dict] = None,
            gin: Optional[guidance_lib.GuidanceInputs] = None
            ) -> CharacterResult:
        dev = bundle.device
        check_noise(noise, sampler.num_steps, input_latents.shape)
        ip = torch.as_tensor(ip_scale, dtype=torch.float32, device=dev)
        b = input_latents.shape[0]
        cond_cfg, cond_1 = trailing_rows(extra_cond, dev, 2 * b, b)
        final, traj, refs = loop(input_latents, context.to(dev), ip, ip,
                                 cond_cfg, cond_1, [word_token] * b,
                                 generator, noise, gin)
        return CharacterResult(
            final, traj, None if refs is None else tuple(r[:, 0]
                                                         for r in refs))

    return run, sampler


def make_batched_character_pipeline(bundle: Bundle, num_steps: int,
                                    **kwargs):
    """The character runner at batch B, B independent passes in one loop
    (the JAX package's ``vmap`` of the batch-1 runner,
    ``parallel/driver.py::make_dp_character_runner``); returns ``(run,
    sampler)``.  Every UNet evaluation runs at batch 2B under CFG (the
    uncond rows of every element, then the cond rows) and B cond-only.

    ``run(input_latents [B, h, w, 4], contexts [B, 2, L(+n), C], ip_scales
    [B], word_tokens [B], generators=None, *, noise=None, extra_conds=None,
    gins=None) -> CharacterResult`` with a leading B on every field:
    ``latents [B, 1, h, w, 4]``, ``trajectory [B, S+1, 1, h, w, 4]``, per
    key ``ref_attn [B, S, heads, HW]``, each element's maps at its own
    word token.  ``ip_scales`` weight each element's IP branch (a DB hit
    and a miss in one batch); ``generators`` is a list of one generator per
    element (each draws its own ``[1, h, w, 4]`` a step, as the batch-1
    runner draws from it) unless ``noise`` (``[S, B, h, w, 4]``) is
    injected; ``extra_conds`` holds ``[B, 2, ...]`` tensors (uncond row
    first); ``gins`` is a batched ``GuidanceInputs`` (leading axis B, see
    ``guidance.stack_inputs``): each element descends on its own energy
    and stops on its own threshold.  The options (``kwargs``) are
    :func:`make_character_pipeline`'s."""
    loop, sampler = _character_loop(bundle, num_steps, **kwargs)

    def run(input_latents: torch.Tensor, contexts: torch.Tensor,
            ip_scales, word_tokens, generators=None, *,
            noise: Optional[torch.Tensor] = None,
            extra_conds: Optional[dict] = None,
            gins: Optional[guidance_lib.GuidanceInputs] = None
            ) -> CharacterResult:
        dev = bundle.device
        b = input_latents.shape[0]
        check_noise(noise, sampler.num_steps, input_latents.shape)
        ip = torch.as_tensor(ip_scales, dtype=torch.float32,
                             device=dev).reshape(b)
        words = [int(t) for t in torch.as_tensor(word_tokens).reshape(b)]
        flat = None
        if extra_conds:
            flat = {k: cfg_rows(v) for k, v in extra_conds.items()}
        cond_cfg, cond_1 = trailing_rows(flat, dev, 2 * b, b)
        final, traj, refs = loop(
            input_latents, cfg_rows(contexts.to(dev)), torch.cat([ip, ip]),
            ip, cond_cfg, cond_1, words, generators, noise, gins)
        return CharacterResult(
            final[:, None], traj.transpose(0, 1)[:, :, None],
            None if refs is None else tuple(r.transpose(0, 1) for r in refs))

    return run, sampler


def _character_loop(bundle: Bundle, num_steps: int, *, use_ip: bool = True,
                    guided: bool = False, capture_ref_attn: bool = False,
                    guidance_scale: Optional[float] = None,
                    cfg_cutoff_fraction: Optional[float] = None,
                    deepcache_interval: Optional[int] = None):
    """The character loop shared by the batch-1 and batched runners:
    ``loop(input_latents [B, h, w, 4], context [2B, L, C] (the uncond rows,
    then the cond rows), ip_cfg [2B] or 0-dim, ip_1 [B] or 0-dim,
    cond_cfg, cond_1 (the UNet's extra inputs at 2B and B rows),
    word_tokens (B ints), generator(s), noise, gin) -> (final [B, h, w,
    4], trajectory [S+1, B, h, w, 4], per key maps [S, B, heads, HW] or
    None)``."""
    cfg = bundle.cfg
    gcfg = cfg.guidance
    unet = bundle.unet_ip if use_ip else bundle.unet
    if unet is None:
        raise ValueError("make_character_pipeline: use_ip needs a bundle "
                         "with the IP UNet (init_bundle(..., with_ip=True))")
    sampler = sched_ops.make_sampler(
        cfg.scheduler, num_steps, kind=cfg.pipeline.scheduler_type,
        fast_after_steps=cfg.pipeline.fast_after_steps,
        fast_rate=cfg.pipeline.fast_rate)
    gs = cfg.pipeline.guidance_scale if guidance_scale is None \
        else guidance_scale
    keys = tuple(cfg.guidance.attn_keys) if capture_ref_attn else ()
    text_len = cfg.text.max_length
    s_total = sampler.num_steps
    # LCM(-LoRA) distils CFG into the weights: every step is cond-only
    cutoff = (0 if sampler.kind == "lcm" else
              sched_ops.cfg_cutoff_steps(s_total, cfg_cutoff_fraction))
    dc = deepcache_interval if deepcache_interval and \
        deepcache_interval > 1 else None

    @torch.no_grad()
    def loop(input_latents, context, ip_cfg, ip_1, cond_cfg, cond_1,
             word_tokens, generator, noise, gin):
        dev = bundle.device
        steps = sampler.on(dev)
        kw_cfg = dict(ip_scale=ip_cfg) if use_ip else {}
        kw_1 = dict(ip_scale=ip_1) if use_ip else {}
        lat = input_latents.to(dev, torch.float32).permute(0, 3, 1, 2)
        b = lat.shape[0]
        words = torch.tensor(word_tokens, dtype=torch.long, device=dev)
        energy = None
        if guided:
            if gin is None:
                raise ValueError("a guided character run needs gin "
                                 "(GuidanceInputs)")
            gin = gin.to(dev)
            energy = guidance_lib.unet_energy_fn(unet, cfg, **cond_1, **kw_1)
        gloss = None
        traj = torch.empty((s_total + 1,) + tuple(input_latents.shape),
                           dtype=torch.float32, device=dev)
        refs = ref_prev = cache = None
        for i in range(s_total):
            if energy is not None and i < gcfg.guidance_steps:
                lat, gloss, _ = guidance_lib.guidance_update(
                    energy, steps, gcfg, lat, i, context[b:], gin,
                    prev_loss=gloss)
            traj[i] = lat.permute(0, 2, 3, 1)
            cfg_on = i < cutoff
            if i == cutoff and cache is not None:
                cache = cache[b:]
            scaled = steps.scale_model_input(lat, i)
            if cfg_on:
                x_in, ctx, cond_rows = torch.cat([scaled, scaled]), context, b
                xc, kw = cond_cfg, kw_cfg
            else:
                x_in, ctx, cond_rows = scaled, context[b:], 0
                xc, kw = cond_1, kw_1
            t = steps.timesteps[i].expand(x_in.shape[0])
            if dc and i % dc:
                eps = unet(x_in, t, ctx, deep_cache=cache, **xc, **kw)
                ref = ref_prev
            else:
                out = unet(x_in, t, ctx, capture_keys=keys,
                           return_deep_cache=bool(dc), **xc, **kw)
                ref = None
                if keys:
                    out, captured = out
                    # each element's cond row, at its own word token
                    rows = torch.arange(cond_rows, cond_rows + b, device=dev)
                    ref = ref_prev = [
                        captured[tuple(k)][rows, :, :, words].float()
                        for k in keys]
                eps, cache = out if dc else (out, None)
            if keys:
                if refs is None:
                    refs = tuple(torch.empty((s_total,) + r.shape,
                                             dtype=torch.float32, device=dev)
                                 for r in ref)
                for r, m in zip(refs, ref):
                    r[i] = m
            eps = eps.float()
            if cfg_on:
                eps = cfg_combine(eps, gs)
            n = (step_noise(i, input_latents.shape, dev, generator, noise)
                 if sampler.draws(i) else None)
            lat = steps.step(eps, i, lat, n)
        final = lat.permute(0, 2, 3, 1)
        traj[s_total] = final
        return final, traj, refs

    return loop, sampler


def cfg_rows(x: torch.Tensor) -> torch.Tensor:
    """``[B, 2, ...]`` (per element, its uncond row then its cond row) →
    the CFG batch ``[2B, ...]``: every uncond row, then every cond row."""
    return torch.cat([x[:, 0], x[:, 1]])


def trailing_rows(extra_cond: Optional[dict], device, *rows: int):
    """For each batch size in ``rows``, ``extra_cond``'s tensors cut to
    their trailing rows on ``device`` (empty dicts without it)."""
    if not extra_cond:
        return tuple({} for _ in rows)
    ec = {k: v.to(device) for k, v in extra_cond.items()}
    return tuple({k: v[-n:] for k, v in ec.items()} for n in rows)
