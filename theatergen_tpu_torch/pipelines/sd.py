"""Core txt2img pipeline: CFG over a Python loop of DDIM steps, with the
JAX package's step knobs (CFG cutoff, DeepCache), the guidance-free LCM
loop and DDIM inversion.

Port of ``theatergen_tpu/pipelines/sd.py``.  The functions keep the JAX
package's NHWC layout at their boundary (latents ``[B, h, w, 4]``, images
``[B, H, W, 3]`` in [0, 1]); the modules run NCHW inside.  Every random
draw takes an explicit ``torch.Generator``, or noise injected by the
caller (:func:`step_noise`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import scheduler as sched_ops
from ..ops.scheduler import DDIMSchedule
from .bundle import Bundle


def seeded_latents(generator: torch.Generator, batch: int, h: int, w: int,
                   channels: int = 4, *, device=None,
                   dtype=torch.float32) -> torch.Tensor:
    """Unit-normal starting noise ``[B, h, w, C]`` (DDIM: sigma 1), drawn on
    the generator's device and moved to ``device``."""
    x = torch.randn((batch, h, w, channels), generator=generator,
                    device=generator.device, dtype=dtype)
    return x if device is None else x.to(device)


def cfg_combine(eps: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance over a [2B, ...] uncond/cond stack."""
    eps_u, eps_c = eps.chunk(2, dim=0)
    return eps_u + scale * (eps_c - eps_u)


def step_noise(i: int, shape, device, generator=None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Step ``i``'s unit-normal noise as NCHW fp32 on ``device``:
    ``noise[i]`` (``[S, *shape]``, NHWC) where injected, else an NHWC draw
    of ``shape`` from ``generator`` on its own device.  ``generator`` may
    be a list, one per batch row: each draws its own row ``[1, *shape[1:]]``
    and the rows are concatenated, so a batch draws, row by row, what
    batch-1 runs draw from the same streams."""
    if noise is not None:
        n = noise[i]
    elif isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f"{len(generator)} generators for a batch of "
                             f"{shape[0]}")
        n = torch.cat([torch.randn((1,) + tuple(shape[1:]), generator=g,
                                   device=g.device, dtype=torch.float32)
                       .to(device) for g in generator])
    elif generator is not None:
        n = torch.randn(tuple(shape), generator=generator,
                        device=generator.device, dtype=torch.float32)
    else:
        raise ValueError("this sampler draws noise each step: pass a "
                         "generator or the noise")
    return n.to(device, torch.float32).permute(0, 3, 1, 2)


def check_noise(noise: Optional[torch.Tensor], steps: int, shape) -> None:
    if noise is not None and tuple(noise.shape) != (steps,) + tuple(shape):
        raise ValueError(f"noise shape {tuple(noise.shape)}, want "
                         f"{(steps,) + tuple(shape)}")


@torch.no_grad()
def denoise(unet, sched: DDIMSchedule, latents: torch.Tensor,
            context: torch.Tensor, guidance_scale: float, *,
            collect_trajectory: bool = False,
            cfg_cutoff_steps: Optional[int] = None,
            deepcache_interval: Optional[int] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the DDIM/CFG loop.  ``unet(sample NCHW, t [2B], context, **kw)``
    gives eps (and takes ``return_deep_cache``/``deep_cache`` with
    DeepCache); ``latents`` is NHWC fp32.  Returns ``(final, trajectory or
    None)``, where ``trajectory[s]`` is the latent entering step s and the
    last entry the final latent (``[S+1, B, h, w, C]``, preallocated).

    ``cfg_cutoff_steps``: CFG for the first N steps, cond-only (the cond
    half of ``context``, batch B) after; ``None`` or ≥ S keeps CFG
    throughout.  ``deepcache_interval``: a full UNet forward on every N-th
    step (step 0 always), refreshing the deep-feature cache, and a shallow
    forward from the cache in between; at the cutoff the cache keeps its
    cond rows.  ``None`` or 1 runs every step in full.  The timesteps and
    alphas are indexed from tables on the device: no host copy per
    step."""
    s_total = sched.num_steps
    lat = latents.permute(0, 3, 1, 2).float()
    b = lat.shape[0]
    tables = sched_ops.device_tables(sched, lat.device)
    cutoff = s_total if cfg_cutoff_steps is None else min(
        int(cfg_cutoff_steps), s_total)
    use_dc = deepcache_interval is not None and deepcache_interval > 1
    cache = None
    traj = None
    if collect_trajectory:
        traj = torch.empty((s_total + 1,) + tuple(latents.shape),
                           dtype=lat.dtype, device=lat.device)
    for i in range(s_total):
        if traj is not None:
            traj[i] = lat.permute(0, 2, 3, 1)
        cfg_on = i < cutoff
        if i == cutoff and cache is not None:
            cache = cache[b:]
        x_in, ctx = ((torch.cat([lat, lat], dim=0), context) if cfg_on
                     else (lat, context[context.shape[0] // 2:]))
        t = tables.timesteps[i].expand(x_in.shape[0])
        if not use_dc:
            eps = unet(x_in, t, ctx)
        elif i % deepcache_interval == 0:
            eps, cache = unet(x_in, t, ctx, return_deep_cache=True)
        else:
            eps = unet(x_in, t, ctx, deep_cache=cache)
        eps = eps.float()
        if cfg_on:
            eps = cfg_combine(eps, guidance_scale)
        lat = sched_ops.ddim_step(tables, eps, i, lat)
    final = lat.permute(0, 2, 3, 1)
    if traj is not None:
        traj[s_total] = final
    return final, traj


@torch.no_grad()
def lcm_denoise(unet, sampler: sched_ops.Sampler, latents: torch.Tensor,
                context_cond: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The guidance-free LCM loop (LCM / LCM-LoRA): one cond-only UNet
    evaluation per step (``context_cond`` [B, L, C]), each step but the
    last re-noised with step i's noise, ``noise[i]`` (``[S, B, h, w, C]``)
    where given, else an NHWC draw from ``generator``.  NHWC fp32 in and
    out."""
    check_noise(noise, sampler.num_steps, latents.shape)
    lat = latents.permute(0, 3, 1, 2).float()
    run = sampler.on(lat.device)
    for i in range(sampler.num_steps):
        t = run.timesteps[i].expand(lat.shape[0])
        eps = unet(lat, t, context_cond)
        n = (step_noise(i, latents.shape, lat.device, generator, noise)
             if sampler.draws(i) else None)
        lat = run.step(eps.float(), i, lat, n)
    return lat.permute(0, 2, 3, 1)


@torch.no_grad()
def encode_image(bundle: Bundle, image: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Image ``[B, H, W, 3]`` in [-1, 1] → scaled latent ``[B, h, w, 4]``
    (fp32): the posterior mean, or with a ``generator`` (or ``noise``, an
    NHWC draw of the latent's shape) a sample of the posterior (the
    reference's ``encode``, ``models/pipelines.py:131-160``)."""
    mean, logvar = bundle.vae.encode(
        image.to(bundle.device).permute(0, 3, 1, 2))
    mean, logvar = mean.float().permute(0, 2, 3, 1), \
        logvar.float().permute(0, 2, 3, 1)
    z = mean
    if noise is None and generator is not None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device)
    if noise is not None:
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean.device)
    return z * bundle.cfg.vae.scaling_factor


@torch.no_grad()
def decode_with(vae, scaling_factor: float,
                latents: torch.Tensor) -> torch.Tensor:
    """Scaled latent ``[B, h, w, 4]`` → image ``[B, H, W, 3]`` in [0, 1]."""
    img = vae.decode((latents / scaling_factor).permute(0, 3, 1, 2))
    img = img.float().permute(0, 2, 3, 1)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0)


def encode_prompts(bundle: Bundle, prompts,
                   negative_prompts=None) -> torch.Tensor:
    """Tokenize + CLIP-encode → ``[2B, L, C]`` uncond ++ cond context."""
    if isinstance(prompts, str):
        prompts = [prompts]
    if negative_prompts is None:
        negative_prompts = [""] * len(prompts)
    elif isinstance(negative_prompts, str):
        negative_prompts = [negative_prompts] * len(prompts)
    if len(negative_prompts) != len(prompts):
        raise ValueError(
            f"got {len(prompts)} prompts but {len(negative_prompts)} negative"
            " prompts; pass one per prompt or a single string")
    ids = bundle.tokenizer(list(negative_prompts) + list(prompts),
                           max_length=bundle.cfg.text.max_length)
    return bundle.text_embed(ids)


class Text2Img:
    """txt2img runner.

    >>> pipe = Text2Img(bundle, num_steps=50)
    >>> img = pipe(torch.Generator("cuda").manual_seed(0), "a cat")

    ``sampler="lcm"`` runs the guidance-free LCM loop (one UNet evaluation
    a step, 4-8 steps) for LCM(-LoRA)-merged weights (``models/lora.py``);
    the DDIM loop takes DeepCache from ``cfg.pipeline.deepcache_interval``.
    A request draws its starting latents from the generator, then (LCM)
    each step's noise."""

    def __init__(self, bundle: Bundle, num_steps: int = 50,
                 guidance_scale: Optional[float] = None,
                 sampler: str = "ddim"):
        cfg = bundle.cfg
        if sampler not in ("ddim", "lcm"):
            raise ValueError(
                f"Text2Img supports sampler 'ddim' or 'lcm', got {sampler!r}"
                " (Euler-Ancestral lives in pipelines/sdxl.py's loop)")
        self.bundle = bundle
        self.sampler_kind = sampler
        self.sampler = sched_ops.make_sampler(
            cfg.scheduler, num_steps, kind=sampler,
            fast_after_steps=cfg.pipeline.fast_after_steps,
            fast_rate=cfg.pipeline.fast_rate)
        self.sched = self.sampler.ddim
        self.guidance_scale = (cfg.pipeline.guidance_scale
                               if guidance_scale is None else guidance_scale)

    def __call__(self, generator: torch.Generator, prompt,
                 negative_prompt=None, *,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``noise`` (LCM only) replaces the per-step draws."""
        b = self.bundle
        cfg = b.cfg
        context = encode_prompts(b, prompt, negative_prompt)
        batch = context.shape[0] // 2
        lat = seeded_latents(generator, batch, cfg.pipeline.latent_height,
                             cfg.pipeline.latent_width, device=b.device)
        if self.sampler_kind == "lcm":
            final = lcm_denoise(b.unet, self.sampler, lat, context[batch:],
                                generator, noise=noise)
        else:
            final, _ = denoise(
                b.unet, self.sched, lat, context, self.guidance_scale,
                deepcache_interval=cfg.pipeline.deepcache_interval)
        return decode_with(b.vae, cfg.vae.scaling_factor, final)


@torch.no_grad()
def invert(bundle: Bundle, image_latents: torch.Tensor,
           context: torch.Tensor, num_steps: int,
           guidance_scale: float = 1.0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDIM inversion of clean latents ``[B, h, w, 4]`` under ``context``
    (``[2B, L, C]``, uncond ++ cond, combined at ``guidance_scale``).
    Returns ``(noised latents, trajectory [S+1, B, h, w, 4])``, the
    trajectory's first entry the input."""
    sched = sched_ops.make_inversion_schedule(bundle.cfg.scheduler,
                                              num_steps)
    lat = image_latents.to(bundle.device, torch.float32).permute(0, 3, 1, 2)
    tables = sched_ops.device_tables(sched, lat.device)
    traj = torch.empty((num_steps + 1,) + tuple(image_latents.shape),
                       dtype=torch.float32, device=lat.device)
    context = context.to(lat.device)
    for i in range(num_steps):
        traj[i] = lat.permute(0, 2, 3, 1)
        t = tables.timesteps[i].expand(2 * lat.shape[0])
        eps = bundle.unet(torch.cat([lat, lat], dim=0), t, context)
        eps = cfg_combine(eps.float(), guidance_scale)
        lat = sched_ops.ddim_inverse_step(tables, eps, i, lat)
    final = lat.permute(0, 2, 3, 1)
    traj[num_steps] = final
    return final, traj
