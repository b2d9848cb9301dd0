"""The final composed-scene pass: ControlNet, the IP UNet and frozen-latent
replacement.

Port of ``theatergen_tpu/pipelines/final.py::make_final_pipeline``.  It
starts from the composed trajectory's t = T slot.  Each step runs:

- the ControlNet on the lineart hint with the text-only context, inside
  the ``control_guidance_start``/``end`` window;
- its residuals into the IP UNet (``ip_scale`` 0.1 in a turn), CFG and
  the sampler's step (DDIM, Euler-Ancestral or LCM); on an SDXL bundle
  the UNet also takes the micro-conditioning (``extra_cond``) and, where
  the turn conditions on the T2I-Adapter in place of the ControlNet, the
  adapter's features (``adapter_feats``) as level residuals;
- for steps ``i < frozen_steps``, the masked region replaced by the
  composed trajectory's next latent:
  ``latents_all[i+1]·fm + nxt·(1−fm)``.

The JAX package's knobs: CFG cutoff (cond-only steps after it, the
ControlNet at batch 1 too), DeepCache on the UNet (the ControlNet still
runs every step; a shallow forward uses only its shallow residuals), the
ControlNet interval (its forward on every N-th step, the residuals reused
in between) and LCM's cond-only steps.

``frozen_steps`` and ``ip_scale`` become tensors on the device once per
run, and the sampler's tables are indexed on the device, so a step copies
nothing from the host.  The window is fixed by the step index alone, so
it is decided on the host.  The JAX package multiplies the residuals by
the window's 0/1 factor; the port skips them where it is 0, and skips the
ControlNet forward where no step that would use its residuals lies in the
window: adding zero changes nothing.  The hint is embedded once per run,
not once per step.

With ``guided``, each step ``i < guidance_steps`` first descends the
latents on the guidance energy (``pipelines/guidance.py``): the overall
layout's boxes and, per character, attention transfer from its reference
maps, through a full cond-only UNet forward without the ControlNet's
residuals (the JAX package's ``unet_apply(..., capture=True)``).
NHWC at the boundary, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.t2i_adapter import tile_features
from ..ops import scheduler as sched_ops
from . import guidance as guidance_lib
from .bundle import Bundle
from .character import trailing_rows
from .sd import cfg_combine, check_noise, step_noise


def control_window(num_steps: int, start: float, end: float) -> list:
    """Per step, whether the ControlNet conditions it: the step's fraction
    ``i / max(S-1, 1)`` within [start, end], compared in fp32 as in the
    JAX package."""
    denom = np.float32(max(num_steps - 1, 1))
    return [bool(np.float32(start) <= np.float32(i) / denom <= np.float32(end))
            for i in range(num_steps)]


def make_final_pipeline(bundle: Bundle, num_steps: int, *,
                        use_ip: bool = True, use_controlnet: bool = True,
                        guided: bool = False,
                        guidance_scale: Optional[float] = None,
                        controlnet_scale: float = 1.0,
                        control_guidance_start: float = 0.0,
                        control_guidance_end: float = 1.0,
                        cfg_cutoff_fraction: Optional[float] = None,
                        deepcache_interval: Optional[int] = None,
                        controlnet_interval: Optional[int] = None):
    """Build the final-pass runner; returns ``(run, sampler)``.

    ``run(latents_all [S+1, 1, h, w, 4], frozen_mask [h, w], frozen_steps,
    context [2, L(+n), C], cn_context [2, L, C], cond_image [H, W, 3],
    ip_scale, generator=None, *, noise=None, extra_cond=None,
    adapter_feats=None, gin=None) -> (final [1, h, w, 4], trajectory [S+1,
    1, h, w, 4])``.  ``frozen_steps`` and ``ip_scale`` are numbers or 0-dim
    tensors; ``context`` carries the IP tokens where ``use_ip``;
    ``cond_image`` is the hint in [0, 1].  An Euler-Ancestral
    or LCM step draws its noise from ``generator`` unless ``noise`` (``[S,
    1, h, w, 4]``) is injected.  ``extra_cond`` (SDXL's pooled text and
    time ids, ``[2, ...]`` each, uncond row first) and ``adapter_feats``
    (the T2I-Adapter's per-level features of the hint, batch 1) go to
    every UNet evaluation, the features repeated across the CFG batch; a
    cond-only evaluation takes ``extra_cond``'s trailing rows and the
    features as they are.  The ControlNet takes neither.

    ``cfg_cutoff_fraction`` and ``deepcache_interval`` as in
    ``character.make_character_pipeline``; at the cutoff the DeepCache
    cache and (where the cutoff is past step 0) the ControlNet cache keep
    their cond rows.  ``controlnet_interval``: the ControlNet forward on
    every N-th step, its residuals reused until the next; the window's
    factor applies per step, outside the cache.

    ``guided``: before each step ``i < cfg.guidance.guidance_steps``, the
    guidance update of the latents on the energy of ``gin`` (required
    then), through a full cond-only UNet forward on ``context[1:2]`` with
    the adapter's features but no ControlNet residuals, its loss threaded
    from step to step; the frozen-mask replacement follows the step."""
    cfg = bundle.cfg
    gcfg = cfg.guidance
    unet = bundle.unet_ip if use_ip else bundle.unet
    if unet is None:
        raise ValueError("make_final_pipeline: use_ip needs a bundle with "
                         "the IP UNet (init_bundle(..., with_ip=True))")
    controlnet = bundle.controlnet if use_controlnet else None
    if use_controlnet and controlnet is None:
        raise ValueError("make_final_pipeline: use_controlnet needs a bundle "
                         "with the ControlNet (init_bundle(..., "
                         "with_controlnet=True))")
    sampler = sched_ops.make_sampler(
        cfg.scheduler, num_steps, kind=cfg.pipeline.scheduler_type,
        fast_after_steps=cfg.pipeline.fast_after_steps,
        fast_rate=cfg.pipeline.fast_rate)
    gs = cfg.pipeline.guidance_scale if guidance_scale is None \
        else guidance_scale
    s_total = sampler.num_steps
    window = control_window(s_total, control_guidance_start,
                            control_guidance_end)
    cutoff = (0 if sampler.kind == "lcm" else
              sched_ops.cfg_cutoff_steps(s_total, cfg_cutoff_fraction))
    dc = deepcache_interval if deepcache_interval and \
        deepcache_interval > 1 else None
    cn_every = controlnet_interval if controlnet_interval and \
        controlnet_interval > 1 else 1
    # ControlNet forwards: step i runs it where its residuals serve some
    # step of i's span (the steps up to the next forward) inside the window
    cn_runs = [controlnet is not None and i % cn_every == 0
               and any(window[i:i + cn_every]) for i in range(s_total)]

    @torch.no_grad()
    def run(latents_all: torch.Tensor, frozen_mask: torch.Tensor,
            frozen_steps, context: torch.Tensor, cn_context: torch.Tensor,
            cond_image: torch.Tensor, ip_scale=0.1,
            generator: Optional[torch.Generator] = None, *,
            noise: Optional[torch.Tensor] = None,
            extra_cond: Optional[dict] = None,
            adapter_feats: Optional[tuple] = None,
            gin: Optional[guidance_lib.GuidanceInputs] = None):
        dev = bundle.device
        steps = sampler.on(dev)
        check_noise(noise, s_total, latents_all.shape[1:])
        frozen = torch.as_tensor(frozen_steps, dtype=torch.long, device=dev)
        kwargs = {}
        if use_ip:
            kwargs["ip_scale"] = torch.as_tensor(ip_scale, dtype=torch.float32,
                                                 device=dev)
        # NCHW views of the composed trajectory; the mask as [1, 1, h, w]
        comp = latents_all.to(dev, torch.float32).permute(0, 1, 4, 2, 3)
        fm = torch.clamp(frozen_mask.to(dev, torch.float32), 0.0, 1.0)
        fm = fm[None, None]
        context, cn_context = context.to(dev), cn_context.to(dev)
        cond_embed = None
        if any(cn_runs):
            cond = cond_image.to(dev, torch.float32).permute(2, 0, 1)[None]
            cond_embed = controlnet.embed_hint(cond)
        lat = comp[0]
        b = lat.shape[0]
        cond_cfg, cond_1 = trailing_rows(extra_cond, dev, 2 * b, b)
        lev_cfg = lev_1 = None
        if adapter_feats is not None:
            feats = tuple(f.to(dev) for f in adapter_feats)
            lev_cfg, lev_1 = (tile_features(feats, 2 * b),
                              tile_features(feats, b))
        energy = None
        if guided:
            if gin is None:
                raise ValueError("a guided final run needs gin "
                                 "(GuidanceInputs)")
            gin = gin.to(dev)
            # no ControlNet residuals, as the JAX energy's forward
            energy = guidance_lib.unet_energy_fn(
                unet, cfg, **cond_1, level_residuals=lev_1, **kwargs)
        gloss = None
        traj = torch.empty((s_total + 1,) + tuple(latents_all.shape[1:]),
                           dtype=torch.float32, device=dev)
        cache = cn_cache = None
        for i in range(s_total):
            if energy is not None and i < gcfg.guidance_steps:
                lat, gloss, _ = guidance_lib.guidance_update(
                    energy, steps, gcfg, lat, i, context[b:], gin,
                    prev_loss=gloss)
            traj[i] = lat.permute(0, 2, 3, 1)
            cfg_on = i < cutoff
            if i == cutoff:
                if cache is not None:
                    cache = cache[b:]
                if cn_cache is not None:
                    cn_cache = (tuple(r[b:] for r in cn_cache[0]),
                                cn_cache[1][b:])
            scaled = steps.scale_model_input(lat, i)
            if cfg_on:
                x_in, ctx, cn_ctx = (torch.cat([scaled, scaled]), context,
                                     cn_context)
                xc = dict(cond_cfg, level_residuals=lev_cfg)
            else:
                x_in, ctx, cn_ctx = scaled, context[b:], cn_context[b:]
                xc = dict(cond_1, level_residuals=lev_1)
            t = steps.timesteps[i].expand(x_in.shape[0])
            if cn_runs[i]:
                cn_cache = controlnet(x_in, t, cn_ctx,
                                      conditioning_scale=controlnet_scale,
                                      cond_embed=cond_embed)
            elif i % cn_every == 0:
                cn_cache = None
            res = dict(xc)
            if cn_cache is not None and window[i]:
                res.update(down_residuals=cn_cache[0],
                           mid_residual=cn_cache[1])
            if dc and i % dc:
                eps = unet(x_in, t, ctx, deep_cache=cache, **kwargs, **res)
            elif dc:
                eps, cache = unet(x_in, t, ctx, return_deep_cache=True,
                                  **kwargs, **res)
            else:
                eps = unet(x_in, t, ctx, **kwargs, **res)
            eps = eps.float()
            if cfg_on:
                eps = cfg_combine(eps, gs)
            n = (step_noise(i, latents_all.shape[1:], dev, generator, noise)
                 if sampler.draws(i) else None)
            nxt = steps.step(eps, i, lat, n)
            lat = torch.where(frozen > i, comp[i + 1] * fm + nxt * (1.0 - fm),
                              nxt)
        final = lat.permute(0, 2, 3, 1)
        traj[s_total] = final
        return final, traj

    return run, sampler
