"""SDXL txt2img: dual text towers, ``text_time`` micro-conditioning and a
Python loop of Euler-Ancestral/CFG steps.

Port of ``theatergen_tpu/pipelines/sdxl.py`` (``encode_prompts_xl``,
``default_time_ids``, ``denoise_xl``, ``Text2ImgXL``).  As in
``pipelines/sd.py``, latents ``[B, h, w, 4]`` and images ``[B, H, W, 3]``
are NHWC at the boundary and every random draw comes from an explicit
``torch.Generator`` (or, in tests, from injected noise).  ``Text2ImgXL``
also runs the guidance-free LCM loop (``sd.lcm_denoise``) for
LCM-LoRA-XL-merged weights, and takes a T2I-Adapter hint
(:func:`adapter_features`) where the bundle carries the adapter.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.t2i_adapter import tile_features
from ..ops import scheduler as sched_ops
from ..ops.scheduler import EulerAncestralSchedule
from . import sd
from .bundle import Bundle


@torch.no_grad()
def encode_prompts_xl(bundle: Bundle, prompts, negative_prompts=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tokenize, encode with both towers and concatenate their penultimate
    hidden states (768 + 1280 → 2048 at full size); the pooled output is
    tower 2's projected one (diffusers SDXL ``encode_prompt`` semantics).

    Returns ``(context [2B, L, C], pooled [2B, P])``, uncond rows first."""
    if bundle.text2 is None:
        raise ValueError("encode_prompts_xl: the bundle has no text2 tower")
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
    texts = list(negative_prompts) + list(prompts)
    length = bundle.cfg.text.max_length

    def ids(**kw):
        return torch.as_tensor(
            np.asarray(bundle.tokenizer(texts, max_length=length, **kw)),
            dtype=torch.long, device=bundle.device)

    _, _, pen1 = bundle.text(ids(), return_penultimate=True)
    # tower 2 (OpenCLIP bigG) pads with token 0, not the first tokenizer's
    # eos: the padded context rows feed every cross-attention
    _, pooled2, pen2 = bundle.text2(ids(pad_token_id=0),
                                    return_penultimate=True)
    return torch.cat([pen1, pen2], dim=-1), pooled2


def default_time_ids(height: int, width: int, batch: int,
                     device=None) -> torch.Tensor:
    """``(orig_h, orig_w, crop_top, crop_left, target_h, target_w)``, the
    SDXL micro-conditioning vector, full-frame: ``[batch, 6]`` fp32."""
    ids = torch.tensor([[height, width, 0, 0, height, width]],
                       dtype=torch.float32, device=device)
    return ids.expand(batch, 6)


@torch.no_grad()
def adapter_features(bundle: Bundle, hint: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """The T2I-Adapter's per-level features (NCHW, batch 1, the UNet's
    dtype) of one hint ``[H, W, 3]`` in [0, 1] (the JAX package runs the
    adapter on ``hint[None]``)."""
    if bundle.t2i_adapter is None:
        raise ValueError("a T2I-Adapter hint needs a bundle with the "
                         "adapter (init_bundle(..., with_t2i_adapter=True))")
    x = hint.to(bundle.device, torch.float32).permute(2, 0, 1)[None]
    return bundle.t2i_adapter(x)


@torch.no_grad()
def denoise_xl(unet, sched: EulerAncestralSchedule,
               generator: Optional[torch.Generator], latents: torch.Tensor,
               context: torch.Tensor, pooled: torch.Tensor,
               time_ids: torch.Tensor, guidance_scale: float, *,
               noise: Optional[torch.Tensor] = None,
               collect_trajectory: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Euler-Ancestral CFG loop.  ``latents`` is NHWC fp32, already scaled
    by ``init_noise_sigma``; ``unet(sample NCHW, t [2B], context,
    pooled_text=, time_ids=)`` gives eps.  Step i's ancestral noise is
    ``noise[i]`` (``[S, B, h, w, C]``) where given, else a unit-normal NHWC
    draw from ``generator`` on its device.  Returns ``(final,
    trajectory or None)`` as ``sd.denoise`` does.  The sigmas and
    timesteps are indexed from tables on the device."""
    s_total = sched.num_steps
    if noise is None and generator is None:
        raise ValueError("denoise_xl: pass a generator or the noise")
    sd.check_noise(noise, s_total, latents.shape)
    lat = latents.permute(0, 3, 1, 2).float()
    tables = sched_ops.ea_device_tables(sched, lat.device)
    traj = None
    if collect_trajectory:
        traj = torch.empty((s_total + 1,) + tuple(latents.shape),
                           dtype=lat.dtype, device=lat.device)
    for i in range(s_total):
        if traj is not None:
            traj[i] = lat.permute(0, 2, 3, 1)
        scaled = sched_ops.ea_scale_model_input(tables, lat, i)
        t = tables.timesteps[i].expand(2 * lat.shape[0])
        eps = unet(torch.cat([scaled, scaled], dim=0), t, context,
                   pooled_text=pooled, time_ids=time_ids)
        eps = sd.cfg_combine(eps.float(), guidance_scale)
        n = sd.step_noise(i, latents.shape, lat.device, generator, noise)
        lat = sched_ops.ea_step(tables, eps, i, lat, n)
    final = lat.permute(0, 2, 3, 1)
    if traj is not None:
        traj[s_total] = final
    return final, traj


class Text2ImgXL:
    """SDXL txt2img runner.

    >>> pipe = Text2ImgXL(bundle, num_steps=30)
    >>> img = pipe(torch.Generator("cuda").manual_seed(0), "a cat")

    ``denoising_end`` truncates the sampling loop at a fraction of the
    schedule (base/refiner-style splits); ``output_type="latent"`` then
    also returns the final latent.  With ``cfg.pipeline.scheduler_type ==
    "lcm"`` the request runs the guidance-free LCM loop on the cond rows
    (context, pooled text and time ids), for LCM-LoRA-XL-merged weights;
    ``denoising_end`` is not defined for it.  A ``hint`` ``[H, W, 3]`` in
    [0, 1] runs the bundle's T2I-Adapter once; its features go to every
    UNet evaluation as ``level_residuals``, repeated across the CFG batch
    (the LCM loop's cond-only batch takes them as they are).
    """

    def __init__(self, bundle: Bundle, num_steps: int = 30,
                 guidance_scale: Optional[float] = None,
                 denoising_end: Optional[float] = None):
        cfg = bundle.cfg
        self.bundle = bundle
        self.is_lcm = cfg.pipeline.scheduler_type == "lcm"
        if self.is_lcm:
            if denoising_end is not None:
                raise ValueError("denoising_end is a base/refiner split of "
                                 "the CFG schedule; not defined for the LCM "
                                 "sampler")
            self.sched = sched_ops.make_sampler(cfg.scheduler, num_steps,
                                                kind="lcm")
        else:
            run = (num_steps if denoising_end is None
                   else max(1, int(round(num_steps * denoising_end))))
            full = sched_ops.make_euler_ancestral_schedule(cfg.scheduler,
                                                           num_steps)
            self.sched = dataclasses.replace(
                full, timesteps=full.timesteps[:run],
                sigmas=full.sigmas[:run + 1])
        self.guidance_scale = (cfg.pipeline.guidance_scale
                               if guidance_scale is None else guidance_scale)

    def __call__(self, generator: torch.Generator, prompt,
                 negative_prompt=None, hint=None,
                 output_type: str = "image", *,
                 noise: Optional[torch.Tensor] = None):
        """``noise`` replaces the per-step draws (``[S, B, h, w, 4]``)."""
        if output_type not in ("image", "latent"):
            raise ValueError(f"output_type must be 'image' or 'latent', got "
                             f"{output_type!r}")
        b = self.bundle
        cfg = b.cfg
        context, pooled = encode_prompts_xl(b, prompt, negative_prompt)
        batch = context.shape[0] // 2
        feats = None if hint is None else adapter_features(b, hint)
        lat = sd.seeded_latents(generator, batch,
                                cfg.pipeline.latent_height,
                                cfg.pipeline.latent_width, device=b.device)
        lat = lat * self.sched.init_noise_sigma
        time_ids = default_time_ids(cfg.pipeline.height, cfg.pipeline.width,
                                    context.shape[0], device=b.device)
        if self.is_lcm:
            # CFG is distilled into LCM(-LoRA) weights: the cond rows only
            pooled_c, tids_c = pooled[batch:], time_ids[batch:]
            res = None if feats is None else tile_features(feats, batch)
            final = sd.lcm_denoise(
                lambda x, t, c: b.unet(x, t, c, pooled_text=pooled_c,
                                       time_ids=tids_c, level_residuals=res),
                self.sched, lat, context[batch:], generator, noise=noise)
        else:
            res = None if feats is None else tile_features(feats, 2 * batch)
            final, _ = denoise_xl(
                lambda x, t, c, **kw: b.unet(x, t, c, level_residuals=res,
                                             **kw),
                self.sched, generator, lat, context, pooled, time_ids,
                self.guidance_scale, noise=noise)
        img = sd.decode_with(b.vae, cfg.vae.scaling_factor, final)
        if output_type == "latent":
            return img, final
        return img
