"""Core txt2img pipeline: CFG over a Python loop of DDIM steps.

Port of ``theatergen_tpu/pipelines/sd.py`` (DDIM only).  The functions keep
the JAX package's NHWC layout at their boundary (latents ``[B, h, w, 4]``,
images ``[B, H, W, 3]`` in [0, 1]); the modules run NCHW inside.  Every
random draw takes an explicit ``torch.Generator``.
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


@torch.no_grad()
def denoise(unet, sched: DDIMSchedule, latents: torch.Tensor,
            context: torch.Tensor, guidance_scale: float, *,
            collect_trajectory: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the DDIM/CFG loop.  ``unet(sample NCHW, t [2B], context)`` gives
    eps; ``latents`` is NHWC fp32.  Returns ``(final, trajectory or None)``,
    where ``trajectory[s]`` is the latent entering step s and the last entry
    the final latent (``[S+1, B, h, w, C]``, preallocated).  The timesteps
    and alphas are indexed from tables on the device: no host copy per
    step."""
    s_total = sched.num_steps
    lat = latents.permute(0, 3, 1, 2).float()
    tables = sched_ops.device_tables(sched, lat.device)
    traj = None
    if collect_trajectory:
        traj = torch.empty((s_total + 1,) + tuple(latents.shape),
                           dtype=lat.dtype, device=lat.device)
    for i in range(s_total):
        if traj is not None:
            traj[i] = lat.permute(0, 2, 3, 1)
        t = tables.timesteps[i].expand(2 * lat.shape[0])
        eps = unet(torch.cat([lat, lat], dim=0), t, context)
        eps = cfg_combine(eps.float(), guidance_scale)
        lat = sched_ops.ddim_step(tables, eps, i, lat)
    final = lat.permute(0, 2, 3, 1)
    if traj is not None:
        traj[s_total] = final
    return final, traj


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
    """

    def __init__(self, bundle: Bundle, num_steps: int = 50,
                 guidance_scale: Optional[float] = None):
        cfg = bundle.cfg
        if cfg.pipeline.scheduler_type != "ddim":
            raise NotImplementedError(
                f"scheduler {cfg.pipeline.scheduler_type!r} is not ported yet")
        self.bundle = bundle
        self.sched = sched_ops.make_schedule(
            cfg.scheduler, num_steps,
            fast_after_steps=cfg.pipeline.fast_after_steps,
            fast_rate=cfg.pipeline.fast_rate)
        self.guidance_scale = (cfg.pipeline.guidance_scale
                               if guidance_scale is None else guidance_scale)

    def __call__(self, generator: torch.Generator, prompt,
                 negative_prompt=None) -> torch.Tensor:
        b = self.bundle
        cfg = b.cfg
        context = encode_prompts(b, prompt, negative_prompt)
        lat = seeded_latents(generator, context.shape[0] // 2,
                             cfg.pipeline.latent_height,
                             cfg.pipeline.latent_width, device=b.device)
        final, _ = denoise(b.unet, self.sched, lat, context,
                           self.guidance_scale)
        return decode_with(b.vae, cfg.vae.scaling_factor, final)
