"""The final composed-scene pass: ControlNet, the IP UNet and frozen-latent
replacement.

Port of ``theatergen_tpu/pipelines/final.py::make_final_pipeline`` on its
default path (SD1.5, DDIM, CFG, guidance off).  It starts from the
composed trajectory's t = T slot.  Each step runs:

- the ControlNet on the lineart hint with the text-only context, inside
  the ``control_guidance_start``/``end`` window;
- its residuals into the IP UNet (``ip_scale`` 0.1 in a turn), CFG and
  the DDIM step;
- for steps ``i < frozen_steps``, the masked region replaced by the
  composed trajectory's next latent:
  ``latents_all[i+1]·fm + nxt·(1−fm)``.

``frozen_steps`` and ``ip_scale`` become tensors on the device once per
run, and the DDIM tables are indexed on the device, so a step copies
nothing from the host.  The window is fixed by the step index alone, so
it is decided on the host.  A step outside it skips the ControlNet: its
residuals there are zero in the JAX package, and adding zero changes
nothing.  The hint is embedded once per run, not once per step.

Latent guidance, CFG cutoff, DeepCache, the ControlNet interval, LCM and
the SDXL inputs (``extra_cond``, ``adapter_feats``) are later slices and
raise ``NotImplementedError``.  NHWC at the boundary, as in the JAX
package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import scheduler as sched_ops
from .bundle import Bundle
from .sd import cfg_combine


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
    """Build the final-pass runner; returns ``(run, sched)``.

    ``run(latents_all [S+1, 1, h, w, 4], frozen_mask [h, w], frozen_steps,
    context [2, L(+n), C], cn_context [2, L, C], cond_image [H, W, 3],
    ip_scale) -> (final [1, h, w, 4], trajectory [S+1, 1, h, w, 4])``.
    ``frozen_steps`` and ``ip_scale`` are numbers or 0-dim tensors;
    ``context`` carries the IP tokens where ``use_ip``; ``cond_image`` is
    the hint in [0, 1]."""
    cfg = bundle.cfg
    if guided:
        raise NotImplementedError("latent guidance is not ported yet")
    if cfg_cutoff_fraction is not None and cfg_cutoff_fraction < 1.0:
        raise NotImplementedError("CFG cutoff is not ported yet")
    if deepcache_interval is not None and deepcache_interval > 1:
        raise NotImplementedError("DeepCache is not ported yet")
    if controlnet_interval is not None and controlnet_interval > 1:
        raise NotImplementedError("the ControlNet interval is not ported yet")
    if cfg.unet.addition_embed_type is not None or bundle.text2 is not None:
        raise NotImplementedError("the SDXL final pass is not ported yet")
    if cfg.pipeline.scheduler_type != "ddim":
        raise NotImplementedError(
            f"scheduler {cfg.pipeline.scheduler_type!r} is not ported for "
            f"the final pass")
    unet = bundle.unet_ip if use_ip else bundle.unet
    if unet is None:
        raise ValueError("make_final_pipeline: use_ip needs a bundle with "
                         "the IP UNet (init_bundle(..., with_ip=True))")
    controlnet = bundle.controlnet if use_controlnet else None
    if use_controlnet and controlnet is None:
        raise ValueError("make_final_pipeline: use_controlnet needs a bundle "
                         "with the ControlNet (init_bundle(..., "
                         "with_controlnet=True))")
    sched = sched_ops.make_schedule(
        cfg.scheduler, num_steps,
        fast_after_steps=cfg.pipeline.fast_after_steps,
        fast_rate=cfg.pipeline.fast_rate)
    gs = cfg.pipeline.guidance_scale if guidance_scale is None \
        else guidance_scale
    s_total = sched.num_steps
    window = control_window(s_total, control_guidance_start,
                            control_guidance_end)

    @torch.no_grad()
    def run(latents_all: torch.Tensor, frozen_mask: torch.Tensor,
            frozen_steps, context: torch.Tensor, cn_context: torch.Tensor,
            cond_image: torch.Tensor, ip_scale=0.1, *,
            extra_cond: Optional[dict] = None,
            adapter_feats: Optional[tuple] = None):
        if extra_cond is not None or adapter_feats is not None:
            raise NotImplementedError(
                "extra_cond and adapter_feats (SDXL) are not ported yet")
        dev = bundle.device
        tables = sched_ops.device_tables(sched, dev)
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
        if controlnet is not None and any(window):
            cond = cond_image.to(dev, torch.float32).permute(2, 0, 1)[None]
            cond_embed = controlnet.embed_hint(cond)
        lat = comp[0]
        traj = torch.empty((s_total + 1,) + tuple(latents_all.shape[1:]),
                           dtype=torch.float32, device=dev)
        for i in range(s_total):
            traj[i] = lat.permute(0, 2, 3, 1)
            t = tables.timesteps[i].expand(2 * lat.shape[0])
            lat_in = torch.cat([lat, lat], dim=0)
            res = {}
            if cond_embed is not None and window[i]:
                down, mid = controlnet(lat_in, t, cn_context,
                                       conditioning_scale=controlnet_scale,
                                       cond_embed=cond_embed)
                res = dict(down_residuals=down, mid_residual=mid)
            eps = unet(lat_in, t, context, **kwargs, **res)
            eps = cfg_combine(eps.float(), gs)
            nxt = sched_ops.ddim_step(tables, eps, i, lat)
            lat = torch.where(frozen > i, comp[i + 1] * fm + nxt * (1.0 - fm),
                              nxt)
        final = lat.permute(0, 2, 3, 1)
        traj[s_total] = final
        return final, traj

    return run, sched
