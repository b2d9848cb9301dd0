"""Latent guidance: energy descent on the latents by ``torch.autograd``.

The port of ``theatergen_tpu/pipelines/guidance.py`` (the reference's
``latent_backward_guidance``, ``models/pipelines.py:62-128``): at a
guided step a cond-only UNet forward captures the cross-attention maps at
the guidance keys, :func:`..ops.guidance.compute_ca_loss` scores them,
the gradient with respect to the latents comes from
``torch.autograd.grad``, and the latents descend by the sampler's
guidance scale (``sqrt(1 - alpha)`` for DDIM).  The iterate-until-
threshold loop, the JAX package's ``lax.while_loop``, is a Python loop
that reads the loss on the host once per iteration, with the reference's
per-step ``max_iter`` schedule (``theatergen.py:296,300``).  Through the
port's kernels the gradient flows by their ``torch.autograd.Function``s
(``ops/recompute.py``); the modules' parameters need no gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..config import GuidanceConfig
from ..ops import guidance as guidance_ops


@dataclasses.dataclass(frozen=True)
class GuidanceInputs:
    """The guidance problem of one run, padded to ``max_objects`` slots
    (``obj_valid`` masks the padding)."""

    boxes: torch.Tensor          # [K, 4] fp32, normalised
    token_pos: torch.Tensor      # [K, P] int64
    token_valid: torch.Tensor    # [K, P] bool
    obj_valid: torch.Tensor      # [K] bool
    word_token: torch.Tensor     # [K] int64
    # per key, the reference maps of the attention-transfer loss: [K,
    # heads, HW] (step-aggregated) or [S, K, heads, HW] (per step: the
    # reference matches the saved attention of the same step,
    # utils/guidance.py:220-233; guidance_update selects the step)
    ref_attn_maps: Optional[Tuple[torch.Tensor, ...]] = None

    def to(self, device) -> "GuidanceInputs":
        """The same inputs on ``device``."""
        refs = self.ref_attn_maps
        return GuidanceInputs(
            self.boxes.to(device), self.token_pos.to(device),
            self.token_valid.to(device), self.obj_valid.to(device),
            self.word_token.to(device),
            None if refs is None else tuple(m.to(device) for m in refs))


def make_energy_fn(unet_capture_apply: Callable[..., dict],
                   gcfg: GuidanceConfig, text_len: int, latent_hw=None):
    """``energy(latents, t, cond_context, gin) -> loss`` (0-dim fp32).
    ``unet_capture_apply(latents, t, context)`` runs the UNet cond-only
    with ``capture_keys=gcfg.attn_keys`` and returns the captured
    probabilities, ``{key: [1, heads, HW, Lk]}``."""

    def energy(latents, t, cond_context, gin: GuidanceInputs):
        captured = unet_capture_apply(latents, t, cond_context)
        maps = guidance_ops.attn_collection_to_maps(
            captured, gcfg.attn_keys, cond_batch_index=0, text_len=text_len)
        return guidance_ops.compute_ca_loss(
            maps, gin.boxes, gin.token_pos, gin.token_valid, gin.obj_valid,
            ref_attn_maps=(list(gin.ref_attn_maps)
                           if gin.ref_attn_maps is not None else None),
            word_token=gin.word_token,
            fg_top_p=gcfg.fg_top_p, bg_top_p=gcfg.bg_top_p,
            fg_weight=gcfg.fg_weight, bg_weight=gcfg.bg_weight,
            ref_ca_loss_weight=gcfg.ref_ca_loss_weight, latent_hw=latent_hw)

    return energy


def unet_energy_fn(unet, cfg, **unet_kwargs):
    """:func:`make_energy_fn` over a cond-only forward of ``unet`` with
    capture at ``cfg.guidance.attn_keys`` and ``unet_kwargs`` (IP scale,
    SDXL's ``extra_cond`` rows, level residuals), the maps read on the
    latent grid of ``cfg.pipeline``: the runners' energy, as the JAX
    runners' ``unet_apply(..., capture=True)``."""
    gcfg = cfg.guidance

    def capture(x, t, ctx):
        return unet(x, t.expand(x.shape[0]), ctx,
                    capture_keys=gcfg.attn_keys, **unet_kwargs)[1]

    return make_energy_fn(capture, gcfg, cfg.text.max_length,
                          (cfg.pipeline.latent_height,
                           cfg.pipeline.latent_width))


def guidance_update(energy_fn, sched, gcfg: GuidanceConfig,
                    latents: torch.Tensor, step_index: int,
                    cond_context: torch.Tensor, gin: GuidanceInputs,
                    prev_loss: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Iterated energy descent at one step (the reference's loop,
    ``models/pipelines.py:96-124``): while ``loss > loss_threshold ·
    loss_scale`` and fewer than ``max_iter[step]`` iterations ran, one
    gradient step of the scaled energy, scaled by
    ``sched.guidance_step_scale``.  ``sched`` is a runner's
    ``DeviceSampler``; ``latents`` go to ``energy_fn`` as they are (the
    runners' NCHW), after the sampler's ``scale_model_input``.
    ``prev_loss`` is the previous step's loss (+inf at first), threaded
    across steps as the reference threads it, so guidance that has
    converged below the threshold stays off.

    Returns ``(latents, loss, iterations)``: the descended latents (fp32,
    no graph), the last scaled loss (0-dim fp32) and the iteration count
    that the host loop ran."""
    t = sched.timesteps[step_index]
    if gin.ref_attn_maps is not None and any(
            m.ndim == 4 for m in gin.ref_attn_maps):
        # per-step reference maps: this step's (clipped, for a reference
        # trajectory shorter than this pass's schedule)
        gin = dataclasses.replace(gin, ref_attn_maps=tuple(
            m[min(max(step_index, 0), m.shape[0] - 1)] if m.ndim == 4 else m
            for m in gin.ref_attn_maps))
    scale = sched.guidance_step_scale(step_index)
    max_it = gcfg.max_iter[min(max(step_index, 0), len(gcfg.max_iter) - 1)]
    threshold = gcfg.loss_threshold * gcfg.loss_scale
    loss = (torch.full((), float("inf"), device=latents.device)
            if prev_loss is None else prev_loss.float())
    lat = latents
    it = 0
    while it < max_it and bool(loss > threshold):
        leaf = lat.detach().requires_grad_(True)
        with torch.enable_grad():
            # the UNet takes scheduler-scaled inputs (identity for DDIM),
            # as the reference's guidance forward does
            # (models/pipelines.py:87-90)
            scaled = sched.scale_model_input(leaf, step_index)
            e = energy_fn(scaled, t, cond_context, gin) * gcfg.loss_scale
        (grad,) = torch.autograd.grad(e, leaf)
        lat = lat - scale * grad
        loss = e.detach()
        it += 1
    return lat, loss, it
