"""Latent guidance: energy descent on the latents by ``torch.autograd``.

The port of ``theatergen_tpu/pipelines/guidance.py`` (the reference's
``latent_backward_guidance``, ``models/pipelines.py:62-128``): at a
guided step a cond-only UNet forward captures the cross-attention maps at
the guidance keys, :func:`..ops.guidance.compute_ca_loss` scores them,
the gradient with respect to the latents comes from
``torch.autograd.grad``, and the latents descend by the sampler's
guidance scale (``sqrt(1 - alpha)`` for DDIM).  The iterate-until-
threshold loop, the JAX package's ``lax.while_loop``, is a Python loop
that reads the active mask on the host once per iteration, with the
reference's per-step ``max_iter`` schedule (``theatergen.py:296,300``).  Through the
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
        return self._map(lambda x: x.to(device))

    @property
    def batched(self) -> bool:
        """Whether these are B problems with a leading batch axis
        (:func:`stack_inputs`)."""
        return self.boxes.ndim == 3

    def element(self, b: int) -> "GuidanceInputs":
        """Problem ``b`` of batched inputs."""
        return self._map(lambda x: x[b])

    def _map(self, fn) -> "GuidanceInputs":
        refs = self.ref_attn_maps
        return GuidanceInputs(
            fn(self.boxes), fn(self.token_pos), fn(self.token_valid),
            fn(self.obj_valid), fn(self.word_token),
            None if refs is None else tuple(fn(m) for m in refs))


def stack_inputs(gins) -> GuidanceInputs:
    """B problems stacked on a leading axis, for the batched runners (the
    JAX package's ``tree.map(stack)``); their reference maps, where given,
    must share their shapes."""
    refs = [g.ref_attn_maps for g in gins]
    stacked = None
    if refs[0] is not None:
        stacked = tuple(torch.stack(ms) for ms in zip(*refs))
    return GuidanceInputs(
        *(torch.stack([getattr(g, f) for g in gins])
          for f in ("boxes", "token_pos", "token_valid", "obj_valid",
                    "word_token")), stacked)


def make_energy_fn(unet_capture_apply: Callable[..., dict],
                   gcfg: GuidanceConfig, text_len: int, latent_hw=None):
    """``energy(latents, t, cond_context, gin) -> loss [B]`` (fp32).
    ``unet_capture_apply(latents, t, context)`` runs the UNet cond-only
    with ``capture_keys=gcfg.attn_keys`` and returns the captured
    probabilities, ``{key: [B, heads, HW, Lk]}``.  ``gin`` holds B
    problems on a leading axis (:func:`stack_inputs`), one per latent row;
    element b's energy comes from its own row's maps (the JAX package's
    ``vmap``).  No layer mixes the batch, so the gradient of the sum is
    each element's own."""

    def one(captured, b: int, gin: GuidanceInputs):
        maps = guidance_ops.attn_collection_to_maps(
            captured, gcfg.attn_keys, cond_batch_index=b, text_len=text_len)
        return guidance_ops.compute_ca_loss(
            maps, gin.boxes, gin.token_pos, gin.token_valid, gin.obj_valid,
            ref_attn_maps=(list(gin.ref_attn_maps)
                           if gin.ref_attn_maps is not None else None),
            word_token=gin.word_token,
            fg_top_p=gcfg.fg_top_p, bg_top_p=gcfg.bg_top_p,
            fg_weight=gcfg.fg_weight, bg_weight=gcfg.bg_weight,
            ref_ca_loss_weight=gcfg.ref_ca_loss_weight, latent_hw=latent_hw)

    def energy(latents, t, cond_context, gin: GuidanceInputs):
        if not gin.batched:
            raise ValueError("the energy takes batched GuidanceInputs "
                             "(stack_inputs)")
        captured = unet_capture_apply(latents, t, cond_context)
        return torch.stack([one(captured, b, gin.element(b))
                            for b in range(gin.boxes.shape[0])])

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
                    prev_loss: Optional[torch.Tensor] = None):
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
    no graph), the last scaled loss and the iteration count.  ``gin``
    holds B problems (one per latent row, :func:`stack_inputs`) or one
    unbatched problem; with B, each element keeps its own loss ``[B]`` and
    count (a list), and an iteration steps only the elements whose
    condition still holds, as the JAX package's ``vmap`` of its
    ``while_loop`` leaves finished elements as they are.  Unbatched, the
    loss is 0-dim and the count an int.  The host reads one value per
    iteration: the active mask."""
    single = not gin.batched
    if single:
        gin = stack_inputs([gin])
        if prev_loss is not None:
            prev_loss = prev_loss.reshape(1)
    t = sched.timesteps[step_index]
    if gin.ref_attn_maps is not None and any(
            m.ndim == 5 for m in gin.ref_attn_maps):
        # per-step reference maps [B, S, K, heads, HW]: this step's
        # (clipped, for a reference trajectory shorter than this pass's
        # schedule)
        gin = dataclasses.replace(gin, ref_attn_maps=tuple(
            m.select(1, min(max(step_index, 0), m.shape[1] - 1))
            if m.ndim == 5 else m for m in gin.ref_attn_maps))
    scale = sched.guidance_step_scale(step_index)
    max_it = gcfg.max_iter[min(max(step_index, 0), len(gcfg.max_iter) - 1)]
    threshold = gcfg.loss_threshold * gcfg.loss_scale

    def descend(lat):
        leaf = lat.detach().requires_grad_(True)
        with torch.enable_grad():
            # the UNet takes scheduler-scaled inputs (identity for DDIM),
            # as the reference's guidance forward does
            # (models/pipelines.py:87-90)
            scaled = sched.scale_model_input(leaf, step_index)
            e = energy_fn(scaled, t, cond_context, gin) * gcfg.loss_scale
            total = e.sum()
        (grad,) = torch.autograd.grad(total, leaf)
        return lat - scale * grad, e.detach()

    b = latents.shape[0]
    loss = (torch.full((b,), float("inf"), device=latents.device)
            if prev_loss is None else prev_loss.float())
    lat, its = latents, [0] * b
    while True:
        active = [a and n < max_it for a, n in
                  zip((loss > threshold).tolist(), its)]
        if not any(active):
            return (lat, loss[0], its[0]) if single else (lat, loss, its)
        mask = torch.tensor(active, device=lat.device)
        stepped, e = descend(lat)
        lat = torch.where(mask[:, None, None, None], stepped, lat)
        loss = torch.where(mask, e, loss)
        its = [n + a for n, a in zip(its, active)]
