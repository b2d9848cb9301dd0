"""Batched character and final passes: the port of
``theatergen_tpu/parallel/driver.py`` on one device.

The reference is strictly serial (``theatergen.py:396-407``,
``generate.py:180-269``), but a turn's characters are independent, and so
are the turns of different dialogues at one turn index.  The JAX package
``vmap``s its batch-1 runners over such a batch and shards the batch over
a mesh's ``dp`` axis.  Here the batch runs through one loop at batch B
(``character.make_batched_character_pipeline``,
``final.make_batched_final_pipeline``): every UNet evaluation at 2B rows
under CFG, per element its own context, IP scale, noise stream and
guidance problem.

The runners keep the JAX signatures, less what PyTorch carries elsewhere:
the modules hold their parameters, so no parameter trees; a list of
``torch.Generator``s, one per element, replaces the batched PRNG keys
(``fold_in_batch`` is ``jax.random``'s and is not ported); and the
character runner takes each element's word token, which JAX reads from
``gins.word_token[:, 0]``, where no guidance inputs are given.  Meshes,
``mesh=``, raise until the multi-card half of ROADMAP §1 item 5 lands.
"""

from __future__ import annotations

from ..pipelines.bundle import Bundle
from ..pipelines.character import make_batched_character_pipeline
from ..pipelines.final import make_batched_final_pipeline


def refuse_mesh(mesh) -> None:
    """Raise for a device mesh: one device only, for now."""
    if mesh is not None:
        raise NotImplementedError(
            "device meshes are not ported yet: the port batches on one "
            "device (ROADMAP §1 item 5)")


def make_dp_character_runner(bundle: Bundle, num_steps: int, mesh=None, *,
                             use_ip: bool = True, guided: bool = False,
                             capture_ref_attn: bool = False,
                             cfg_cutoff_fraction=None,
                             deepcache_interval=None,
                             with_extra_cond: bool = False):
    """Returns ``(run, sampler)``: ``run(latents [B, 1, h, w, 4], contexts
    [B, 2, L, C], ip_scales [B], gins, generators=None, extra_conds=None,
    *, word_tokens=None, noise=None) -> CharacterResult`` with leading axis
    B (``latents [B, 1, h, w, 4]``, ``trajectory [B, S+1, 1, h, w, 4]``,
    per key ``ref_attn [B, S, heads, HW]``).

    ``gins`` is a batched ``GuidanceInputs`` (required where ``guided``)
    or None; each element's maps are captured at ``gins.word_token[b, 0]``,
    or at ``word_tokens[b]`` (0 where neither is given).  ``generators``:
    one per element, for the samplers that draw each step; ``noise``
    (``[S, B, h, w, 4]``) replaces them.  ``extra_conds`` (with
    ``with_extra_cond``, required then) holds SDXL's ``[B, 2, ...]``
    pooled text and time ids."""
    refuse_mesh(mesh)
    run_b, sampler = make_batched_character_pipeline(
        bundle, num_steps, use_ip=use_ip, guided=guided,
        capture_ref_attn=capture_ref_attn,
        cfg_cutoff_fraction=cfg_cutoff_fraction,
        deepcache_interval=deepcache_interval)

    def run(latents, contexts, ip_scales, gins, generators=None,
            extra_conds=None, *, word_tokens=None, noise=None):
        if with_extra_cond and extra_conds is None:
            raise ValueError("this runner takes extra_conds (SDXL's pooled "
                             "text and time ids)")
        b = latents.shape[0]
        if word_tokens is None:
            word_tokens = ([0] * b if gins is None
                           else gins.word_token[:, 0].tolist())
        return run_b(latents[:, 0], contexts, ip_scales, word_tokens,
                     generators, noise=noise, extra_conds=extra_conds,
                     gins=gins)

    return run, sampler


def make_dp_final_runner(bundle: Bundle, num_steps: int, mesh=None, *,
                         use_ip: bool = True, use_controlnet: bool = True,
                         guided: bool = True, cfg_cutoff_fraction=None,
                         deepcache_interval=None, controlnet_interval=None,
                         with_extra_cond: bool = False,
                         with_adapter: bool = False):
    """D dialogues' final passes (reference ``models/pipelines.py:592-857``)
    as one batch.  Returns ``(run, sampler)``: ``run(latents_all [D, S+1,
    1, h, w, 4], frozen_mask [D, h, w], frozen_steps [D], context [D, 2, L,
    C], cn_context [D, 2, Lt, C], cond_image [D, H, W, 3], ip_scale, gins,
    generators=None, extra_conds=None, adapter_featss=None, *, noise=None)
    -> final latents [D, 1, h, w, 4]`` (the composed trajectory is an
    input here, so the pass's own is dropped, as in JAX).

    ``extra_conds`` (with ``with_extra_cond``) holds ``[D, 2, ...]``
    micro-conditioning; ``adapter_featss`` (with ``with_adapter``) the
    T2I-Adapter's per-level features, ``[D, C, h, w]`` each."""
    refuse_mesh(mesh)
    run_b, sampler = make_batched_final_pipeline(
        bundle, num_steps, use_ip=use_ip, use_controlnet=use_controlnet,
        guided=guided, cfg_cutoff_fraction=cfg_cutoff_fraction,
        deepcache_interval=deepcache_interval,
        controlnet_interval=controlnet_interval)

    def run(latents_all, frozen_mask, frozen_steps, context, cn_context,
            cond_image, ip_scale, gins, generators=None, extra_conds=None,
            adapter_featss=None, *, noise=None):
        if with_extra_cond and extra_conds is None:
            raise ValueError("this runner takes extra_conds")
        if with_adapter and adapter_featss is None:
            raise ValueError("this runner takes adapter_featss")
        final, _ = run_b(latents_all, frozen_mask, frozen_steps, context,
                         cn_context, cond_image, ip_scale, generators,
                         noise=noise, extra_conds=extra_conds,
                         adapter_feats=adapter_featss, gins=gins)
        return final

    return run, sampler
