"""Batched character and final passes, on one device or over a mesh: the
port of ``theatergen_tpu/parallel/driver.py``.

The reference is strictly serial (``theatergen.py:396-407``,
``generate.py:180-269``), but a turn's characters are independent, and so
are the turns of different dialogues at one turn index.  The JAX package
``vmap``s its batch-1 runners over such a batch and shards the batch over
a mesh's ``dp`` axis, the UNet and ControlNet parameters by the tp rules.
Here the batch runs through one loop at batch B
(``character.make_batched_character_pipeline``,
``final.make_batched_final_pipeline``): every UNet evaluation at 2B rows
under CFG, per element its own context, IP scale, noise stream and
guidance problem.

With ``mesh=`` (``parallel/mesh.make_mesh``) the runners are rank 0's
side of ``parallel/worker.py``: a call cuts the batch (a multiple of dp,
which ``Theater`` pads with copies of element 0 as JAX does) into dp
groups of contiguous rows, sends each group's rows to its ranks, runs
group 0's on rank 0 and gathers every output back to rank 0 (latents,
trajectories, each key's reference maps, final latents), in row order.
Each rank runs the same batched loop on its own copy of the bundle whose
UNets and ControlNet hold its tp shard (``mesh.shard_module``, made once
per mesh); the text and vision towers stay whole, as in JAX
(``driver.py:60-61, 137-140``).  A generator cannot travel to another
process, so over a mesh an element's noise stream is a
:class:`NoiseStream` ``(seed, stream)``, rebuilt on the rank that draws
it: a row draws the same noise on whichever rank it lands.

The runners keep the JAX signatures, less what PyTorch carries elsewhere:
the modules hold their parameters, so no parameter trees; a list of
``torch.Generator``s (or :class:`NoiseStream`s), one per element,
replaces the batched PRNG keys (``fold_in_batch`` is ``jax.random``'s and
is not ported); and the character runner takes each element's word token,
which JAX reads from ``gins.word_token[:, 0]``, where no guidance inputs
are given.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..pipelines.bundle import Bundle
from ..pipelines.character import (CharacterResult,
                                   make_batched_character_pipeline)
from ..pipelines.final import make_batched_final_pipeline
from . import mesh as mesh_lib
from . import worker


@dataclasses.dataclass(frozen=True)
class NoiseStream:
    """The noise stream ``(seed, *stream)`` of one element: a generator
    seeded by numpy's ``SeedSequence`` of the tuple, built on the device
    that draws from it (``theater.noise_generator``)."""

    seed: int
    stream: Tuple[int, ...] = ()

    def generator(self, device) -> torch.Generator:
        state = np.random.SeedSequence(
            [self.seed, *self.stream]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=device).manual_seed(int(state))


def _generators(streams, device):
    if streams is None:
        return None
    return [s.generator(device) if isinstance(s, NoiseStream) else s
            for s in streams]


def _rows(x, a: int, b: int, dim: int = 0):
    """Rows ``[a, b)`` of a batched input: a tensor (along ``dim``), a list,
    a dict or tuple of tensors, a batched ``GuidanceInputs``."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, a, b - a)
    if isinstance(x, list):
        return x[a:b]
    if isinstance(x, dict):
        return {k: _rows(v, a, b, dim) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_rows(v, a, b, dim) for v in x)
    return x._map(lambda t: t[a:b])


def _payloads(mesh, batch: int, fields: dict, noise_dim: int = 1) -> list:
    """Every rank's rows of ``fields`` (its dp group's contiguous share;
    ``noise`` is cut along ``noise_dim``)."""
    if batch % mesh.dp:
        raise ValueError(f"batch {batch} is not a multiple of dp={mesh.dp}; "
                         f"pad it (Theater pads with copies of element 0)")
    per = batch // mesh.dp
    out = []
    for r in range(mesh.world):
        a = (r // mesh.tp) * per
        out.append({k: _rows(v, a, a + per,
                             noise_dim if k == "noise" else 0)
                    for k, v in fields.items()})
    return out


def _leaders(mesh, results: list) -> list:
    """The results of each dp group's tp rank 0, in group order, on rank
    0's device."""
    return [worker._to(results[g * mesh.tp], mesh.device)
            for g in range(mesh.dp)]


def _check_streams(generators) -> None:
    if generators is not None and any(
            isinstance(g, torch.Generator) for g in generators):
        raise TypeError("over a mesh each element's noise stream is a "
                        "NoiseStream (seed, stream), rebuilt on the rank "
                        "that draws it; a torch.Generator cannot be sent")


def _mesh_bundle(mesh, bundle: Bundle) -> Bundle:
    """``bundle`` with its UNets and ControlNet holding this rank's tp shard
    (``mesh.shard_module``; the bundle itself at tp = 1), made once per
    mesh and bundle."""
    if mesh.tp == 1:
        return bundle
    cache = mesh.local["bundles"]
    key = id(bundle)
    if key not in cache:
        shard = {name: mesh_lib.shard_module(getattr(bundle, name), mesh)
                 for name in ("unet", "unet_ip", "controlnet")
                 if getattr(bundle, name) is not None}
        cache[key] = (bundle, dataclasses.replace(bundle, **shard))
    return cache[key][1]


def _local_runner(mesh, bundle: Bundle, spec: dict):
    key = (id(bundle), tuple(sorted(spec.items())))
    runners = mesh.local["runners"]
    if key not in runners:
        kw = {k: v for k, v in spec.items() if k not in ("kind", "num_steps")}
        make = (make_batched_character_pipeline if spec["kind"] == "char"
                else make_batched_final_pipeline)
        runners[key] = make(_mesh_bundle(mesh, bundle), spec["num_steps"],
                            **kw)[0]
    return runners[key]


def run_local(mesh, bundle: Bundle, spec: dict, p: dict):
    """One rank's share of a dp runner's call: ``spec`` names the runner
    (``kind`` "char" or "final" and its options), ``p`` holds the rows
    (``parallel/worker.py`` calls this on every rank)."""
    run_b = _local_runner(mesh, bundle, spec)
    dev = bundle.device
    if spec["kind"] == "char":
        return run_b(p["latents"][:, 0], p["contexts"], p["ip_scales"],
                     p["word_tokens"], _generators(p["generators"], dev),
                     noise=p["noise"], extra_conds=p["extra_conds"],
                     gins=p["gins"])
    final, _ = run_b(p["latents_all"], p["frozen_mask"], p["frozen_steps"],
                     p["context"], p["cn_context"], p["cond_image"],
                     p["ip_scale"], _generators(p["generators"], dev),
                     noise=p["noise"], extra_conds=p["extra_conds"],
                     adapter_feats=p["adapter_featss"], gins=p["gins"])
    return final


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
    one per element, for the samplers that draw each step (over a mesh,
    :class:`NoiseStream`s); ``noise`` (``[S, B, h, w, 4]``) replaces them.
    ``extra_conds`` (with ``with_extra_cond``, required then) holds
    SDXL's ``[B, 2, ...]`` pooled text and time ids.  With ``mesh``, B
    must be a multiple of its dp and the call runs on every rank (rank 0
    calls it; see the module's note)."""
    spec = dict(kind="char", num_steps=num_steps, use_ip=use_ip,
                guided=guided, capture_ref_attn=capture_ref_attn,
                cfg_cutoff_fraction=cfg_cutoff_fraction,
                deepcache_interval=deepcache_interval)
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
        if mesh is None:
            return run_b(latents[:, 0], contexts, ip_scales, word_tokens,
                         generators, noise=noise, extra_conds=extra_conds,
                         gins=gins)
        _check_streams(generators)
        dev = bundle.device
        fields = dict(
            latents=latents, contexts=contexts,
            ip_scales=torch.stack([torch.as_tensor(
                s, dtype=torch.float32, device=dev).reshape(())
                for s in ip_scales]),
            word_tokens=[int(t) for t in word_tokens],
            generators=None if generators is None else list(generators),
            noise=noise, extra_conds=extra_conds, gins=gins)
        res = _leaders(mesh, worker.dispatch(
            mesh, spec, _payloads(mesh, b, fields), bundle))
        refs = None
        if res[0].ref_attn is not None:
            refs = tuple(torch.cat(m) for m in zip(*(r.ref_attn
                                                      for r in res)))
        return CharacterResult(torch.cat([r.latents for r in res]),
                               torch.cat([r.trajectory for r in res]), refs)

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
    T2I-Adapter's per-level features, ``[D, C, h, w]`` each.  With
    ``mesh``, D must be a multiple of its dp, as for the character
    runner."""
    spec = dict(kind="final", num_steps=num_steps, use_ip=use_ip,
                use_controlnet=use_controlnet, guided=guided,
                cfg_cutoff_fraction=cfg_cutoff_fraction,
                deepcache_interval=deepcache_interval,
                controlnet_interval=controlnet_interval)
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
        if mesh is None:
            final, _ = run_b(latents_all, frozen_mask, frozen_steps,
                             context, cn_context, cond_image, ip_scale,
                             generators, noise=noise,
                             extra_conds=extra_conds,
                             adapter_feats=adapter_featss, gins=gins)
            return final
        _check_streams(generators)
        d = latents_all.shape[0]
        fields = dict(
            latents_all=latents_all, frozen_mask=frozen_mask,
            frozen_steps=torch.as_tensor(frozen_steps, dtype=torch.long),
            context=context, cn_context=cn_context, cond_image=cond_image,
            generators=None if generators is None else list(generators),
            noise=noise, extra_conds=extra_conds,
            adapter_featss=(None if adapter_featss is None
                            else tuple(adapter_featss)), gins=gins)
        payloads = _payloads(mesh, d, fields)
        scale = (ip_scale.detach().cpu() if torch.is_tensor(ip_scale)
                 else ip_scale)
        for p in payloads:
            p["ip_scale"] = scale
        return torch.cat(_leaders(mesh, worker.dispatch(mesh, spec,
                                                        payloads, bundle)))

    return run, sampler
