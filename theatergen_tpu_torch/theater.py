"""The TheaterGen orchestrator: one turn → one character-consistent image.

The port of ``theatergen_tpu/theater.py`` on its serial path (the
reference's ``theatergen.run``, ``theatergen.py:278-488``, with
``generate_single_object_with_box`` and ``get_masked_latents_all_list``):

- each unique character of a turn (:func:`_dedup_plans`) gets a
  50-step IP-Adapter pass conditioned on its character-DB entry (IP scale
  0.4 on a hit, 0 with placeholder features on a miss), the reference
  maps of its word token captured at every step;
- its image is detected, by the bundle's open-vocabulary detector where
  it has one (``perception.gdino.GroundingDinoBackend`` or
  ``perception.owl.OwlBackend``, on the image and the character's phrase),
  else from those maps (``perception.detector``),
  and regenerated from fresh noise up to :data:`MAX_REGEN_ATTEMPTS` times;
  a detector that raises or answers malformed fails the turn;
- its mask comes from the bundle's segmenter (``perception.sam``: the
  image resized to the segmenter's side, the detection box as the prompt),
  or without one from the step-mean maps (:func:`_attn_mask_fallback`);
- the composition program (:func:`_compose_program`) aligns, composes and
  collages the characters over ``max_objects`` padded slots and draws the
  lineart hint (the bundle's annotator, or ``dog_lineart``), and the
  ControlNet final pass denoises the composed scene with the first
  character's IP features, the masked region frozen for the first
  ``frozen_step_ratio`` of the steps;
- a new character's image and features go to the DB after the final pass
  is dispatched.

On an SDXL bundle (``unet.addition_embed_type == "text_time"``) the turn
encodes each prompt with both text towers and passes the pooled text and
the full-frame time ids (``extra_cond``) to every character attempt, the
background-only turn and the final pass; a bundle with the T2I-Adapter
conditions the final pass on the adapter's features of the lineart hint,
in place of the ControlNet (JAX ``theater.py:157-160``).

The runners take ``cfg.pipeline``'s sampler and knobs (``scheduler_type``,
``cfg_cutoff_fraction``, ``deepcache_interval``, ``controlnet_interval``),
as the JAX Theater builds them; the starting latents are scaled by the
sampler's ``init_noise_sigma``.

The random draws of a turn come from ``torch.Generator``s seeded from the
turn's seed, one stream per use (:func:`noise_generator`): a character's
starting latents from ``(seed, 0, idx)``, where ``idx`` is the index of
the character's first occurrence in the turn's spec, each attempt's
background and then foreground noise in turn; the composition's
background noise (or, in a turn without characters, its starting
latents) from ``(seed, 4)``.  A sampler that draws noise each step
(Euler-Ancestral, LCM) takes it from ``(seed, 1, idx, attempt)`` for a
character attempt, ``(seed, 2)`` for the final pass and ``(seed, 3)`` for
a turn without characters.  DDIM draws nothing per step.  Per-character
streams make a character's draws independent of the order in which the
characters run, so the batched mode draws what the serial loop draws.
These streams cannot reproduce ``jax.random``'s, so parity with the JAX
package goes through injected noise.  Everything stays on the bundle's
device until the turn's images are fetched.

With ``guided`` (the CLI's ``--guidance``) every character attempt, the
background-only turn and the final pass descend their latents on the
guidance energy (``pipelines/guidance.py``): a character on its centred
box and its phrase's tokens, the final pass on the layout's boxes and each
object's tokens in the overall prompt, with attention transfer from each
character's reference maps, per step (``attn_transfer="per_step"``, the
reference's) or their step mean (``"aggregate"``).

With ``batch_characters`` (the CLI's ``--batch_chars``) a turn's unique
characters, where there are two or more with distinct ids, run their
first attempt as one batch (``parallel/driver.py``), are detected and
masked as one batch, and a character whose detection fails rejoins the
serial detect-and-regenerate loop, which draws its attempt 0 again from
its own stream.  :func:`run_turn_wave` advances the turns of several
dialogues (one Theater each, one shared bundle) in lockstep: all their
characters in one batch, then all their final passes in another.  A
failed wave rolls back the character-DB writes it made and raises
:class:`WaveFailure`, carrying the turns that its serial fallback
finished, so a caller reruns the others serially with the same seeds.

The Theater's ``timer`` (``utils/profiling.PhaseTimer``) holds the JAX
package's phases and the port's own: ``char.loop`` / ``final.loop`` (a
runner's enqueue, inside the synced ``char.denoise_decode`` / ``final``),
``char.decode``, ``db.save`` (a DB write, after its fetch), and the counts
``char.jobs`` (a job per character, batched or serial), ``char.attempts``
(every character pass a job gets, a failed batched attempt 0's serial
rerun included) and ``loop.steps`` (the steps the runners enqueued).

With ``mesh`` (``parallel/mesh.make_mesh``; JAX ``theater.py:128-141``)
the Theater is rank 0's program over the mesh: it batches characters, and
the character batches and a wave's final passes run through the dp
runners of ``parallel/driver.py`` over the ranks (each batch padded to a
multiple of dp with copies of element 0, JAX ``:553-562, 1045-1049``; a
padded row's output is dropped, so it writes nothing and detects
nothing).  A turn with one character batches too where dp > 1, as in JAX;
at dp = 1 it runs serially, as under ``batch_characters``, so a one-group
mesh computes exactly what ``batch_characters`` does.  Serial passes (a
regenerated character, a turn without characters, a single dialogue's
final pass) run on rank 0's whole bundle, as JAX runs them on its
unsharded parameters.  A failure on another rank raises
``parallel.worker.RankError``, which no wave or quarantine absorbs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .db import CharacterDB
from .ops import geometry as G
from .ops import latents as L
from .ops.lineart import dog_lineart
from .perception import detector as det
from .perception import sam as sam_lib
from .pipelines import sd, sdxl
from .pipelines.bundle import Bundle
from .parallel import driver
from .parallel.worker import RankError
from .pipelines.character import (CharacterResult, encode_ip_image,
                                  ip_context, make_character_pipeline,
                                  uncond_ip_features)
from .pipelines.final import make_final_pipeline
from .pipelines.guidance import GuidanceInputs, stack_inputs
from .utils import parse
from .utils.profiling import PhaseTimer
from .utils.tokenizer import find_phrase_token_indices

# the reference aggregates the late, semantically stable steps
ATTN_AGG_START = 10
# theatergen.py:98-160 retries a character up to 3 seeds
MAX_REGEN_ATTEMPTS = 3
# the final pass's fixed negative-prompt prefix (theatergen.py:363)
FINAL_NEG_PREFIX = "incohesive, edge shadow, blurry, "
# token positions kept per object in the guidance inputs (a fixed pad)
MAX_PHRASE_TOKENS = 8


def noise_generator(device, seed: int, *stream: int) -> torch.Generator:
    """The per-step noise stream ``(seed, *stream)`` of a turn's sampler, a
    generator on ``device`` seeded by numpy's ``SeedSequence`` of the
    tuple (``parallel.driver.NoiseStream``)."""
    return driver.NoiseStream(seed, stream).generator(device)


def _checked_detection(d, lead: tuple, device) -> det.Detection:
    """A detector's answer for ``lead`` images (``()``: one), its box
    ``[*lead, 4]`` and its verdict ``ok [*lead]`` as tensors on
    ``device``: a ``Detection`` (GroundingDINO), or the ``(box,
    confidence, ok)`` tuple of the JAX package's OWL-ViT interface
    (``perception.owl.OwlBackend``), held to the same shapes.  Anything
    else raises, failing the turn (there is no fallback to attention
    detection)."""
    if isinstance(d, tuple) and len(d) == 3:
        d = det.Detection(*d)
    if not isinstance(d, det.Detection):
        raise TypeError(f"the detector returned {type(d).__name__}, not a "
                        f"Detection or a (box, confidence, ok) tuple")
    box = torch.as_tensor(d.box, device=device).float()
    ok = torch.as_tensor(d.ok, device=device)
    conf = torch.as_tensor(d.confidence, device=device)
    if (tuple(box.shape) != (*lead, 4) or tuple(ok.shape) != lead
            or ok.dtype != torch.bool or tuple(conf.shape) != lead):
        raise ValueError(f"malformed detection for {lead or 'one'} images: "
                         f"box {tuple(box.shape)}, confidence "
                         f"{tuple(conf.shape)}, ok {tuple(ok.shape)} "
                         f"{ok.dtype}")
    return det.Detection(box=box, confidence=conf, ok=ok)


def aggregate_attn(ref_attn: Sequence[torch.Tensor], num_steps: int
                   ) -> List[torch.Tensor]:
    """Mean over steps ≥ ``ATTN_AGG_START`` (the last step where a run
    is shorter) of each guidance key's maps, ``[S, heads, HW]`` →
    ``[heads, HW]``, or batched ``[B, S, heads, HW]`` → ``[B, heads,
    HW]``; fp32."""
    start = min(ATTN_AGG_START, max(num_steps - 1, 0))
    out = []
    for m in ref_attn:
        if m.ndim == 4:
            out.append(m[:, start:].float().mean(1))
        else:
            out.append(m[start:].float().mean(0))
    return out


def _attn_mask_fallback(maps: Sequence[torch.Tensor], hint: torch.Tensor,
                        h: int, w: int, H: int, W: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A character's mask without a segmenter: the step-mean maps
    (``[heads, HW]`` each) averaged over heads, resized to the latent grid
    and summed, normalised by their maximum; the mask holds where that
    exceeds 0.3, or 0.1 inside the box ``hint``.  Returns ``(latent mask
    [h, w], pixel mask [H, W])``, {0, 1} fp32.  Leading axes carry
    through: maps ``[B, heads, HW]`` and hints ``[B, 4]`` give B masks (the
    batched characters' masks)."""
    lead = tuple(hint.shape[:-1])
    agg = torch.zeros(lead + (h, w), dtype=torch.float32, device=hint.device)
    for m in maps:
        mm = m.float().mean(-2)
        side = int(round(mm.shape[-1] ** 0.5))
        agg = agg + G.resize_bilinear(mm.reshape(lead + (side, side)), h, w)
    agg = agg / (agg.amax((-2, -1), keepdim=True) + 1e-8)
    box_m = G.box_mask(hint.float(), h, w)
    m_lat = torch.maximum((agg > 0.3).float(), box_m * (agg > 0.1).float())
    return m_lat, G.upsample_nearest(m_lat, H, W)


def _compose_program(lineart_module=None):
    """Alignment, trajectory composition, the pixel collage, the lineart
    hint (``lineart_module``, the annotator, on the collage; without one
    the weightless ``dog_lineart``) and the frozen mask, as one function.

    ``run(traj [K, S+1, 1, h, w, 4], masks_lat [K, h, w], masks_pix [K, H,
    W], images [K, H, W, 3], boxes [K, 4], valid [K], bg_lat [1, h, w, 4])
    -> (composed [S+1, 1, h, w, 4], collage [H, W, 3], cond_img [H, W, 3],
    frozen_mask [h, w])``."""

    def run(traj, masks_lat, masks_pix, images, boxes, valid, bg_lat):
        traj_a, masks_a, _ = L.align_with_boxes(traj, masks_lat, boxes)
        composed, fg_idx = L.compose_trajectories(traj_a, masks_a, bg_lat)
        collage, _ = L.collage_images(images, masks_pix, boxes, valid)
        if lineart_module is not None:
            with torch.no_grad():
                cond_img = lineart_module(collage[None])[0]
        else:
            cond_img = dog_lineart(collage)
        return composed, collage, cond_img, (fg_idx > 0).float()

    return run


@dataclasses.dataclass
class TurnResult:
    image: np.ndarray                 # [H, W, 3] in [0, 1]
    so_images: List[np.ndarray]       # per character, in spec order
    collage: np.ndarray               # [H, W, 3]
    seconds: float
    detections: List[bool]
    db_hits: List[bool]               # per character: a DB hit this turn


def _dedup_plans(plan: parse.TurnPlan):
    """Within-turn character dedup (reference theatergen.py:217-226): a
    repeated (prompt, obj_id) reuses the first generation.  Returns (order
    keys, unique object plans, their spec indices)."""
    seen = set()
    order, unique_plans, unique_idx = [], [], []
    for idx, oplan in enumerate(plan.object_plans):
        key = (oplan.prompt, oplan.obj_id)
        order.append(key)
        if key not in seen:
            seen.add(key)
            unique_plans.append(oplan)
            unique_idx.append(idx)
    return order, unique_plans, unique_idx


class Theater:
    """Runs the turns of one dialogue against one character DB.

    >>> th = Theater(init_bundle(sd15_config(), with_ip=True,
    ...              with_vision=True, with_controlnet=True), CharacterDB(d))
    >>> res = th.run_turn(spec, seed=0)      # res.image [512, 512, 3]
    """

    def __init__(self, bundle: Bundle, db: CharacterDB, *,
                 task: str = "story", num_steps: Optional[int] = None,
                 guided: bool = False, use_controlnet: bool = True,
                 attn_transfer: str = "per_step", mesh=None,
                 batch_characters: bool = False):
        # guided=False is the reference's released behaviour: it defines
        # latent_backward_guidance but its benchmark path never calls it
        # (models/pipelines.py:62-128); guided=True opts in.
        # attn_transfer: the final pass matches each step's saved
        # reference maps ("per_step", utils/guidance.py:220-233) or their
        # mean over steps >= ATTN_AGG_START ("aggregate")
        if attn_transfer not in ("per_step", "aggregate"):
            raise ValueError(f"attn_transfer {attn_transfer!r}: expected "
                             f"'per_step' or 'aggregate'")
        if mesh is not None and getattr(mesh, "rank", None) != 0:
            raise ValueError("Theater(mesh=) runs on the mesh's rank 0; the "
                             "other ranks run parallel.worker.serve")
        if bundle.unet_ip is None:
            raise ValueError("Theater: the bundle needs the IP UNet "
                             "(init_bundle(..., with_ip=True))")
        cfg = bundle.cfg
        self.bundle, self.db, self.task, self.cfg = bundle, db, task, cfg
        self.guided, self.attn_transfer = guided, attn_transfer
        # a turn's characters as one batch (the reference is serial,
        # theatergen.py:396-407; their passes are independent), over the
        # mesh's ranks where one is given
        self.mesh = mesh
        self.batch_characters = bool(batch_characters or mesh is not None)
        self._char_run_b = self._final_run_b = None
        self.num_steps = num_steps or cfg.pipeline.num_steps
        # SDXL: two text towers and micro-conditioning; the T2I-Adapter,
        # where the bundle has it, conditions the final pass in place of
        # the ControlNet
        self.is_xl = cfg.unet.addition_embed_type == "text_time"
        self.use_t2i = self.is_xl and bundle.t2i_adapter is not None
        self.use_controlnet = (use_controlnet and not self.use_t2i
                               and bundle.controlnet is not None)
        pl = cfg.pipeline
        self.char_run, self.char_sched = make_character_pipeline(
            bundle, self.num_steps, use_ip=True, guided=guided,
            capture_ref_attn=True,
            cfg_cutoff_fraction=pl.cfg_cutoff_fraction,
            deepcache_interval=pl.deepcache_interval)
        self.final_run, self.final_sched = make_final_pipeline(
            bundle, self.num_steps, use_ip=True,
            use_controlnet=self.use_controlnet, guided=guided,
            cfg_cutoff_fraction=pl.cfg_cutoff_fraction,
            deepcache_interval=pl.deepcache_interval,
            controlnet_interval=pl.controlnet_interval)
        self._init_sigma = float(self.char_sched.init_noise_sigma)
        # plus/full IP variants condition the uncond branch on black-image
        # features; computed once per Theater
        self._uncond_ip = uncond_ip_features(bundle)
        self.timer = PhaseTimer(bundle.device)
        # obj_id -> (image [1, H, W, 3], features), on the device: DB writes
        # whose fetch is deferred past the final pass's dispatch
        self._pending_saves: Dict = {}

    @staticmethod
    def so_prompt_for(task: str, phrase: str) -> str:
        """Single-object prompt per task (reference
        ``models/pipelines.py:216-221``)."""
        if task == "story":
            return f"full-body picture of {phrase}"
        return f"single object, {phrase}"

    def _placeholder_ip_features(self) -> torch.Tensor:
        """Zero (base) or black-image (plus, full) features of the shape
        the IP variant expects."""
        if self._uncond_ip is not None:
            return self._uncond_ip
        return torch.zeros((1, self.cfg.ip_adapter.clip_embeddings_dim),
                           device=self.bundle.device)

    def _embed_from_db(self, emb: np.ndarray) -> torch.Tensor:
        """DB-stored (flattened) features → the variant's [1, ...] shape."""
        return self._embed_dev(torch.as_tensor(np.asarray(emb, np.float32),
                                               device=self.bundle.device))

    def _embed_dev(self, emb: torch.Tensor) -> torch.Tensor:
        if self.bundle.ip_variant == "plus":
            return emb.reshape(1, -1, self.cfg.vision.hidden_size)
        return emb.reshape(1, -1)

    def _encode_text(self, prompt: str, negative: str):
        """(context [2, L, C], extra_cond): SD1.5's single tower and None,
        or SDXL's two towers and ``{pooled_text [2, P], time_ids [2, 6]}``
        (full-frame at the canvas size)."""
        if not self.is_xl:
            return sd.encode_prompts(self.bundle, prompt, negative), None
        ctx, pooled = sdxl.encode_prompts_xl(self.bundle, prompt, negative)
        pl = self.cfg.pipeline
        tids = sdxl.default_time_ids(pl.height, pl.width, ctx.shape[0],
                                     device=self.bundle.device)
        return ctx, dict(pooled_text=pooled, time_ids=tids)

    def _decode_img(self, latents: torch.Tensor) -> torch.Tensor:
        return sd.decode_with(self.bundle.vae, self.cfg.vae.scaling_factor,
                              latents)

    def _guidance_inputs(self, boxes, prompts_token_pos,
                         ref_attn=None) -> GuidanceInputs:
        """Per-object boxes and token positions padded to ``max_objects``
        slots, the token axis to a fixed MAX_PHRASE_TOKENS (each object's
        last positions), the word token an object's last position; with
        ``ref_attn`` (per object a tuple of per-key maps, ``[heads, HW]``
        aggregated or ``[S, heads, HW]`` per step, or None), per key the
        objects' maps stacked ``[K, heads, HW]`` or ``[S, K, heads, HW]``,
        zeros in the empty slots.  On the bundle's device."""
        dev = self.bundle.device
        k, p = self.cfg.pipeline.max_objects, MAX_PHRASE_TOKENS
        boxes_a = np.zeros((k, 4), np.float32)
        pos = np.zeros((k, p), np.int64)
        pos_valid = np.zeros((k, p), bool)
        valid = np.zeros((k,), bool)
        word = np.zeros((k,), np.int64)
        for i, (b, tp) in enumerate(zip(boxes, prompts_token_pos)):
            if i >= k:
                break
            boxes_a[i] = np.asarray(b, np.float32)
            for j, t in enumerate(tp[-p:]):
                pos[i, j] = t
                pos_valid[i, j] = True
            valid[i] = True
            word[i] = tp[-1] if tp else 0
        refs = None
        if ref_attn is not None:
            refs = []
            for ki in range(len(self.cfg.guidance.attn_keys)):
                maps = [ref_attn[i][ki] if i < len(ref_attn)
                        and ref_attn[i] is not None else None
                        for i in range(k)]
                like = next(m for m in maps if m is not None)
                maps = [(m if m is not None else torch.zeros_like(like))
                        .to(dev, torch.float32) for m in maps]
                refs.append(torch.stack(maps, dim=1 if like.ndim == 3
                                        else 0))
            refs = tuple(refs)

        def put(a):
            return torch.as_tensor(a, device=dev)

        return GuidanceInputs(put(boxes_a), put(pos), put(pos_valid),
                              put(valid), put(word), refs)

    def _aggregate_attn(self, ref_attn) -> List[torch.Tensor]:
        """Step mean of the reference maps from ATTN_AGG_START, at the
        character schedule's length (fast schedules shorten it)."""
        return aggregate_attn(ref_attn, self.char_sched.num_steps)

    def _extract_masks(self, agg_maps, image, box_hint):
        """(latent mask [h, w], pixel mask [H, W]): the bundle's segmenter
        on ``image [1, H, W, 3]`` resized to its side, prompted with
        ``box_hint`` (the reference's ``sam_refine_attn``), or without one
        the thresholded step-mean maps."""
        pl = self.cfg.pipeline
        h, H = pl.latent_height, pl.height
        sam = self.bundle.sam
        if sam is not None:
            size = sam_lib.sam_input_size(sam)
            img_s = G.resize_bilinear(image[0].permute(2, 0, 1), size,
                                      size).permute(1, 2, 0)
            (m_lat, m_pix), _ = sam_lib.segment_with_box(
                sam, img_s, box_hint, out_sizes=(h, H))
            return m_lat, m_pix
        return _attn_mask_fallback(agg_maps, box_hint, h, pl.latent_width,
                                   H, pl.width)

    # -------------------------------------------------------------- character

    def _character_prep(self, plan: parse.ObjectPlan, extra_neg: str) -> dict:
        """Prompts, the word token, the text context and the DB lookup →
        IP scale and features (theatergen.py:43-96)."""
        b, cfg = self.bundle, self.cfg
        centered = G.centered_box(torch.tensor(plan.box, dtype=torch.float32))
        so_prompt = self.so_prompt_for(self.task, plan.phrase)
        neg = parse.DEFAULT_SO_NEGATIVE_PROMPT
        if extra_neg:
            neg = f"{extra_neg}, {neg}"
        with self.timer.phase("char.encode_text"):
            token_pos = find_phrase_token_indices(
                b.tokenizer, so_prompt, plan.word, cfg.text.max_length)
            if not token_pos:
                so_prompt = f"{so_prompt} | {plan.phrase}"  # guidance.py:33-36
                token_pos = find_phrase_token_indices(
                    b.tokenizer, so_prompt, plan.word, cfg.text.max_length)
            text_ctx, extra_cond = self._encode_text(so_prompt, neg)

        pending = self._pending_saves.get(plan.obj_id)
        if pending is not None:
            # saved earlier this turn, its disk write still deferred: a hit,
            # served from the features on the device
            hit, ip_scale = True, cfg.pipeline.ip_scale_hit
            img_embed = self._embed_dev(pending[1])
        elif (hit_t := self.db.lookup(plan.obj_id))[2]:
            db_img, db_emb, hit = hit_t
            if db_emb is None:
                db_emb = encode_ip_image(
                    b, torch.as_tensor(db_img)[None])[0].cpu().numpy()
            ip_scale = cfg.pipeline.ip_scale_hit
            img_embed = self._embed_from_db(db_emb)
        else:
            # a miss: placeholder features at IP scale 0 (the reference uses
            # a placeholder image at scale 0, models/pipelines.py:183-199)
            hit, ip_scale = False, 0.0
            img_embed = self._placeholder_ip_features()
        ctx = ip_context(b, text_ctx, img_embed, self._uncond_ip)
        gin = (self._guidance_inputs([centered.tolist()], [token_pos])
               if self.guided else None)
        return dict(ctx=ctx, extra_cond=extra_cond, ip_scale=ip_scale,
                    img_embed=img_embed,
                    word_token=token_pos[-1] if token_pos else 0,
                    token_pos=token_pos, hit=hit, centered=centered, gin=gin)

    def _char_input_latents(self, gen: torch.Generator,
                            centered: torch.Tensor) -> torch.Tensor:
        """One attempt's starting latents [1, h, w, 4]: background noise,
        then the character's noise blended in inside its centred box."""
        pl = self.cfg.pipeline
        return L.input_latents_for_boxes(
            gen, centered[None].to(self.bundle.device), pl.latent_height,
            pl.latent_width, fg_blending_ratio=pl.fg_blending_ratio,
            init_noise_sigma=self._init_sigma)[0][0]

    def _bg_gen(self, seed: int) -> torch.Generator:
        """The stream of the turn's background noise, ``(seed, 4)``."""
        return noise_generator(self.bundle.device, seed, 4)

    def _bg_latents(self, gen: torch.Generator) -> torch.Tensor:
        """Scaled unit noise [1, h, w, 4]: the composition's background, or
        the starting latents of a turn without characters."""
        pl = self.cfg.pipeline
        return sd.seeded_latents(gen, 1, pl.latent_height, pl.latent_width,
                                 device=self.bundle.device) * self._init_sigma

    def _character_finish(self, plan: parse.ObjectPlan, prep: dict, result,
                          image, agg, detected_ok: bool, det_box,
                          masks=None) -> dict:
        """Masks, the deferred DB write of a new character, and the
        character's record (theatergen.py:158-201).  ``masks`` carries
        (latent, pixel) masks made by the batched path."""
        img_embed = prep["img_embed"]
        with self.timer.phase("char.masks"):
            m_lat, m_pix = (masks if masks is not None
                            else self._extract_masks(agg, image, det_box))
        if not prep["hit"]:
            with self.timer.phase("char.embed_db"):
                emb_dev = encode_ip_image(self.bundle, image)[0]
                self._pending_saves[plan.obj_id] = (image, emb_dev)
                img_embed = self._embed_dev(emb_dev)
        return dict(trajectory=result.trajectory, ref_attn=result.ref_attn,
                    image=image, mask_lat=m_lat, mask_pix=m_pix,
                    detected=detected_ok, token_pos=prep["token_pos"],
                    img_embed=img_embed, hit=prep["hit"])

    def _noise_gen(self, seed: int, *stream: int):
        """The sampler's per-step noise stream, or None where it draws
        none (DDIM)."""
        if not self.char_sched.needs_noise:
            return None
        return noise_generator(self.bundle.device, seed, *stream)

    def _generate_character(self, plan: parse.ObjectPlan, extra_neg: str,
                            seed: int, idx: int) -> dict:
        """One character with detect-and-regenerate (theatergen.py:43-201):
        attempt ``a`` draws its starting latents next from the stream
        ``(seed, 0, idx)`` and steps with the noise stream ``(seed, 1, idx,
        a)``, up to MAX_REGEN_ATTEMPTS."""
        prep = self._character_prep(plan, extra_neg)
        gen = noise_generator(self.bundle.device, seed, 0, idx)
        detected_ok = False
        result = image = agg = detection = None
        for attempt in range(MAX_REGEN_ATTEMPTS):
            init_lat = self._char_input_latents(gen, prep["centered"])
            self.timer.count("char.attempts")
            with self.timer.phase("char.denoise_decode", sync=True):
                with self.timer.phase("char.loop"):
                    result = self.char_run(
                        init_lat, prep["ctx"], prep["ip_scale"],
                        prep["word_token"], self._noise_gen(seed, 1, idx,
                                                            attempt),
                        extra_cond=prep["extra_cond"], gin=prep["gin"])
                self.timer.count("loop.steps", self.char_sched.num_steps)
                with self.timer.phase("char.decode"):
                    image = self._decode_img(result.latents)
                agg = self._aggregate_attn(result.ref_attn)
            with self.timer.phase("char.detect"):
                if self.bundle.detector is not None:
                    # the open-vocabulary detector on the generated image,
                    # as the reference detects (utils/detector.py:5-21)
                    detection = _checked_detection(
                        self.bundle.detector(image[0], plan.phrase), (),
                        self.bundle.device)
                else:
                    detection = det.attention_detect(agg, None)
                detected_ok = bool(detection.ok)
            if detected_ok:
                break
        det_box = (detection.box if detected_ok
                   else prep["centered"].to(self.bundle.device))
        return self._character_finish(plan, prep, result, image, agg,
                                      detected_ok, det_box)

    def _batched_char_runner(self):
        """The batched character runner (``parallel.driver``), built on
        first use."""
        if self._char_run_b is None:
            pl = self.cfg.pipeline
            self._char_run_b = driver.make_dp_character_runner(
                self.bundle, self.num_steps, self.mesh, use_ip=True,
                guided=self.guided,
                capture_ref_attn=True,
                cfg_cutoff_fraction=pl.cfg_cutoff_fraction,
                deepcache_interval=pl.deepcache_interval,
                with_extra_cond=self.is_xl)[0]
        return self._char_run_b

    def _generate_characters_batched(self, oplans, extra_neg: str,
                                     seed: int, indices) -> List[dict]:
        """A turn's unique characters in one batch (the reference runs them
        one by one, theatergen.py:396-407; their passes are independent).
        Each character draws from its own streams, as the serial loop does;
        a failed detection rejoins the serial detect-and-regenerate
        loop."""
        return self._batched_char_exec(
            _make_char_jobs(self, oplans, extra_neg, seed, indices))

    def _batched_char_exec(self, jobs: List[dict]) -> List[dict]:
        """Run character jobs (``{th, oplan, prep, extra_neg, seed, idx}``)
        as one batch on this Theater's runner: attempt 0 of every job, its
        starting latents drawn by this Theater's ``_char_input_latents``
        in job order, one decode, one detection with one host read of the
        verdicts, one mask program.  Jobs may come from several Theaters
        (``run_turn_wave`` batches across dialogues) that share this one's
        bundle and settings; each job's masks, DB write and fallback go
        through its own Theater.  A job whose detection fails reruns in its
        Theater's serial loop (attempt 0 again, from the same streams,
        then fresh attempts).  Over a mesh the batch is padded to a
        multiple of dp with copies of job 0, whose outputs are dropped."""
        dev = self.bundle.device
        n = len(jobs)
        dp = self.mesh.dp if self.mesh is not None else 1
        # JAX theater.py:560-562: pad to a dp multiple with element 0
        padded = jobs + [jobs[0]] * (-(-n // dp) * dp - n)
        lats = torch.cat([self._char_input_latents(
            noise_generator(dev, j["seed"], 0, j["idx"]),
            j["prep"]["centered"]) for j in padded])
        gens = None
        if self.char_sched.needs_noise:
            # over a mesh the streams travel as (seed, stream)
            gens = [driver.NoiseStream(j["seed"], (1, j["idx"], 0))
                    if self.mesh is not None else
                    noise_generator(dev, j["seed"], 1, j["idx"], 0)
                    for j in padded]
        preps = [j["prep"] for j in padded]
        gins = stack_inputs([p["gin"] for p in preps]) if self.guided \
            else None
        extra = None
        if self.is_xl:
            extra = {k: torch.stack([p["extra_cond"][k] for p in preps])
                     for k in preps[0]["extra_cond"]}
        for j in jobs:
            j["th"].timer.count("char.jobs")
            j["th"].timer.count("char.attempts")
        with self.timer.phase("char.denoise_decode", sync=True):
            with self.timer.phase("char.loop"):
                res = self._batched_char_runner()(
                    lats[:, None], torch.stack([p["ctx"] for p in preps]),
                    [p["ip_scale"] for p in preps], gins, gens, extra,
                    word_tokens=[p["word_token"] for p in preps])
            self.timer.count("loop.steps", self.char_sched.num_steps)
            if len(padded) > n:
                res = CharacterResult(
                    res.latents[:n], res.trajectory[:n],
                    None if res.ref_attn is None else
                    tuple(m[:n] for m in res.ref_attn))
            with self.timer.phase("char.decode"):
                images = self._decode_img(res.latents[:, 0])
            aggs = self._aggregate_attn(res.ref_attn)   # per key [B, ...]
        # one detection of the batch and one host read of its verdicts, but
        # for a detector without detect_batch, which sees one image at a
        # time (JAX theater.py:602-633)
        detector = self.bundle.detector
        det_b = None
        if detector is None or hasattr(detector, "detect_batch"):
            with self.timer.phase("char.detect"):
                if detector is None:
                    det_b = det.attention_detect_batch(aggs)
                else:
                    det_b = _checked_detection(detector.detect_batch(
                        images, [j["oplan"].phrase for j in jobs]),
                        (len(jobs),), dev)
                oks = det_b.ok.tolist()
            with self.timer.phase("char.masks"):
                masks_b = self._extract_masks_batched(aggs, images,
                                                      det_b.box)

        outs = []
        for i, j in enumerate(jobs):
            th = j["th"]
            if det_b is None:
                with th.timer.phase("char.detect"):
                    d = _checked_detection(detector(images[i], j[
                        "oplan"].phrase), (), dev)
                    ok, box, masks = bool(d.ok), d.box, None
            else:
                ok, box = oks[i], det_b.box[i]
                masks = (masks_b[0][i], masks_b[1][i])
            if not ok:
                outs.append(th._generate_character(
                    j["oplan"], j["extra_neg"], j["seed"], j["idx"]))
                continue
            result = CharacterResult(
                res.latents[i], res.trajectory[i],
                tuple(m[i] for m in res.ref_attn))
            outs.append(th._character_finish(
                j["oplan"], j["prep"], result, images[i][None],
                [m[i] for m in aggs], True, box, masks=masks))
        return outs

    def _extract_masks_batched(self, agg_maps, images, box_hints):
        """:meth:`_extract_masks` of a batch: one segmenter forward over
        ``images [B, H, W, 3]`` with one box each, or the thresholded maps
        (``[B, heads, HW]`` per key) of every element at once."""
        pl = self.cfg.pipeline
        h, H = pl.latent_height, pl.height
        sam = self.bundle.sam
        if sam is not None:
            size = sam_lib.sam_input_size(sam)
            imgs = G.resize_bilinear(images.permute(0, 3, 1, 2), size,
                                     size).permute(0, 2, 3, 1)
            (m_lat, m_pix), _ = sam_lib.segment_with_box_batch(
                sam, imgs, box_hints, out_sizes=(h, H))
            return m_lat, m_pix
        return _attn_mask_fallback(agg_maps, box_hints, h, pl.latent_width,
                                   H, pl.width)

    # ------------------------------------------------------------------ turn

    def _flush_db_saves(self) -> None:
        """Fetch and persist the deferred DB writes; called once the final
        pass is dispatched, and in run_turn's ``finally`` so the DB is
        durable at the end of every turn."""
        while self._pending_saves:
            obj_id = next(iter(self._pending_saves))
            image, emb = self._pending_saves.pop(obj_id)
            image = image[0].float().cpu().numpy()
            emb = emb.float().cpu().numpy().reshape(-1)
            with self.timer.phase("db.save"):
                self.db.save(obj_id, image, emb)

    def run_turn(self, spec: dict, seed: int,
                 frozen_step_ratio: Optional[float] = None,
                 overall_prompt_override: Optional[str] = None
                 ) -> TurnResult:
        """One turn → one image (reference theatergen.py:278-488)."""
        try:
            return self._run_turn(spec, seed, frozen_step_ratio,
                                  overall_prompt_override)
        finally:
            self._flush_db_saves()

    def _run_turn(self, spec: dict, seed: int,
                  frozen_step_ratio: Optional[float] = None,
                  overall_prompt_override: Optional[str] = None
                  ) -> TurnResult:
        t_start = time.perf_counter()
        b, cfg = self.bundle, self.cfg
        plan = parse.convert_spec(spec, cfg.pipeline.height,
                                  cfg.pipeline.width)
        if overall_prompt_override and overall_prompt_override.strip():
            plan.overall_prompt = overall_prompt_override.strip()
        extra_neg = spec.get("extra_neg_prompt") or ""
        ratio = (cfg.pipeline.frozen_step_ratio
                 if frozen_step_ratio is None else frozen_step_ratio)
        frozen_steps = min(int(round(ratio * self.num_steps)),
                           self.char_sched.num_steps)
        order, unique_plans, unique_idx = _dedup_plans(plan)
        cache: Dict[Tuple[str, int], dict] = {}
        # batched characters need distinct ids: with a repeated id the
        # serial loop's first write is the second's DB hit.  A lone
        # character batches over a mesh of dp > 1 (JAX theater.py:701-705)
        if (self.batch_characters and unique_plans
                and (len(unique_plans) > 1
                     or (self.mesh is not None and self.mesh.dp > 1))
                and len({p.obj_id for p in unique_plans})
                == len(unique_plans)):
            with self.timer.phase("character"):
                outs = self._generate_characters_batched(
                    unique_plans, extra_neg, seed, unique_idx)
            for oplan, out in zip(unique_plans, outs):
                cache[(oplan.prompt, oplan.obj_id)] = out
        else:
            for oplan, idx in zip(unique_plans, unique_idx):
                self.timer.count("char.jobs")
                with self.timer.phase("character"):
                    cache[(oplan.prompt, oplan.obj_id)] = (
                        self._generate_character(oplan, extra_neg, seed,
                                                 idx))
        chars = [cache[key] for key in order]

        if not chars:
            # background only: plain txt2img on the overall prompt
            ctx, extra_cond = self._encode_text(
                plan.overall_prompt or plan.bg_prompt,
                parse.DEFAULT_OVERALL_NEGATIVE_PROMPT)
            ctx = ip_context(b, ctx, self._placeholder_ip_features(),
                             self._uncond_ip)
            gin = (self._guidance_inputs([(0.0, 0.0, 1.0, 1.0)], [[1]])
                   if self.guided else None)
            res = self.char_run(self._bg_latents(self._bg_gen(seed)), ctx,
                                0.0, 0, self._noise_gen(seed, 3),
                                extra_cond=extra_cond, gin=gin)
            img = self._decode_img(res.latents)[0].float().cpu().numpy()
            return TurnResult(img, [], img, time.perf_counter() - t_start,
                              [], [])

        fargs, collage = self._final_stage(plan, chars, extra_neg, seed)
        with self.timer.phase("final", sync=True):
            with self.timer.phase("final.loop"):
                final, _ = self.final_run(
                    fargs["composed"], fargs["frozen_mask"], frozen_steps,
                    fargs["ctx"], fargs["cn_ctx"], fargs["cond_img"],
                    cfg.pipeline.ip_scale_final, self._noise_gen(seed, 2),
                    extra_cond=fargs["extra_cond"],
                    adapter_feats=fargs["adapter_feats"], gin=fargs["gin"])
            self.timer.count("loop.steps", self.final_sched.num_steps)
            image = self._decode_img(final)
            # the deferred DB writes: each fetch to the host waits on the
            # stream, behind the final pass and its decode, so each write
            # runs with nothing queued on the device
            self._flush_db_saves()

        return TurnResult(
            image=image[0].float().cpu().numpy(),
            so_images=[c["image"][0].float().cpu().numpy() for c in chars],
            collage=collage.float().cpu().numpy(),
            seconds=time.perf_counter() - t_start,
            detections=[bool(c["detected"]) for c in chars],
            db_hits=[bool(c["hit"]) for c in chars])

    def _final_stage(self, plan: parse.TurnPlan, chars: List[dict],
                     extra_neg: str, seed: int):
        """Composition and the final pass's conditioning for a turn whose
        characters are generated (theatergen.py:417-477).  Returns
        ``(final-run inputs, collage)``; ``run_turn_wave`` stacks the
        inputs of several dialogues for the batched final pass."""
        b, cfg = self.bundle, self.cfg
        pl = cfg.pipeline
        dev = b.device
        k = pl.max_objects
        n = min(len(chars), k)
        pad = k - n

        def stack(key):
            xs = [chars[i][key] for i in range(n)]
            return torch.stack(xs + [torch.zeros_like(xs[0])] * pad)

        boxes = torch.tensor(
            [plan.object_plans[i].box for i in range(n)] + [(0.0,) * 4] * pad,
            dtype=torch.float32, device=dev)
        with self.timer.phase("compose", sync=True):
            composed, collage, cond_img, frozen_mask = _compose_program(
                b.lineart)(
                stack("trajectory"), stack("mask_lat"), stack("mask_pix"),
                torch.stack([chars[i]["image"][0] for i in range(n)]
                            + [torch.zeros_like(chars[0]["image"][0])] * pad),
                boxes, torch.arange(k, device=dev) < n,
                self._bg_latents(self._bg_gen(seed)))

        # the overall context, with the first character's IP features
        # (models/pipelines.py:700-701)
        neg = parse.DEFAULT_OVERALL_NEGATIVE_PROMPT
        if extra_neg:
            neg = f"{extra_neg}, {neg}"
        neg = FINAL_NEG_PREFIX + neg
        overall_ctx, extra_cond = self._encode_text(plan.overall_prompt, neg)
        ctx = ip_context(b, overall_ctx, chars[0]["img_embed"],
                         self._uncond_ip)
        adapter_feats = (sdxl.adapter_features(b, cond_img) if self.use_t2i
                         else None)
        gin = self._overall_guidance(plan, chars) if self.guided else None
        return dict(composed=composed, frozen_mask=frozen_mask, ctx=ctx,
                    cn_ctx=overall_ctx, cond_img=cond_img,
                    extra_cond=extra_cond, adapter_feats=adapter_feats,
                    gin=gin), collage

    def _overall_guidance(self, plan: parse.TurnPlan,
                          chars: List[dict]) -> GuidanceInputs:
        """The final pass's guidance inputs: each object's layout box, its
        token positions in the overall prompt and its character's
        reference maps (per step, or their step mean under
        ``attn_transfer="aggregate"``).  Duplicate objects are pluralised
        in the overall prompt (``parse.convert_spec``), so an object's
        tokens are its group word's ("two cats" → "cats"), and token 1
        where the word is not found."""
        b, cfg = self.bundle, self.cfg
        group_word = {}
        for phrase, word, _ in plan.overall_phrases:
            for name in plan.objects:
                if name == phrase or parse.strip_article(name) in phrase:
                    group_word.setdefault(name, word)
        token_pos, boxes, refs = [], [], []
        for i, oplan in enumerate(plan.object_plans[:cfg.pipeline.max_objects]):
            word = group_word.get(oplan.phrase, oplan.word)
            tp = find_phrase_token_indices(b.tokenizer, plan.overall_prompt,
                                           word, cfg.text.max_length)
            token_pos.append(tp or [1])
            boxes.append(oplan.box)
            refs.append(chars[i]["ref_attn"])
        if self.attn_transfer == "aggregate":
            refs = [tuple(self._aggregate_attn(r)) for r in refs]
        return self._guidance_inputs(boxes, token_pos, refs)


def _make_char_jobs(th: Theater, oplans, extra_neg: str, seed: int,
                    indices) -> List[dict]:
    """Character jobs for :meth:`Theater._batched_char_exec`: the one place
    the job's fields and its streams' indices are set (the batched turn
    and run_turn_wave share it)."""
    return [dict(th=th, oplan=p, extra_neg=extra_neg,
                 prep=th._character_prep(p, extra_neg), seed=seed, idx=idx)
            for p, idx in zip(oplans, indices)]


def _wave_final_runner(th: Theater):
    """The batched final runner of ``th``'s settings, built on first
    use."""
    if th._final_run_b is None:
        pl = th.cfg.pipeline
        th._final_run_b = driver.make_dp_final_runner(
            th.bundle, th.num_steps, th.mesh, use_ip=True,
            use_controlnet=th.use_controlnet, guided=th.guided,
            cfg_cutoff_fraction=pl.cfg_cutoff_fraction,
            deepcache_interval=pl.deepcache_interval,
            controlnet_interval=pl.controlnet_interval,
            with_extra_cond=th.is_xl, with_adapter=th.use_t2i)[0]
    return th._final_run_b


def _to_host(images: torch.Tensor) -> np.ndarray:
    """The wave's final images on the host: where a device fault of the
    batched final pass surfaces, after the DB writes were flushed."""
    return images.float().cpu().numpy()


class WaveFailure(RuntimeError):
    """A wave's batched passes failed.  ``results`` maps wave-local
    dialogue indices to the TurnResults of dialogues that finished all the
    same (through the wave's serial fallback); a quarantine reuses them
    rather than rerun those turns, whose DB writes are durable."""

    def __init__(self, results: Dict[int, TurnResult], cause):
        super().__init__(f"wave failed: {cause!r} "
                         f"({len(results)} dialogues completed serially)")
        self.results = results


def run_turn_wave(theaters: List[Theater], specs: List[dict],
                  seeds: List[int],
                  frozen_step_ratio: Optional[float] = None
                  ) -> List[TurnResult]:
    """One turn of each of N dialogues in lockstep (the dialogue is the
    unit: its turns depend on each other through the character DB, so N
    dialogues advance one turn at a time; the reference runs them one by
    one, generate.py:180-269).  All characters of the wave run as one
    batch and all final passes as another.  The Theaters share one bundle
    and settings, each with its own DB; a dialogue whose turn has no
    characters or repeats an id runs its owner's serial ``run_turn``
    inside the wave.  Each turn draws what its serial ``run_turn`` draws.

    On a failure the wave's character-DB writes are undone (the deferred
    ones dropped, the flushed first appearances deleted) and
    :class:`WaveFailure` carries the turns that finished serially, so a
    quarantine reruns the other turns serially with the same seeds from a
    clean DB."""
    if not len(theaters) == len(specs) == len(seeds):
        raise ValueError("run_turn_wave: one spec and one seed per theater")
    results: Dict[int, TurnResult] = {}
    states, jobs = [], []
    try:
        # host prep and character jobs per dialogue, inside the try: an
        # error in a later dialogue's prep must still come out as a
        # WaveFailure carrying the finished serial turns
        for d, (th, spec, seed) in enumerate(zip(theaters, specs, seeds)):
            t0 = time.perf_counter()
            plan = parse.convert_spec(spec, th.cfg.pipeline.height,
                                      th.cfg.pipeline.width)
            extra_neg = spec.get("extra_neg_prompt") or ""
            order, uplans, uidx = _dedup_plans(plan)
            if not uplans or len({p.obj_id for p in uplans}) != len(uplans):
                # no characters, or a repeated id whose DB-hit chain is
                # serial.  run_turn's finally flushes its DB writes even
                # when it fails, and those ids never enter `jobs`: roll
                # them back here so a quarantine rerun starts clean
                missing = [p.obj_id for p in plan.object_plans
                           if not th.db.has(p.obj_id)]
                try:
                    results[d] = th.run_turn(spec, seed, frozen_step_ratio)
                except BaseException:
                    for oid in missing:
                        if th.db.has(oid):
                            th.db.delete(oid)
                    raise
                continue
            djobs = _make_char_jobs(th, uplans, extra_neg, seed, uidx)
            states.append(dict(d=d, th=th, plan=plan, extra_neg=extra_neg,
                               seed=seed, order=order, uplans=uplans,
                               jobs=djobs, t0=t0))
            jobs.extend(djobs)
        if states:
            _run_wave_body(theaters[0], states, jobs, results,
                           frozen_step_ratio)
        return [results[d] for d in range(len(theaters))]
    except BaseException as e:
        # No DB write of a failed batch may stay: the quarantine reruns
        # the turns serially with the same seeds, and a stale entry would
        # make a first appearance a DB hit.  Undo the deferred writes and
        # the flushed ones (a device fault of the final pass surfaces at
        # the images' fetch, after the flush): a first appearance's id
        # present now was written by this wave (the reference deletes
        # before a retry, theatergen.py:158-159)
        for st in states:
            st["th"]._pending_saves.clear()
        for j in jobs:
            if not j["prep"]["hit"] and j["th"].db.has(j["oplan"].obj_id):
                j["th"].db.delete(j["oplan"].obj_id)
        if isinstance(e, Exception) and not isinstance(e, RankError):
            raise WaveFailure(results, e) from e
        raise


def _run_wave_body(lead: Theater, states: List[dict], jobs: List[dict],
                   results: Dict[int, TurnResult],
                   frozen_step_ratio: Optional[float]) -> None:
    """The batched part of a wave: one character batch, each dialogue's
    composition and final-pass inputs, one final batch; fills
    ``results``."""
    outs = lead._batched_char_exec(jobs)
    pos = 0
    for st in states:
        th = st["th"]
        couts = outs[pos:pos + len(st["jobs"])]
        pos += len(st["jobs"])
        cache = {(p.prompt, p.obj_id): o for p, o in zip(st["uplans"], couts)}
        st["chars"] = [cache[k] for k in st["order"]]
        st["fargs"], st["collage"] = th._final_stage(
            st["plan"], st["chars"], st["extra_neg"], st["seed"])
        ratio = (th.cfg.pipeline.frozen_step_ratio
                 if frozen_step_ratio is None else frozen_step_ratio)
        st["frozen"] = min(int(round(ratio * th.num_steps)),
                           th.char_sched.num_steps)

    # JAX theater.py:1045-1049: pad the wave to a dp multiple with
    # dialogue 0, whose padded outputs are dropped
    d = len(states)
    dp = lead.mesh.dp if lead.mesh is not None else 1
    padded = states + [states[0]] * (-(-d // dp) * dp - d)
    fargs = [st["fargs"] for st in padded]

    def stack(key):
        return torch.stack([f[key] for f in fargs])

    extra = feats = None
    if lead.is_xl:
        extra = {k: torch.stack([f["extra_cond"][k] for f in fargs])
                 for k in fargs[0]["extra_cond"]}
    if lead.use_t2i:
        feats = tuple(torch.cat(level) for level in
                      zip(*(f["adapter_feats"] for f in fargs)))
    gens = None
    if lead.char_sched.needs_noise:
        gens = [driver.NoiseStream(st["seed"], (2,))
                if lead.mesh is not None else
                noise_generator(lead.bundle.device, st["seed"], 2)
                for st in padded]
    with lead.timer.phase("final", sync=True):
        with lead.timer.phase("final.loop"):
            finals = _wave_final_runner(lead)(
                stack("composed"), stack("frozen_mask"),
                [st["frozen"] for st in padded], stack("ctx"),
                stack("cn_ctx"), stack("cond_img"),
                lead.cfg.pipeline.ip_scale_final,
                stack_inputs([f["gin"] for f in fargs]) if lead.guided
                else None, gens, extra, feats)[:d]
        lead.timer.count("loop.steps", lead.final_sched.num_steps)
        images = lead._decode_img(finals[:, 0])
        # the deferred DB writes: each fetch to the host waits on the
        # stream, behind the final pass and its decode, so each write runs
        # with nothing queued on the device
        for st in states:
            st["th"]._flush_db_saves()
        images = _to_host(images)

    for i, st in enumerate(states):
        chars = st["chars"]
        results[st["d"]] = TurnResult(
            image=images[i],
            so_images=[c["image"][0].float().cpu().numpy() for c in chars],
            collage=st["collage"].float().cpu().numpy(),
            seconds=time.perf_counter() - st["t0"],
            detections=[bool(c["detected"]) for c in chars],
            db_hits=[bool(c["hit"]) for c in chars])
