"""The TheaterGen orchestrator: one turn → one character-consistent image.

The port of ``theatergen_tpu/theater.py`` on its serial path (the
reference's ``theatergen.run``, ``theatergen.py:278-488``, with
``generate_single_object_with_box`` and ``get_masked_latents_all_list``):

- each unique character of a turn (:func:`_dedup_plans`) gets a
  50-step IP-Adapter pass conditioned on its character-DB entry (IP scale
  0.4 on a hit, 0 with placeholder features on a miss), the reference
  maps of its word token captured at every step;
- its image is detected from those maps (``perception.detector``) and
  regenerated from fresh noise up to :data:`MAX_REGEN_ATTEMPTS` times;
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
turn's seed.  The starting latents come from one generator seeded with
the seed itself, in a fixed order: per character attempt the background
and then the foreground noise, then the composition's background noise
(or, in a turn without characters, its starting latents).  A sampler that
draws noise each step (Euler-Ancestral, LCM) takes it from a stream of its
own (:func:`noise_generator`): ``(seed, 1, character index, attempt)`` for
a character attempt (the index of the character's first occurrence in the
turn's spec), ``(seed, 2)`` for the final pass and ``(seed, 3)`` for a
turn without characters.  DDIM draws nothing per step.  These streams
cannot reproduce ``jax.random``'s, so parity with the JAX package goes
through injected noise.  Everything stays on the bundle's device until
the turn's images are fetched.

With ``guided`` (the CLI's ``--guidance``) every character attempt, the
background-only turn and the final pass descend their latents on the
guidance energy (``pipelines/guidance.py``): a character on its centred
box and its phrase's tokens, the final pass on the layout's boxes and each
object's tokens in the overall prompt, with attention transfer from each
character's reference maps, per step (``attn_transfer="per_step"``, the
reference's) or their step mean (``"aggregate"``).  The batched character
mode and meshes raise until their ROADMAP item lands.
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
from .pipelines.character import (encode_ip_image, ip_context,
                                  make_character_pipeline,
                                  uncond_ip_features)
from .pipelines.final import make_final_pipeline
from .pipelines.guidance import GuidanceInputs
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
    tuple."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


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
    [h, w], pixel mask [H, W])``, {0, 1} fp32."""
    agg = torch.zeros((h, w), dtype=torch.float32, device=hint.device)
    for m in maps:
        mm = m.float().mean(0)
        side = int(round(mm.shape[0] ** 0.5))
        agg = agg + G.resize_bilinear(mm.reshape(side, side), h, w)
    agg = agg / (agg.max() + 1e-8)
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
        if mesh is not None or batch_characters:
            raise NotImplementedError(
                "the batched character mode and meshes are not ported yet "
                "(ROADMAP §1 item 5)")
        if bundle.unet_ip is None:
            raise ValueError("Theater: the bundle needs the IP UNet "
                             "(init_bundle(..., with_ip=True))")
        cfg = bundle.cfg
        self.bundle, self.db, self.task, self.cfg = bundle, db, task, cfg
        self.guided, self.attn_transfer = guided, attn_transfer
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
        self.final_run, _ = make_final_pipeline(
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

    def _bg_latents(self, gen: torch.Generator) -> torch.Tensor:
        """Scaled unit noise [1, h, w, 4]: the composition's background, or
        the starting latents of a turn without characters."""
        pl = self.cfg.pipeline
        return sd.seeded_latents(gen, 1, pl.latent_height, pl.latent_width,
                                 device=self.bundle.device) * self._init_sigma

    def _character_finish(self, plan: parse.ObjectPlan, prep: dict, result,
                          image, agg, detected_ok: bool, det_box) -> dict:
        """Masks, the deferred DB write of a new character, and the
        character's record (theatergen.py:158-201)."""
        img_embed = prep["img_embed"]
        with self.timer.phase("char.masks"):
            m_lat, m_pix = self._extract_masks(agg, image, det_box)
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
                            gen: torch.Generator, seed: int,
                            idx: int) -> dict:
        """One character with detect-and-regenerate (theatergen.py:43-201):
        a fresh draw per attempt, up to MAX_REGEN_ATTEMPTS; attempt ``a``
        steps with the noise stream ``(seed, 1, idx, a)``."""
        prep = self._character_prep(plan, extra_neg)
        detected_ok = False
        result = image = agg = detection = None
        for attempt in range(MAX_REGEN_ATTEMPTS):
            init_lat = self._char_input_latents(gen, prep["centered"])
            with self.timer.phase("char.denoise_decode", sync=True):
                result = self.char_run(
                    init_lat, prep["ctx"], prep["ip_scale"],
                    prep["word_token"], self._noise_gen(seed, 1, idx,
                                                        attempt),
                    extra_cond=prep["extra_cond"], gin=prep["gin"])
                image = self._decode_img(result.latents)
                agg = self._aggregate_attn(result.ref_attn)
            with self.timer.phase("char.detect"):
                detection = det.attention_detect(agg, None)
                detected_ok = bool(detection.ok)
            if detected_ok:
                break
        det_box = (detection.box if detected_ok
                   else prep["centered"].to(self.bundle.device))
        return self._character_finish(plan, prep, result, image, agg,
                                      detected_ok, det_box)

    # ------------------------------------------------------------------ turn

    def _flush_db_saves(self) -> None:
        """Fetch and persist the deferred DB writes; called once the final
        pass is dispatched, and in run_turn's ``finally`` so the DB is
        durable at the end of every turn."""
        while self._pending_saves:
            obj_id = next(iter(self._pending_saves))
            image, emb = self._pending_saves.pop(obj_id)
            self.db.save(obj_id, image[0].float().cpu().numpy(),
                         emb.float().cpu().numpy().reshape(-1))

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
        t_start = time.time()
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
        gen = torch.Generator(device=b.device).manual_seed(seed)

        order, unique_plans, unique_idx = _dedup_plans(plan)
        cache: Dict[Tuple[str, int], dict] = {}
        for oplan, idx in zip(unique_plans, unique_idx):
            with self.timer.phase("character"):
                cache[(oplan.prompt, oplan.obj_id)] = (
                    self._generate_character(oplan, extra_neg, gen, seed,
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
            res = self.char_run(self._bg_latents(gen), ctx, 0.0, 0,
                                self._noise_gen(seed, 3),
                                extra_cond=extra_cond, gin=gin)
            img = self._decode_img(res.latents)[0].float().cpu().numpy()
            return TurnResult(img, [], img, time.time() - t_start, [], [])

        fargs, collage = self._final_stage(plan, chars, extra_neg, gen)
        with self.timer.phase("final", sync=True):
            final, _ = self.final_run(
                fargs["composed"], fargs["frozen_mask"], frozen_steps,
                fargs["ctx"], fargs["cn_ctx"], fargs["cond_img"],
                cfg.pipeline.ip_scale_final, self._noise_gen(seed, 2),
                extra_cond=fargs["extra_cond"],
                adapter_feats=fargs["adapter_feats"], gin=fargs["gin"])
            image = self._decode_img(final)
            # the deferred DB writes: their feature programs precede the
            # final pass in the device queue
            self._flush_db_saves()

        return TurnResult(
            image=image[0].float().cpu().numpy(),
            so_images=[c["image"][0].float().cpu().numpy() for c in chars],
            collage=collage.float().cpu().numpy(),
            seconds=time.time() - t_start,
            detections=[bool(c["detected"]) for c in chars],
            db_hits=[bool(c["hit"]) for c in chars])

    def _final_stage(self, plan: parse.TurnPlan, chars: List[dict],
                     extra_neg: str, gen: torch.Generator):
        """Composition and the final pass's conditioning for a turn whose
        characters are generated (theatergen.py:417-477).  Returns
        ``(final-run inputs, collage)``."""
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
                boxes, torch.arange(k, device=dev) < n, self._bg_latents(gen))

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
