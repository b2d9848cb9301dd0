"""Latent-level golden parity against the torch reference (PyTorch), the
port of ``theatergen_tpu/eval/goldens.py``: the same on-disk format, read
and written by the same rules, consumed by the port's pipelines (which
run the card's kernels), plus :func:`export_self_case`, which writes a
case of each kind from the port's own pipelines on seeded inputs (the
self-test and ``chip_smoke.py`` write them under ``plain_path()`` and
consume them with the kernels).

The reference's RNG (``torch.manual_seed`` CPU generators,
``utils/latents.py:263,284``) cannot be reproduced by ``jax.random``, so
cross-framework parity needs *injection*: export the reference's actual
noise, text embeddings, and per-step latents once (on the weights
machine, ``scripts/export_reference_goldens.py``), then run our denoise
loop on the SAME inputs and compare latent-for-latent (SURVEY §7 "RNG
parity"; VERDICT r3 next-#2).

Five case kinds cover the reference's actual hot paths (VERDICT r4
next-#2):

``text2img``
    plain SD1.5 DDIM+CFG loop (bare UNet).
``character_ip``
    the per-character IP-Adapter pass: 81-token context (77 text + 4
    image tokens), decoupled image attention at ``ip_scale``
    (reference ``models/pipelines.py:175-490``,
    ``ip_adapter/attention_processor.py:396-553``).
``final_cn``
    the composed final pass: ControlNet residuals each step (text-only
    context — the reference's ``CNAttnProcessor`` drops IP tokens),
    IP-equipped UNet at ``ip_scale``, frozen-mask latent replacement
    from ``latents_all`` for the first ``frozen_steps`` steps
    (reference ``models/pipelines.py:592-857``, the ``:833-834``
    replacement).
``sdxl``
    SDXL base UNet with dual-tower context + pooled text + time_ids
    micro-conditioning (reference ``generate.py:103-133``).  Exported
    with the deterministic DDIM schedule: EulerAncestral draws
    per-step noise from a torch generator that jax cannot replay, so
    the golden isolates UNet/text-stack parity (ancestral *scheduler*
    arithmetic is golden-tested separately against diffusers configs
    in tests/test_scheduler.py).
``sdxl_ea``
    the same SDXL stack under the reference's ACTUAL sampler
    (EulerAncestral, ``generate.py:115-118``) with the per-step
    ancestral noise RECORDED into the bundle (``step_noise.npy``) and
    injected on replay — ``ops/scheduler.py::ea_step`` takes explicit
    noise, so the torch draw is replayed exactly and the comparison
    covers sampler + UNet together.

Golden bundle layout (one directory per case)::

    <goldens>/<case>/meta.json        prompt / negative / num_steps /
                                      guidance_scale / seed / model /
                                      kind / ip_scale / frozen_steps /
                                      controlnet_scale
    <goldens>/<case>/init_latents.npy [B, 4, h, w]    fp32, torch NCHW
    <goldens>/<case>/context.npy      [2B, L, C]      uncond ++ cond
                                      (diffusers order: negative first;
                                      81 tokens for character_ip/
                                      final_cn — text ++ ip tokens)
    <goldens>/<case>/trajectory.npy   [S+1, B, 4, h, w] — latent entering
                                      each step + the final latent
    <goldens>/<case>/image.png        the reference's decoded output
    -- character_ip extras --
    <goldens>/<case>/image_embeds.npy [1, D] CLIP image embedding fed to
                                      the IP projector (enables the
                                      own-projector isolation mode)
    -- final_cn extras --
    <goldens>/<case>/cn_context.npy   [2B, 77, C] text-only ControlNet ctx
    <goldens>/<case>/cond_image.npy   [H, W, 3] lineart conditioning
                                      image in [0, 1] (HWC — an image,
                                      not a latent)
    <goldens>/<case>/latents_all.npy  [S+1, B, 4, h, w] composed
                                      trajectory (slot 0 = fresh noise,
                                      1: = noised composed latents)
    <goldens>/<case>/frozen_mask.npy  [h, w] in {0, 1}
    -- sdxl / sdxl_ea extras --
    <goldens>/<case>/pooled.npy       [2B, D] pooled text embeds
    <goldens>/<case>/time_ids.npy     [2B, 6] micro-conditioning
    <goldens>/<case>/step_noise.npy   [S, B, 4, h, w] the ancestral
                                      noise drawn at each step
                                      (sdxl_ea only)

Latent-like arrays are torch-layout NCHW on disk so the exporter stays
a dumb ``save``; this module converts to NHWC at load time.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

KINDS = ("text2img", "character_ip", "final_cn", "sdxl", "sdxl_ea")


@dataclasses.dataclass
class GoldenCase:
    name: str
    prompt: str
    negative: str
    num_steps: int
    guidance_scale: float
    seed: int
    model: str                              # "sd15" | "sdxl"
    init_latents: np.ndarray                # [B, h, w, 4] NHWC fp32
    kind: str = "text2img"
    ip_scale: float = 0.0
    frozen_steps: int = 0
    controlnet_scale: float = 1.0
    context: Optional[np.ndarray] = None    # [2B, L, C] uncond ++ cond
    trajectory: Optional[np.ndarray] = None  # [S+1, B, h, w, 4] NHWC
    image: Optional[np.ndarray] = None      # [H, W, 3] float in [0, 1]
    image_embeds: Optional[np.ndarray] = None   # [1, D] (character_ip)
    cn_context: Optional[np.ndarray] = None     # [2B, 77, C] (final_cn)
    cond_image: Optional[np.ndarray] = None     # [H, W, 3] (final_cn)
    latents_all: Optional[np.ndarray] = None    # [S+1, B, h, w, 4] NHWC
    frozen_mask: Optional[np.ndarray] = None    # [h, w] (final_cn)
    pooled: Optional[np.ndarray] = None         # [2B, D] (sdxl)
    time_ids: Optional[np.ndarray] = None       # [2B, 6] (sdxl)
    step_noise: Optional[np.ndarray] = None     # [S, B, h, w, 4] (sdxl_ea)


def _to_nhwc(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(a, -3, -1))


def _to_nchw(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.moveaxis(a, -1, -3))


def list_cases(goldens_dir: str) -> List[str]:
    return sorted(
        d for d in os.listdir(goldens_dir)
        if os.path.isfile(os.path.join(goldens_dir, d, "meta.json"))
    )


def load_case(goldens_dir: str, name: str) -> GoldenCase:
    d = os.path.join(goldens_dir, name)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)

    def opt(fname, nhwc=False):
        p = os.path.join(d, fname)
        if not os.path.exists(p):
            return None
        a = np.load(p).astype(np.float32)
        return _to_nhwc(a) if nhwc else a

    init = np.load(os.path.join(d, "init_latents.npy")).astype(np.float32)
    image = None
    img_path = os.path.join(d, "image.png")
    if os.path.exists(img_path):
        from ..utils.vis import load_image_rgb

        image = load_image_rgb(img_path)
    kind = meta.get("kind", "text2img")
    if kind not in KINDS:
        raise ValueError(f"{name}: unknown golden kind {kind!r}")
    return GoldenCase(
        name=name,
        prompt=meta["prompt"],
        negative=meta.get("negative", ""),
        num_steps=int(meta["num_steps"]),
        guidance_scale=float(meta.get("guidance_scale", 7.5)),
        seed=int(meta.get("seed", 0)),
        model=meta.get("model", "sd15"),
        kind=kind,
        ip_scale=float(meta.get("ip_scale", 0.0)),
        frozen_steps=int(meta.get("frozen_steps", 0)),
        controlnet_scale=float(meta.get("controlnet_scale", 1.0)),
        init_latents=_to_nhwc(init),
        context=opt("context.npy"),
        trajectory=opt("trajectory.npy", nhwc=True),
        image=image,
        image_embeds=opt("image_embeds.npy"),
        cn_context=opt("cn_context.npy"),
        cond_image=opt("cond_image.npy"),
        latents_all=opt("latents_all.npy", nhwc=True),
        frozen_mask=opt("frozen_mask.npy"),
        pooled=opt("pooled.npy"),
        time_ids=opt("time_ids.npy"),
        step_noise=opt("step_noise.npy", nhwc=True),
    )


def save_case(
    goldens_dir: str,
    name: str,
    *,
    prompt: str,
    negative: str = "",
    num_steps: int,
    guidance_scale: float = 7.5,
    seed: int = 0,
    model: str = "sd15",
    kind: str = "text2img",
    ip_scale: float = 0.0,
    frozen_steps: int = 0,
    controlnet_scale: float = 1.0,
    init_latents: np.ndarray,               # NHWC (converted on write)
    context: Optional[np.ndarray] = None,
    trajectory: Optional[np.ndarray] = None,  # NHWC
    image: Optional[np.ndarray] = None,     # [H, W, 3] in [0, 1]
    image_embeds: Optional[np.ndarray] = None,
    cn_context: Optional[np.ndarray] = None,
    cond_image: Optional[np.ndarray] = None,
    latents_all: Optional[np.ndarray] = None,  # NHWC
    frozen_mask: Optional[np.ndarray] = None,
    pooled: Optional[np.ndarray] = None,
    time_ids: Optional[np.ndarray] = None,
    step_noise: Optional[np.ndarray] = None,   # NHWC
) -> str:
    """Write a case in the exporter's on-disk layout (NCHW for latents).
    Used by the self-test path (``scripts/torch_golden_parity.py --self``,
    :func:`export_self_case`): a case exported from the port's own pipeline
    must reproduce itself through the same code path a reference case
    takes."""
    assert kind in KINDS, kind
    d = os.path.join(goldens_dir, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(dict(prompt=prompt, negative=negative,
                       num_steps=num_steps, guidance_scale=guidance_scale,
                       seed=seed, model=model, kind=kind, ip_scale=ip_scale,
                       frozen_steps=frozen_steps,
                       controlnet_scale=controlnet_scale), f, indent=1)
    np.save(os.path.join(d, "init_latents.npy"),
            _to_nchw(np.asarray(init_latents, np.float32)))

    def put(fname, a, nchw=False):
        if a is None:
            return
        a = np.asarray(a, np.float32)
        np.save(os.path.join(d, fname), _to_nchw(a) if nchw else a)

    put("context.npy", context)
    put("trajectory.npy", trajectory, nchw=True)
    put("image_embeds.npy", image_embeds)
    put("cn_context.npy", cn_context)
    put("cond_image.npy", cond_image)
    put("latents_all.npy", latents_all, nchw=True)
    put("frozen_mask.npy", frozen_mask)
    put("pooled.npy", pooled)
    put("time_ids.npy", time_ids)
    put("step_noise.npy", step_noise, nchw=True)
    if image is not None:
        from ..utils.vis import save_image_rgb

        save_image_rgb(os.path.join(d, "image.png"), image)
    return d


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def _compare(traj, final_img, case: GoldenCase, extra: Dict) -> Dict:
    """Per-step latent MSE + image PSNR against the recorded reference."""
    out: Dict = {"case": case.name, "kind": case.kind,
                 "num_steps": case.num_steps, **extra}
    traj = np.asarray(traj, np.float32)
    if case.trajectory is not None:
        n = min(traj.shape[0], case.trajectory.shape[0])
        ref = case.trajectory[:n]
        ours = traj[:n]
        step_mse = np.mean((ours - ref) ** 2, axis=tuple(range(1, ref.ndim)))
        ref_var = float(np.var(ref[-1]))
        out["step_mse"] = [round(float(m), 6) for m in step_mse]
        out["final_mse"] = float(step_mse[-1])
        out["final_rel_mse"] = float(step_mse[-1] / max(ref_var, 1e-12))
    if case.image is not None and final_img is not None:
        img = np.asarray(final_img)
        h = min(img.shape[1], case.image.shape[0])
        w = min(img.shape[2], case.image.shape[1])
        out["image_psnr_db"] = round(
            psnr(img[0, :h, :w], case.image[:h, :w]), 2)
    return out


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _dev(bundle, a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=bundle.device)


def _decode(bundle, latents) -> np.ndarray:
    from ..pipelines import sd

    return _np(sd.decode_with(bundle.vae, bundle.cfg.vae.scaling_factor,
                              latents))


def run_text2img_case(bundle, case: GoldenCase, *,
                      use_own_text_encoder: bool = False) -> Dict:
    """Run the DDIM loop on the case's injected noise (+ context) and
    compare against the recorded reference trajectory/image.

    ``use_own_text_encoder=True`` re-encodes the prompt through the port's
    tokenizer + CLIP instead of injecting the exported embeddings —
    isolating text-stack parity from denoise parity (run both: if
    injected-context passes and own-encoder fails, the bug is in the
    text stack, not the UNet/scheduler)."""
    from ..ops import scheduler as sched_ops
    from ..pipelines import sd

    cfg = bundle.cfg
    if use_own_text_encoder or case.context is None:
        context = sd.encode_prompts(bundle, case.prompt, case.negative)
    else:
        context = _dev(bundle, case.context)
    sched = sched_ops.make_schedule(cfg.scheduler, case.num_steps)
    final, traj = sd.denoise(bundle.unet, sched,
                             _dev(bundle, case.init_latents), context,
                             case.guidance_scale, collect_trajectory=True)
    mode = ("own-encoder" if use_own_text_encoder or case.context is None
            else "injected")
    return _compare(_np(traj), _decode(bundle, final), case,
                    {"context": mode})


def run_character_case(bundle, case: GoldenCase, *,
                       use_own_projector: bool = False) -> Dict:
    """IP-Adapter character pass on injected 81-token context
    (reference ``generate_semantic_guidance``, ``models/pipelines.py:
    175-490``: CFG DDIM with decoupled image attention at
    ``case.ip_scale``).

    ``use_own_projector=True`` rebuilds the IP tokens from the recorded
    CLIP ``image_embeds`` through the port's ImageProjModel instead of
    injecting the exported ip tokens — isolating projector parity from
    UNet-attention parity."""
    from ..pipelines.character import (ip_context, make_character_pipeline,
                                       uncond_ip_features)

    text_len = bundle.cfg.text.max_length
    assert case.context is not None, "character_ip case needs context.npy"
    ctx = _dev(bundle, case.context)
    if use_own_projector:
        assert case.image_embeds is not None, \
            "own-projector mode needs image_embeds.npy"
        ctx = ip_context(bundle, ctx[:, :text_len],
                         _dev(bundle, case.image_embeds),
                         uncond_ip_features(bundle))
    run, _ = make_character_pipeline(bundle, case.num_steps, use_ip=True,
                                     guided=False,
                                     guidance_scale=case.guidance_scale)
    res = run(_dev(bundle, case.init_latents), ctx, case.ip_scale)
    mode = "own-projector" if use_own_projector else "injected"
    return _compare(_np(res.trajectory), _decode(bundle, res.latents), case,
                    {"context": mode, "ip_scale": case.ip_scale})


def run_final_case(bundle, case: GoldenCase) -> Dict:
    """Composed final pass on injected inputs (reference
    ``final_image_generation``, ``models/pipelines.py:592-857``):
    ControlNet on the lineart ``cond_image`` with the text-only
    ``cn_context``, IP-UNet on the 81-token ``context`` at
    ``case.ip_scale``, frozen-mask replacement from ``latents_all`` for
    the first ``frozen_steps`` steps (``:833-834``)."""
    from ..pipelines.final import make_final_pipeline

    for field in ("context", "cn_context", "cond_image", "latents_all",
                  "frozen_mask"):
        assert getattr(case, field) is not None, \
            f"final_cn case needs {field}.npy"
    run, _ = make_final_pipeline(
        bundle, case.num_steps, use_ip=True, use_controlnet=True,
        guided=False, guidance_scale=case.guidance_scale,
        controlnet_scale=case.controlnet_scale)
    final, traj = run(
        _dev(bundle, case.latents_all), _dev(bundle, case.frozen_mask),
        case.frozen_steps, _dev(bundle, case.context),
        _dev(bundle, case.cn_context), _dev(bundle, case.cond_image),
        case.ip_scale)
    return _compare(_np(traj), _decode(bundle, final), case,
                    {"context": "injected", "ip_scale": case.ip_scale,
                     "frozen_steps": case.frozen_steps})


def _xl_conditioning(bundle, case: GoldenCase):
    """The case's pooled text and time ids on the device (the full-frame
    time ids where the case has none)."""
    from ..pipelines.sdxl import default_time_ids

    pooled = _dev(bundle, case.pooled)
    if case.time_ids is not None:
        return pooled, _dev(bundle, case.time_ids)
    cfg = bundle.cfg
    return pooled, default_time_ids(cfg.pipeline.height, cfg.pipeline.width,
                                    pooled.shape[0], device=bundle.device)


def run_sdxl_case(bundle, case: GoldenCase) -> Dict:
    """SDXL base pass on injected dual-tower context + pooled text +
    time_ids (reference ``generate.py:103-133``), deterministic DDIM
    schedule (see module docstring on why not EulerAncestral)."""
    from ..ops import scheduler as sched_ops
    from ..pipelines import sd

    assert case.context is not None and case.pooled is not None, \
        "sdxl case needs context.npy + pooled.npy"
    sched = sched_ops.make_schedule(bundle.cfg.scheduler, case.num_steps)
    pooled, time_ids = _xl_conditioning(bundle, case)

    def unet(x, t, c, **kw):
        # cond-only sub-batches take the trailing rows (cond last)
        return bundle.unet(x, t, c, pooled_text=pooled[-x.shape[0]:],
                           time_ids=time_ids[-x.shape[0]:], **kw)

    final, traj = sd.denoise(unet, sched, _dev(bundle, case.init_latents),
                             _dev(bundle, case.context), case.guidance_scale,
                             collect_trajectory=True)
    return _compare(_np(traj), _decode(bundle, final), case,
                    {"context": "injected"})


def run_sdxl_ea_case(bundle, case: GoldenCase) -> Dict:
    """SDXL under EulerAncestral with the recorded per-step noise
    injected (reference ``generate.py:115-118``): ``ea_step`` takes
    explicit noise, so the torch generator's draws replay exactly."""
    from ..ops import scheduler as sched_ops
    from ..pipelines.sdxl import denoise_xl

    for field in ("context", "pooled", "step_noise"):
        assert getattr(case, field) is not None, \
            f"sdxl_ea case needs {field}.npy"
    sched = sched_ops.make_euler_ancestral_schedule(bundle.cfg.scheduler,
                                                    case.num_steps)
    pooled, time_ids = _xl_conditioning(bundle, case)
    final, traj = denoise_xl(
        bundle.unet, sched, None, _dev(bundle, case.init_latents),
        _dev(bundle, case.context), pooled, time_ids, case.guidance_scale,
        noise=_dev(bundle, case.step_noise), collect_trajectory=True)
    return _compare(_np(traj), _decode(bundle, final), case,
                    {"context": "injected", "sampler": "euler_ancestral"})


def run_case(bundle, case: GoldenCase, **kw) -> Dict:
    """Dispatch on ``case.kind`` (kw forwarded to the kind's runner)."""
    fn = {"text2img": run_text2img_case,
          "character_ip": run_character_case,
          "final_cn": run_final_case,
          "sdxl": run_sdxl_case,
          "sdxl_ea": run_sdxl_ea_case}[case.kind]
    return fn(bundle, case, **kw)


def verdict(metrics: Dict, *, final_rel_mse_max: float = 0.05,
            psnr_min: float = 25.0) -> bool:
    """Default pass policy: final latent relative MSE within 5% of the
    reference latent variance AND (when the reference image is present)
    PSNR ≥ 25 dB.  bf16-vs-fp16 accumulation across 50 steps makes
    bit-exactness impossible; these bounds are set so a *semantic* bug
    (wrong beta table, swapped uncond/cond, shifted timestep, wrong
    to_k_ip split, frozen-mask off-by-one) fails by orders of magnitude
    while numeric drift passes.  Tighten after the first real-weights
    run establishes the observed drift."""
    ok = True
    if "final_rel_mse" in metrics:
        ok &= metrics["final_rel_mse"] <= final_rel_mse_max
    if "image_psnr_db" in metrics:
        ok &= metrics["image_psnr_db"] >= psnr_min
    return bool(ok)


# ------------------------------------------------------ negative controls

# (kind, bug): each planted bug must fail its kind's verdict
NEGATIVE_CONTROLS = (("text2img", "guidance_1"), ("character_ip", "ip_scale_4"),
                     ("final_cn", "frozen_0"), ("sdxl", "swapped_context"),
                     ("text2img", "timestep_shift"))


def plant_bug(case, bundle, bug: str):
    """``(case, bundle)`` with ``bug`` planted, the semantic bugs the
    verdict exists to catch: ``guidance_1`` (guidance scale 1.0),
    ``ip_scale_4`` (IP scale 4.0), ``frozen_0`` (no frozen steps),
    ``swapped_context`` (the uncond and cond halves of the context
    swapped), ``timestep_shift`` (the timesteps one sampler step off: the
    scheduler's ``steps_offset`` moved by one step's stride).  Copies; the
    arguments are left as they are.  Works on either package's
    ``GoldenCase`` and bundle (both are dataclasses)."""
    if bug == "guidance_1":
        return dataclasses.replace(case, guidance_scale=1.0), bundle
    if bug == "ip_scale_4":
        return dataclasses.replace(case, ip_scale=4.0), bundle
    if bug == "frozen_0":
        return dataclasses.replace(case, frozen_steps=0), bundle
    if bug == "swapped_context":
        half = case.context.shape[0] // 2
        return dataclasses.replace(case, context=np.concatenate(
            [case.context[half:], case.context[:half]])), bundle
    if bug != "timestep_shift":
        raise ValueError(f"unknown bug {bug!r}")
    sc = bundle.cfg.scheduler
    shifted = dataclasses.replace(
        sc, steps_offset=sc.steps_offset
        + sc.num_train_timesteps // case.num_steps)
    return case, dataclasses.replace(
        bundle, cfg=dataclasses.replace(bundle.cfg, scheduler=shifted))


# ------------------------------------------------------- self-test cases

SELF_PROMPTS = {
    "text2img": ("a red knight", ""),
    "character_ip": ("full-body picture of a red knight",
                     "background, multiple objects, incomplete, lowres, "
                     "bad anatomy, low quality, obscured"),
    "final_cn": ("a knight and a dragon", "lowres"),
    "sdxl": ("a castle at dusk", ""),
    "sdxl_ea": ("a harbor at night", ""),
}


def export_self_case(bundle, goldens_dir: str, kind: str, *,
                     num_steps: int, seed: int = 0,
                     frozen_steps: Optional[int] = None,
                     guidance_scale: float = 7.5) -> str:
    """Run the port's own pipeline of ``kind`` on ``bundle`` and write the
    case ``self_{kind}`` (the JAX package's ``scripts/golden_parity.py
    --self`` exporters, with the port's pipelines): the prompts of
    :data:`SELF_PROMPTS`; the starting latents, the character pass's CLIP
    image embedding, the final pass's IP tokens, composed trajectory and
    hint, and the Euler-Ancestral step noise drawn from
    ``np.random.RandomState(seed)`` (so the CPU and the card draw the same
    inputs); ``ip_scale`` 0.4 (character) and 0.1 (final), the final
    pass's mask the top-left quarter frozen for ``frozen_steps`` (default
    ``num_steps // 2``).  SDXL kinds need an SDXL bundle, the SD1.5 kinds
    one with the IP-Adapter (and for ``final_cn`` the ControlNet).
    Returns the case's name."""
    from ..ops import scheduler as sched_ops
    from ..pipelines import sd
    from ..pipelines.character import ip_context, make_character_pipeline
    from ..pipelines.final import make_final_pipeline
    from ..pipelines.sdxl import (default_time_ids, denoise_xl,
                                  encode_prompts_xl)

    assert kind in KINDS, kind
    cfg = bundle.cfg
    rng = np.random.RandomState(seed)
    h, w = cfg.pipeline.latent_height, cfg.pipeline.latent_width
    prompt, negative = SELF_PROMPTS[kind]
    name = f"self_{kind}"
    common = dict(prompt=prompt, negative=negative, num_steps=num_steps,
                  guidance_scale=guidance_scale, seed=seed, kind=kind)
    lat0 = rng.standard_normal((1, h, w, 4)).astype(np.float32)
    if kind == "text2img":
        ctx = sd.encode_prompts(bundle, prompt, negative)
        final, traj = sd.denoise(
            bundle.unet, sched_ops.make_schedule(cfg.scheduler, num_steps),
            _dev(bundle, lat0), ctx, guidance_scale, collect_trajectory=True)
        extra = dict(context=_np(ctx))
    elif kind == "character_ip":
        embeds = rng.standard_normal(
            (1, cfg.ip_adapter.clip_embeddings_dim)).astype(np.float32)
        ctx = ip_context(bundle, sd.encode_prompts(bundle, prompt, negative),
                         _dev(bundle, embeds))
        run, _ = make_character_pipeline(bundle, num_steps, use_ip=True,
                                         guided=False,
                                         guidance_scale=guidance_scale)
        res = run(_dev(bundle, lat0), ctx, 0.4)
        final, traj = res.latents, res.trajectory
        extra = dict(ip_scale=0.4, context=_np(ctx), image_embeds=embeds)
    elif kind == "final_cn":
        frozen = num_steps // 2 if frozen_steps is None else frozen_steps
        text_ctx = sd.encode_prompts(bundle, prompt, negative)
        ip_tokens = rng.standard_normal(
            (2, cfg.ip_adapter.num_tokens,
             cfg.unet.cross_attention_dim)).astype(np.float32)
        ctx = torch.cat([text_ctx, _dev(bundle, ip_tokens)], dim=1)
        latents_all = rng.standard_normal(
            (num_steps + 1, 1, h, w, 4)).astype(np.float32)
        mask = np.zeros((h, w), np.float32)
        mask[: h // 2, : w // 2] = 1.0
        cond = rng.uniform(size=(cfg.pipeline.height, cfg.pipeline.width,
                                 3)).astype(np.float32)
        run, _ = make_final_pipeline(bundle, num_steps, use_ip=True,
                                     use_controlnet=True, guided=False,
                                     guidance_scale=guidance_scale)
        final, traj = run(_dev(bundle, latents_all), _dev(bundle, mask),
                          frozen, ctx, text_ctx, _dev(bundle, cond), 0.1)
        lat0 = latents_all[0]
        extra = dict(ip_scale=0.1, frozen_steps=frozen, context=_np(ctx),
                     cn_context=_np(text_ctx), cond_image=cond,
                     latents_all=latents_all, frozen_mask=mask)
    else:
        ctx, pooled = encode_prompts_xl(bundle, prompt, negative)
        time_ids = default_time_ids(cfg.pipeline.height, cfg.pipeline.width,
                                    2, device=bundle.device)
        extra = dict(model="sdxl", context=_np(ctx), pooled=_np(pooled),
                     time_ids=_np(time_ids))
        if kind == "sdxl":
            def unet(x, t, c, **kw):
                return bundle.unet(x, t, c, pooled_text=pooled[-x.shape[0]:],
                                   time_ids=time_ids[-x.shape[0]:], **kw)

            final, traj = sd.denoise(
                unet, sched_ops.make_schedule(cfg.scheduler, num_steps),
                _dev(bundle, lat0), ctx, guidance_scale,
                collect_trajectory=True)
        else:
            sched = sched_ops.make_euler_ancestral_schedule(cfg.scheduler,
                                                            num_steps)
            lat0 = (lat0 * np.float32(sched.init_noise_sigma)).astype(
                np.float32)
            noise = rng.standard_normal(
                (num_steps, 1, h, w, 4)).astype(np.float32)
            final, traj = denoise_xl(
                bundle.unet, sched, None, _dev(bundle, lat0), ctx, pooled,
                time_ids, guidance_scale, noise=_dev(bundle, noise),
                collect_trajectory=True)
            extra["step_noise"] = noise
    save_case(goldens_dir, name, init_latents=lat0, trajectory=_np(traj),
              image=_decode(bundle, final)[0], **common, **extra)
    return name
