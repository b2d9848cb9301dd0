"""The port's SDXL story turn against the JAX package at ``tiny_xl_config()``
in fp32 on the CPU, on the same seeded trees carried across by
``Bundle.load_flax``, with numpy inputs and the JAX draws injected:

- ``pixel_unshuffle`` and the T2I-Adapter (a negative control shows that
  ``F.pixel_unshuffle``'s channel order fails the bound);
- the XL IP UNet with micro-conditioning and the adapter's
  ``level_residuals``, full and DeepCache-shallow at both cache levels;
- the character and final runners with ``extra_cond`` (and, in the final
  pass, ``adapter_feats``): Euler-Ancestral with CFG up to the CFG
  cutoff and cond-only after it, its per-step draws ``fold_in(rng, i)``
  injected, and LCM under DeepCache; the final runner also on an XL
  bundle with a
  ControlNet and no adapter (Euler-Ancestral, exact CFG);
- ``Text2ImgXL`` with a hint, under Euler-Ancestral and LCM;
- ``Theater.run_turn`` over dialogue_0's four turns, compared as
  ``test_torch_port_turn.py::_compare`` does.  Its starting latents come
  from one numpy stream on both sides (that file's method-level
  injection), and each runner call's Euler-Ancestral draws are the JAX
  runner's: the JAX runners are wrapped to record the key each call gets
  and the port's to take the draws of that key.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_port_knobs as knob_tests
import test_torch_port_turn as turn_tests
from test_torch_port_models import random_params
from test_torch_port_samplers import _close, jax_noise
from theatergen_tpu import config as jcfg
from theatergen_tpu.models.clip import CLIPTextEncoder as JText
from theatergen_tpu.models.clip import CLIPVisionEncoder as JVision
from theatergen_tpu.models.controlnet import ControlNet as JControlNet
from theatergen_tpu.models.ip_adapter import ImageProjModel as JImageProj
from theatergen_tpu.models.t2i_adapter import T2IAdapter as JAdapter
from theatergen_tpu.models.t2i_adapter import pixel_unshuffle as jpu
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.ops import latents as JL
from theatergen_tpu.pipelines import character as jchar
from theatergen_tpu.pipelines import final as jfinal
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu.pipelines import sdxl as jsdxl
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.models import t2i_adapter as tada
from theatergen_tpu_torch.pipelines import character as tchar
from theatergen_tpu_torch.pipelines import final as tfinal
from theatergen_tpu_torch.pipelines import sd as tsd
from theatergen_tpu_torch.pipelines import sdxl as tsdxl
from theatergen_tpu_torch.pipelines.bundle import init_bundle

torch.set_num_threads(1)

CFG = jcfg.tiny_xl_config()
PL = CFG.pipeline
h = w = PL.latent_height          # 8² latents
H = W = PL.height                 # 16 px canvas
CTX = CFG.unet.cross_attention_dim
L = CFG.text.max_length
STEPS = 4
FROZEN = 2
# the adapter and the UNet's eps, fp32: summation order only
FEAT_TOL = 1e-4
# a runner's trajectory: fp32 through 4 steps of CFG 7.5 from EA's
# sigma_0-scaled start (latents O(10)), so bound·max(|ref|, 1)
TRAJ_TOL = 2e-4


def _np(t):
    return t.detach().float().cpu().numpy()


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


@functools.lru_cache(maxsize=None)
def _base_bundles():
    """The JAX bundle and the port's on the same seeded trees: both text
    towers, the base and the IP UNet (4 IP tokens at the towers' width),
    the IP projector, the vision tower, the VAE, the T2I-Adapter and the
    XL ControlNet."""
    zeros = functools.partial(jnp.zeros, dtype=jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    xl = dict(pooled_text=zeros((1, CFG.text2.projection_dim)),
              time_ids=zeros((1, 6)))
    text, text2 = JText(CFG.text), JText(CFG.text2)
    ids = jnp.zeros((1, L), jnp.int32)
    tp, tp2 = random_params(text, 2, ids), random_params(text2, 3, ids)
    unet = JUNet(CFG.unet)
    up = random_params(unet, 0, zeros((1, h, w, 4)), t0, zeros((1, L, CTX)),
                       **xl)
    unet_ip = JUNet(dataclasses.replace(CFG.unet, ip_num_tokens=4))
    uip = random_params(unet_ip, 1, zeros((1, h, w, 4)), t0,
                        zeros((1, L + 4, CTX)), **xl)
    proj = JImageProj(CFG.ip_adapter)
    pp = random_params(proj, 4, zeros((1, CFG.ip_adapter.clip_embeddings_dim)))
    vis = JVision(CFG.vision)
    vp = random_params(vis, 5, zeros((1, 32, 32, 3)))
    vae = JVAE(CFG.vae)
    vaep = random_params(vae, 6, zeros((1, H, W, 3)))
    ada = JAdapter(CFG.unet, downscale=PL.vae_scale)
    ap = random_params(ada, 7, zeros((1, H, W, 3)))
    cn = JControlNet(CFG.controlnet)
    cp = random_params(cn, 8, zeros((1, h, w, 4)), t0, zeros((1, L, CTX)),
                       zeros((1, H, W, 3)))
    jb = JBundle(cfg=CFG, tokenizer=jtok.HashTokenizer(1024), unet=unet,
                 unet_params=up, vae=vae, vae_params=vaep, text=text,
                 text_params=tp, text2=text2, text2_params=tp2,
                 unet_ip=unet_ip, unet_ip_params=uip, vision=vis,
                 vision_params=vp, image_proj=proj, image_proj_params=pp,
                 t2i_adapter=ada, t2i_adapter_params=ap, controlnet=cn,
                 controlnet_params=cp)
    tb = init_bundle(tcfg.tiny_xl_config(), 0, device="cpu", with_ip=True,
                     with_vision=True, with_controlnet=True,
                     with_t2i_adapter=True).load_flax(
        unet=up, vae=vaep, text=tp, text2=tp2, unet_ip=uip, image_proj=pp,
        vision=vp, t2i_adapter=ap, controlnet=cp)
    return jb, tb


@functools.lru_cache(maxsize=None)
def _bundles(kind: str = "euler_ancestral"):
    """The shared weights under the sampler ``kind``."""
    jb, tb = _base_bundles()
    if kind == PL.scheduler_type:
        return jb, tb
    return tuple(dataclasses.replace(b, cfg=dataclasses.replace(
        b.cfg, pipeline=dataclasses.replace(b.cfg.pipeline,
                                            scheduler_type=kind)))
        for b in (jb, tb))


def _hint(seed=11):
    return np.random.RandomState(seed).rand(H, W, 3).astype(np.float32)


def _extra_cond(rng):
    """SDXL micro-conditioning of a CFG pair: pooled text and the
    full-frame time ids (uncond row first)."""
    pooled = rng.randn(2, CFG.text2.projection_dim).astype(np.float32)
    tids = np.asarray(jsdxl.default_time_ids(H, W, 2))
    return (dict(pooled_text=jnp.asarray(pooled), time_ids=jnp.asarray(tids)),
            dict(pooled_text=torch.from_numpy(pooled),
                 time_ids=torch.from_numpy(tids.copy())))


def _jax_feats(jb, hint):
    return jb.t2i_adapter.apply({"params": jb.t2i_adapter_params},
                                jnp.asarray(hint)[None])


# ---------------------------------------------------------------------------
# the T2I-Adapter and the UNet's level residuals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,f", [(3, 2), (3, 8), (5, 4)])
def test_pixel_unshuffle_matches(c, f):
    """The JAX channel order (fy, fx, c), bit for bit; F.pixel_unshuffle's
    (c, fy, fx) differs wherever C > 1."""
    x = np.random.RandomState(c * f).randn(2, 4 * f, 2 * f, c).astype(
        np.float32)
    ref = np.asarray(jpu(jnp.asarray(x), f))
    got = tada.pixel_unshuffle(_nchw(x), f).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, ref)
    wrong = F.pixel_unshuffle(_nchw(x), f).permute(0, 2, 3, 1).numpy()
    assert np.abs(wrong - ref).max() > 0.1


def test_t2i_adapter_matches(monkeypatch):
    """The adapter's per-level features of a seeded hint (batch 2), NCHW,
    within FEAT_TOL of JAX's; shapes are the UNet's levels at the latent
    grid.  With F.pixel_unshuffle's channel order in its place the
    features miss the bound."""
    jb, tb = _bundles()
    hint = np.stack([_hint(1), _hint(2)])
    ref = _jax_feats(jb, hint[0]), jb.t2i_adapter.apply(
        {"params": jb.t2i_adapter_params}, jnp.asarray(hint))
    got = tb.t2i_adapter(_nchw(hint))
    assert [tuple(f.shape) for f in got] == [(2, 32, 8, 8), (2, 64, 4, 4)]
    for g, r in zip(got, ref[1]):
        np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)), np.asarray(r),
                                   atol=FEAT_TOL)
    one = tsdxl.adapter_features(tb, torch.from_numpy(hint[0]))
    for g, r in zip(one, ref[0]):
        np.testing.assert_allclose(_np(g.permute(0, 2, 3, 1)), np.asarray(r),
                                   atol=FEAT_TOL)
    monkeypatch.setattr(tada, "pixel_unshuffle", F.pixel_unshuffle)
    wrong = tb.t2i_adapter(_nchw(hint))
    assert float((wrong[0] - got[0]).abs().max()) > 100 * FEAT_TOL


@pytest.mark.parametrize("shallow", [None, 1, 2])
def test_unet_level_residuals_match(shallow):
    """The XL IP UNet (ip_scale 0.4, pooled text, time ids) with the
    adapter's features as level residuals, against JAX within FEAT_TOL:
    the full forward (``shallow`` None), and DeepCache's shallow forward
    at cache level 1 and 2 from the JAX full forward's cache.  The
    residuals move the full forward, and the shallow one at level 2
    (at level 1 the only level that runs ends without a downsampler, so
    its residual reaches nothing, in both packages)."""
    jb, tb = _bundles()
    rng = np.random.RandomState(20)
    x = rng.randn(2, h, w, 4).astype(np.float32)
    t = np.array([601, 601], np.int32)
    ctx = rng.randn(2, L + 4, CTX).astype(np.float32)
    jxc, txc = _extra_cond(rng)
    hint = _hint(3)
    feats_j = _jax_feats(jb, hint)
    feats_j2 = tuple(jnp.concatenate([f, f]) for f in feats_j)
    feats_t = tada.tile_features(
        tsdxl.adapter_features(tb, torch.from_numpy(hint)), 2)
    jkw = dict(ip_scale=jnp.float32(0.4), level_residuals=feats_j2, **jxc)
    tkw = dict(ip_scale=torch.tensor(0.4), level_residuals=feats_t, **txc)

    def japply(**kw):
        return jb.unet_ip.apply({"params": jb.unet_ip_params},
                                jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(ctx), **kw)

    args = (_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    if shallow is None:
        ref = np.asarray(japply(**jkw))
        got = tb.unet_ip(*args, **tkw)
        plain = tb.unet_ip(*args, **dict(tkw, level_residuals=None))
    else:
        _, cache = japply(return_deep_cache=True, cache_level=shallow, **jkw)
        ref = np.asarray(japply(deep_cache=cache, cache_level=shallow,
                                **jkw))
        cache_t = _nchw(cache)
        got = tb.unet_ip(*args, deep_cache=cache_t, cache_level=shallow,
                         **tkw)
        plain = tb.unet_ip(*args, deep_cache=cache_t, cache_level=shallow,
                           **dict(tkw, level_residuals=None))
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), ref,
                               atol=FEAT_TOL)
    moved = float((got - plain).abs().max())
    assert moved > 1e-3 if shallow != 1 else moved == 0.0


# ---------------------------------------------------------------------------
# the runners
# ---------------------------------------------------------------------------

# (sampler, CFG cutoff, DeepCache interval): Euler-Ancestral's CFG steps,
# then cond-only ones; LCM's cond-only steps, full and shallow
RUNNER_CASES = [("euler_ancestral", 0.5, None), ("lcm", None, 2)]


@functools.lru_cache(maxsize=None)
def _jax_char_runner(kind, cutoff, dc):
    jb, _ = _bundles(kind)
    return jchar.make_character_pipeline(
        jb, STEPS, use_ip=True, capture_ref_attn=True,
        cfg_cutoff_fraction=cutoff, deepcache_interval=dc)[0]


@pytest.mark.parametrize("kind,cutoff,dc", RUNNER_CASES)
def test_character_runner_with_extra_cond_matches(kind, cutoff, dc):
    """The XL character pass at ip_scale 0.4 with pooled text and time ids
    (a cond-only step takes their trailing row): trajectory and final
    latents within TRAJ_TOL·max(|ref|, 1), the reference maps of every
    step within 1e-5, against the JAX runner with its draws injected."""
    jb, tb = _bundles(kind)
    rng = np.random.RandomState(31)
    run_t, sampler = tchar.make_character_pipeline(
        tb, STEPS, use_ip=True, capture_ref_attn=True,
        cfg_cutoff_fraction=cutoff, deepcache_interval=dc)
    lat = (rng.randn(1, h, w, 4) * sampler.init_noise_sigma).astype(
        np.float32)
    ctx = rng.randn(2, L + 4, CTX).astype(np.float32)
    jxc, txc = _extra_cond(rng)
    key = jax.random.key(4)
    res_j = _jax_char_runner(kind, cutoff, dc)(
        jb.unet_ip_params, jnp.asarray(lat), jnp.asarray(ctx),
        jnp.float32(0.4), None, rng=key, extra_cond=jxc)
    noise = torch.from_numpy(jax_noise(key, STEPS, lat.shape))
    res_t = run_t(torch.from_numpy(lat), torch.from_numpy(ctx), 0.4,
                  noise=noise, extra_cond=txc)
    _close(_np(res_t.trajectory), res_j.trajectory, TRAJ_TOL, "trajectory")
    _close(_np(res_t.latents), res_j.latents, TRAJ_TOL, "final")
    assert len(res_t.ref_attn) == len(res_j.ref_attn) == 3
    for mt, mj in zip(res_t.ref_attn, res_j.ref_attn):
        _close(_np(mt), mj, 1e-5, "ref maps")
    with pytest.raises(ValueError, match="pooled_text"):
        run_t(torch.from_numpy(lat), torch.from_numpy(ctx), 0.4, noise=noise)


@functools.lru_cache(maxsize=None)
def _jax_final_runner(kind, cutoff, dc, use_cn):
    jb, _ = _bundles(kind)
    return jfinal.make_final_pipeline(
        jb, STEPS, use_ip=True, use_controlnet=use_cn,
        cfg_cutoff_fraction=cutoff, deepcache_interval=dc)[0]


@pytest.mark.parametrize("kind,cutoff,dc,use_cn", [
    case + (False,) for case in RUNNER_CASES] + [
    ("euler_ancestral", None, None, True)])
def test_final_runner_xl_matches(kind, cutoff, dc, use_cn):
    """The XL final pass at ip_scale 0.1 with pooled text and time ids,
    conditioned on the T2I-Adapter's features of the hint (repeated over
    the CFG pair, as they are on a cond-only step) or, on an XL bundle
    with a ControlNet and no adapter, on the ControlNet (which takes no
    micro-conditioning): trajectory and final latents within
    TRAJ_TOL·max(|ref|, 1) of the JAX runner with its draws injected;
    below FROZEN the masked region is the composition's, bit for bit."""
    jb, tb = _bundles(kind)
    rng = np.random.RandomState(32)
    run_t, sampler = tfinal.make_final_pipeline(
        tb, STEPS, use_ip=True, use_controlnet=use_cn,
        cfg_cutoff_fraction=cutoff, deepcache_interval=dc)
    la = rng.randn(STEPS + 1, 1, h, w, 4).astype(np.float32)
    la[0] *= sampler.init_noise_sigma
    fm = np.zeros((h, w), np.float32)
    fm[2:6, 1:5] = 1.0
    ctx = rng.randn(2, L + 4, CTX).astype(np.float32)
    cn_ctx = rng.randn(2, L, CTX).astype(np.float32)
    jxc, txc = _extra_cond(rng)
    cond = _hint(5)
    feats_j = feats_t = None
    if not use_cn:
        feats_j = _jax_feats(jb, cond)
        feats_t = tsdxl.adapter_features(tb, torch.from_numpy(cond))
    key = jax.random.key(5)
    fj, trj = _jax_final_runner(kind, cutoff, dc, use_cn)(
        jb.unet_ip_params, jb.controlnet_params if use_cn else None,
        jnp.asarray(la), jnp.asarray(fm), jnp.int32(FROZEN),
        jnp.asarray(ctx), jnp.asarray(cn_ctx), jnp.asarray(cond),
        jnp.float32(0.1), rng=key, extra_cond=jxc, adapter_feats=feats_j)
    noise = torch.from_numpy(jax_noise(key, STEPS, la.shape[1:]))
    ft, trt = run_t(torch.from_numpy(la), torch.from_numpy(fm), FROZEN,
                    torch.from_numpy(ctx), torch.from_numpy(cn_ctx),
                    torch.from_numpy(cond), 0.1, noise=noise,
                    extra_cond=txc, adapter_feats=feats_t)
    _close(_np(trt), trj, TRAJ_TOL, "trajectory")
    _close(_np(ft), fj, TRAJ_TOL, "final")
    on = torch.from_numpy(fm > 0)
    for j in range(FROZEN + 1):
        torch.testing.assert_close(trt[j, 0][on], torch.from_numpy(la[j, 0])[
            on], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["euler_ancestral", "lcm"])
def test_text2img_xl_with_a_hint_matches(kind, monkeypatch):
    """Text2ImgXL with a T2I-Adapter hint: the adapter once, its features
    repeated over the CFG batch (EA, 4 steps, CFG 7.5) or given as they
    are to the LCM loop's cond-only batch, against the JAX request with
    its starting latents (``seeded_latents(split(rng)[0])``) and per-step
    draws injected: image within 1e-4 (values in [0, 1]).  The hint moves
    the image; a bundle without the adapter refuses one."""
    jb, tb = _bundles(kind)
    rng = jax.random.key(9)
    lat_rng, anc_rng = jax.random.split(rng)
    lat = np.asarray(jsd.seeded_latents(lat_rng, 1, h, w))
    if kind == "lcm":
        noise = jax_noise(anc_rng, STEPS, (1, h, w, 4))
    else:
        keys, key = [], anc_rng
        for _ in range(STEPS):
            key, nkey = jax.random.split(key)
            keys.append(nkey)
        noise = np.stack([np.asarray(jax.random.normal(
            k, (1, h, w, 4), jnp.float32)) for k in keys])
    hint = _hint(6)
    prompt = "a red knight rides through a dark forest"
    ref = jsdxl.Text2ImgXL(jb, num_steps=STEPS)(rng, prompt,
                                                hint=jnp.asarray(hint))
    monkeypatch.setattr(tsd, "seeded_latents",
                        lambda *a, **k: torch.tensor(lat))
    pipe = tsdxl.Text2ImgXL(tb, num_steps=STEPS)
    got = pipe(None, prompt, hint=torch.from_numpy(hint),
               noise=torch.from_numpy(noise))
    assert got.shape == (1, H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    bare = pipe(None, prompt, noise=torch.from_numpy(noise))
    assert float((bare - got).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="adapter"):
        tsdxl.Text2ImgXL(dataclasses.replace(tb, t2i_adapter=None),
                         num_steps=STEPS)(None, prompt,
                                          hint=torch.from_numpy(hint),
                                          noise=torch.from_numpy(noise))


# ---------------------------------------------------------------------------
# the turn
# ---------------------------------------------------------------------------


def _inject_ancestral_draws(jt, tt):
    """Each JAX runner call records its key's per-step draws, and the
    port's runner calls (in the same order) take them."""
    queue = collections.deque()
    for name in ("char_run", "final_run"):
        jreal, treal = getattr(jt, name), getattr(tt, name)

        def jrun(*a, rng=None, _real=jreal, **k):
            queue.append(jax_noise(rng, STEPS, (1, h, w, 4)))
            return _real(*a, rng=rng, **k)

        def trun(*a, _real=treal, _name=name, **k):
            a = list(a)
            a[7 if _name == "final_run" else 4] = None    # the generator
            return _real(*a, noise=torch.from_numpy(queue.popleft()), **k)

        setattr(jt, name, jrun)
        setattr(tt, name, trun)
    return queue


def _scale_starts(jt, tt):
    """Scale the injected starting latents by the sampler's
    init_noise_sigma on both sides, as the Theaters' own draws are
    (test_torch_port_turn.py injects them unscaled: its DDIM has sigma
    1)."""
    sigma = np.float32(jt._init_sigma)
    assert sigma == np.float32(tt._init_sigma) and sigma > 1
    jlat, tlat, tbg = jt._char_lat_fn(), tt._char_input_latents, \
        tt._bg_latents
    jt._char_lat_fn = lambda: lambda *a: jlat(*a) * sigma
    tt._char_input_latents = lambda *a: tlat(*a) * float(sigma)
    tt._bg_latents = lambda gen: tbg(gen) * float(sigma)


def test_run_turn_xl_matches_over_dialogue_0(tmp_path, monkeypatch):
    """dialogue_0's four turns through both Theaters on the tiny XL bundle
    (two towers, micro-conditioning through every character attempt and
    the final pass, the T2I-Adapter on the lineart hint in place of the
    ControlNet, 4 Euler-Ancestral steps): image, character images and
    collage within IMG_TOL (1e-4), masks, detections and DB hits equal,
    DB images within one 8-bit step and features 1e-4, phase counts and
    draws equal."""
    jb, tb = _bundles()
    monkeypatch.setattr(JL, "align_with_boxes",
                        turn_tests._align_hw(JL.align_with_boxes))
    monkeypatch.setattr(turn_tests, "_bundles", lambda: (jb, tb))
    jt, tt, rec, noise = turn_tests._theaters(tmp_path, monkeypatch)
    assert jt.use_t2i and tt.use_t2i
    assert not jt.use_controlnet and not tt.use_controlnet
    _scale_starts(jt, tt)
    queue = _inject_ancestral_draws(jt, tt)
    hits = [[False, False], [True], [True], [True, False]]
    specs = turn_tests._specs()
    for t_idx, spec in enumerate(specs):
        seed = tgen.turn_seed(0, 0, t_idx, 0)
        jr = jt.run_turn(spec, seed, frozen_step_ratio=0.5)
        tr = tt.run_turn(spec, seed, frozen_step_ratio=0.5)
        assert tr.db_hits == hits[t_idx] and not queue
        turn_tests._compare(jr, tr, rec, noise, jt, tt, len(hits[t_idx]))
    # a turn without characters: txt2img through the XL IP UNet at scale 0,
    # with the overall prompt's micro-conditioning
    spec = dict(specs[2], gen_boxes=[], obj_ids=[])
    jr, tr = jt.run_turn(spec, 5), tt.run_turn(spec, 5)
    assert tr.so_images == [] and not queue
    turn_tests._compare(jr, tr, rec, noise, jt, tt, 0)


def test_t2i_adapter_is_drawn_last():
    """with_t2i_adapter draws the adapter after every other part: the
    rest of a seed's bundle keeps its weights; the adapter takes the
    UNet's dtype and names its parameters by level."""
    kw = dict(device="cpu", with_ip=True, with_vision=True,
              with_controlnet=True)
    a = init_bundle(tcfg.tiny_xl_config(), 3, **kw)
    b = init_bundle(tcfg.tiny_xl_config(), 3, with_t2i_adapter=True, **kw)
    assert a.t2i_adapter is None
    for name in ("unet", "unet_ip", "vae", "text", "text2", "vision",
                 "image_proj", "controlnet"):
        for k, v in getattr(a, name).state_dict().items():
            torch.testing.assert_close(getattr(b, name).state_dict()[k], v,
                                       rtol=0, atol=0)
    names = set(b.t2i_adapter.state_dict())
    assert {"in_conv.0.weight", "in_conv.1.bias", "body.1.1.block2.weight"
            } <= names
    assert b.t2i_adapter.in_conv[0].in_channels == 3 * PL.vae_scale ** 2


# ---------------------------------------------------------------------------
# chip_smoke.py's launch derivation for the new paths
# ---------------------------------------------------------------------------


def test_chip_smoke_xl_and_w8a8_launches_are_the_sites(monkeypatch):
    """chip_smoke.eval_launches for the SDXL turn's IP UNet (level
    residuals in, at batch 2 and 1) and the W8A8 IP UNet's quant_matmul
    calls under THEATERGEN_FUSED_INT8 "1" (184 of the UNet's linears and
    32 IP projections), against the kernel calls the full-size bf16
    models make on the meta device; derivation_check holds both to its
    constants."""
    from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
    from theatergen_tpu_torch.ops import attention as tat
    from theatergen_tpu_torch.ops import flash_attention as tfa
    from theatergen_tpu_torch.ops import geglu_matmul as tgg
    from theatergen_tpu_torch.ops import groupnorm as tgn
    from theatergen_tpu_torch.ops import quant as tqz
    from theatergen_tpu_torch.ops import quant_matmul as tqm
    cs = knob_tests._chip_smoke()
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    monkeypatch.setattr(tqz, "FUSED_MODE", "1")
    cs.derivation_check()
    calls = collections.Counter()
    real = (tfa.flash_attention, tgg.ff_matmul, tgg.geglu_matmul,
            tgn.fused_group_norm)

    def counted(name, fn):
        def call(*a, **k):
            calls[name if name != "flash" else cs.FLASH_COUNTERS[
                tfa.COUNTERS[k["route"]]]] += 1
            return fn(*a, **k)
        return call

    def qmm(x, w, scale, bias):
        calls["quant_matmul"] += 1
        return torch.empty(x.shape[:-1] + (w.shape[0],), dtype=x.dtype,
                           device=x.device)

    for mod, attr, name, fn in (
            (tfa, "flash_attention", "flash", real[0]),
            (tgg, "ff_matmul", "ff_geglu", real[1]),
            (tgg, "geglu_matmul", "geglu_matmul", real[2]),
            (tgn, "fused_group_norm", "group_norm", real[3]),
            (tat, "cross_attention", "cross_attention", tat.cross_attention)):
        monkeypatch.setattr(mod, attr, counted(name, fn))
    monkeypatch.setattr(tqm, "quant_matmul", qmm)

    def sites(unet, b, side, ctx_dim, **kw):
        calls.clear()
        with torch.device("meta"), torch.no_grad():
            unet(torch.empty(b, 4, side, side),
                 torch.empty(b, dtype=torch.long),
                 torch.empty(b, 81, ctx_dim), ip_scale=0.4, **kw)
        return dict(calls)

    xl_cfg, side, _ = cs.path_cfg(cs.XL_CHAR)
    w8_cfg, side8, _ = cs.path_cfg(cs.CHAR_W8A8)
    with torch.device("meta"):
        xl_unet = TUNet(xl_cfg).to(torch.bfloat16)
        w8_unet = TUNet(w8_cfg).to(torch.bfloat16)
    for b in (2, 1):
        with torch.device("meta"):
            kw = dict(pooled_text=torch.empty(b, 1280),
                      time_ids=torch.empty(b, 6),
                      level_residuals=tuple(
                          torch.empty(b, c, side >> i, side >> i)
                          for i, c in enumerate(xl_cfg.block_out_channels)))
        assert sites(xl_unet, b, side, 2048, **kw) == dict(
            cs.eval_launches(xl_cfg, side, b)), ("xl", b)
    got = sites(w8_unet, 2, side8, 768)
    assert got == dict(cs.eval_launches(w8_cfg, side8, 2))
    assert got["quant_matmul"] == cs.QMM_PER_EVAL + 32
