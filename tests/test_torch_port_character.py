"""The port's IP-Adapter character pass against the JAX package at
``tiny_config()``: the CLIP vision tower, the three image projectors,
decoupled attention with its probabilities, the IP UNet with
cross-attention capture, ``encode_ip_image``, ``ip_context`` and the whole
``make_character_pipeline`` run (trajectory and reference maps) on the
same weights, carried across by ``from_flax``, and the same numpy inputs.
Everything runs in fp32 on the CPU.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.clip import CLIPTextEncoder as JText
from theatergen_tpu.models.clip import CLIPVisionEncoder as JVision
from theatergen_tpu.models.ip_adapter import (
    ImageProjModel as JImageProj, MLPProjModel as JMLPProj,
    Resampler as JResampler,
)
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.ops import attention as jattn
from theatergen_tpu.ops import guidance as jguid
from theatergen_tpu.pipelines import character as jchar
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.ops import attention as tattn
from theatergen_tpu_torch.ops import guidance as tguid
from theatergen_tpu_torch.pipelines import character as tchar
from theatergen_tpu_torch.pipelines.bundle import init_bundle

import test_torch_port_xl_turn as xl_tests
from test_torch_port_models import random_params

torch.set_num_threads(1)

CFG = jcfg.tiny_config()
IP_TOKENS = {"base": CFG.ip_adapter.num_tokens,
             "plus": CFG.ip_adapter.resampler_queries, "full": 1}


def _ip_unet(n_tokens, seed=0):
    unet = JUNet(dataclasses.replace(CFG.unet, ip_num_tokens=n_tokens))
    params = random_params(unet, seed, jnp.zeros((1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, 16 + n_tokens, 32)))
    return unet, params


def _projector(variant, seed=1):
    ip = CFG.ip_adapter
    if variant == "plus":
        mod = JResampler(ip, embedding_dim=CFG.vision.hidden_size,
                         output_dim=CFG.unet.cross_attention_dim)
        arg = jnp.zeros((1, 5, CFG.vision.hidden_size))
    elif variant == "full":
        mod, arg = JMLPProj(ip), jnp.zeros((1, ip.clip_embeddings_dim))
    else:
        mod, arg = JImageProj(ip), jnp.zeros((1, ip.clip_embeddings_dim))
    return mod, random_params(mod, seed, arg)


def _vision(seed=2):
    mod = JVision(CFG.vision)
    return mod, random_params(mod, seed, jnp.zeros((1, 32, 32, 3)))


@functools.lru_cache(maxsize=None)
def _bundles(variant="base"):
    """A JAX bundle and the port's bundle on the same random weights (the
    text tower's and the IP UNet's, the projector's and the vision
    tower's)."""
    text = JText(CFG.text)
    tp = random_params(text, 3, jnp.zeros((1, 16), jnp.int32))
    unet_ip, up = _ip_unet(IP_TOKENS[variant])
    proj, pp = _projector(variant)
    vis, vp = _vision()
    jb = JBundle(cfg=CFG, tokenizer=jtok.HashTokenizer(1024), unet=None,
                 unet_params=None, vae=None, vae_params=None, text=text,
                 text_params=tp, unet_ip=unet_ip, unet_ip_params=up,
                 vision=vis, vision_params=vp, image_proj=proj,
                 image_proj_params=pp, ip_variant=variant)
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu", with_ip=True,
                     with_vision=True, ip_variant=variant).load_flax(
        text=tp, unet_ip=up, image_proj=pp, vision=vp)
    return jb, tb


def _np(t):
    return t.detach().float().numpy()


def test_vision_tower_matches():
    """Embeds, pooled CLS, penultimate and post-LN tokens of the tiny tower
    (2 layers, d = 32, 5 tokens): fp32 on both sides, 2e-5 absolute on
    O(1) values."""
    vis, vp = _vision()
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    ref = vis.apply({"params": vp}, jnp.asarray(x), return_tokens=True)
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu",
                     with_vision=True).load_flax(vision=vp)
    got = tb.vision(torch.from_numpy(x).permute(0, 3, 1, 2),
                    return_tokens=True)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(_np(g), np.asarray(r), atol=2e-5)


@pytest.mark.parametrize("variant", ["base", "full", "plus"])
def test_projectors_match(variant):
    """ImageProj, MLPProj and the Resampler (1 layer, 4 queries), LayerNorm
    eps 1e-6 on both sides: 2e-5 absolute on LayerNorm-scaled outputs."""
    proj, pp = _projector(variant)
    rng = np.random.RandomState(1)
    if variant == "plus":
        x = rng.randn(2, 5, CFG.vision.hidden_size).astype(np.float32)
    else:
        x = rng.randn(2, CFG.ip_adapter.clip_embeddings_dim).astype(
            np.float32)
    ref = np.asarray(proj.apply({"params": pp}, jnp.asarray(x)))
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu", with_ip=True,
                     ip_variant=variant).load_flax(image_proj=pp)
    got = tb.image_proj(torch.from_numpy(x))
    assert tuple(got.shape) == ref.shape == (2, IP_TOKENS[variant], 32)
    np.testing.assert_allclose(_np(got), ref, atol=2e-5)


@pytest.mark.parametrize("ip_scale", [0.4, 0.0])
def test_decoupled_attention_matches(ip_scale):
    """Text branch (77 keys) + ip_scale · image branch (4 keys), and the
    text branch's probabilities: fp32, 1e-5 absolute."""
    rng = np.random.RandomState(2)
    b, lq, h, d = 2, 64, 2, 16
    q = rng.randn(b, lq, h, d).astype(np.float32)
    kt, vt = (rng.randn(b, 77, h, d).astype(np.float32) for _ in range(2))
    ki, vi = (rng.randn(b, 4, h, d).astype(np.float32) for _ in range(2))
    out_j, probs_j = jattn.decoupled_attention(
        *(jnp.asarray(a) for a in (q, kt, vt, ki, vi)), jnp.float32(ip_scale),
        return_probs=True)
    out_t, probs_t = tattn.decoupled_attention(
        *(torch.from_numpy(a) for a in (q, kt, vt, ki, vi)),
        torch.tensor(ip_scale), return_probs=True)
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(_np(probs_t), np.asarray(probs_j), atol=1e-5)
    plain = tattn.decoupled_attention(
        *(torch.from_numpy(a) for a in (q, kt, vt, ki, vi)), ip_scale)
    np.testing.assert_allclose(_np(plain), _np(out_t), atol=1e-6)


def test_ip_unet_with_capture_matches():
    """The tiny IP UNet (4 IP tokens) at ip_scale 0.4, capturing the three
    guidance keys: eps 1e-4 absolute (fp32 through 5 transformer blocks,
    O(1) outputs), each cond-branch map 1e-5 (probabilities)."""
    unet, up = _ip_unet(4)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 20, 32).astype(np.float32)
    t = np.array([981, 981], np.int32)
    keys = CFG.guidance.attn_keys
    eps_j, state = unet.apply({"params": up}, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(ctx), ip_scale=jnp.float32(0.4),
                              capture_keys=keys, mutable=["attn"])
    maps_j = jguid.attn_collection_to_maps(state["attn"], keys, 1, 16)

    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu",
                     with_ip=True).load_flax(unet_ip=up)
    eps_t, captured = tb.unet_ip(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t).long(),
        torch.from_numpy(ctx), ip_scale=torch.tensor(0.4), capture_keys=keys)
    assert sorted(captured) == sorted(keys)
    np.testing.assert_allclose(_np(eps_t.permute(0, 2, 3, 1)),
                               np.asarray(eps_j), atol=1e-4)
    maps_t = tguid.attn_collection_to_maps(captured, keys, 1, 16)
    for mt, mj in zip(maps_t, maps_j):
        assert tuple(mt.shape) == mj.shape
        np.testing.assert_allclose(_np(mt), np.asarray(mj), atol=1e-5)
    # the same call without capture gives the same eps
    eps_plain = tb.unet_ip(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(t).long(), torch.from_numpy(ctx),
                           ip_scale=0.4)
    np.testing.assert_allclose(_np(eps_plain), _np(eps_t), atol=1e-6)


@pytest.mark.parametrize("size", [48, 16])
def test_encode_ip_image_and_context_match(size):
    """A seeded image shrunk (48 → 32: antialiased bilinear) or grown
    (16 → 32), CLIP-normalised and encoded, then projected into the IP
    context: features 2e-5, context 2e-5 absolute."""
    jb, tb = _bundles()
    img = np.random.RandomState(4).rand(1, size, size, 3).astype(np.float32)
    feats_j = jchar.encode_ip_image(jb, jnp.asarray(img))
    feats_t = tchar.encode_ip_image(tb, torch.from_numpy(img))
    np.testing.assert_allclose(_np(feats_t), np.asarray(feats_j), atol=2e-5)
    text = np.random.RandomState(5).randn(2, 16, 32).astype(np.float32)
    ctx_j = jchar.ip_context(jb, jnp.asarray(text), feats_j)
    ctx_t = tchar.ip_context(tb, torch.from_numpy(text), feats_t)
    assert tuple(ctx_t.shape) == (2, 20, 32)
    np.testing.assert_allclose(_np(ctx_t), np.asarray(ctx_j), atol=2e-5)


@pytest.mark.parametrize("variant", ["plus", "full"])
def test_uncond_features_match(variant):
    """Plus and full project a black image's features on the uncond row:
    2e-5 absolute."""
    jb, tb = _bundles(variant)
    np.testing.assert_allclose(_np(tchar.uncond_ip_features(tb)),
                               np.asarray(jchar.uncond_ip_features(jb)),
                               atol=2e-5)
    assert tchar.uncond_ip_features(_bundles("base")[1]) is None


@pytest.mark.parametrize("ip_scale", [0.4, 0.0])
def test_character_pass_matches(ip_scale):
    """make_character_pipeline, 4 DDIM steps at CFG 7.5 with reference
    capture, from the same initial latents and context: trajectory 2e-4
    absolute (CFG amplifies each step's eps difference; latents O(10)),
    reference maps 1e-5 (probabilities).  ip_scale enters as a 0-dim
    tensor; a DB miss (0.0) differs from a hit (0.4)."""
    jb, tb = _bundles()
    rng = np.random.RandomState(6)
    lat = rng.randn(1, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 20, 32).astype(np.float32)
    run_j, _ = jchar.make_character_pipeline(jb, 4, use_ip=True,
                                             capture_ref_attn=True)
    res_j = run_j(jb.unet_ip_params, jnp.asarray(lat), jnp.asarray(ctx),
                  jnp.float32(ip_scale), None)
    run_t, sched = tchar.make_character_pipeline(tb, 4, use_ip=True,
                                                 capture_ref_attn=True)
    res_t = run_t(torch.from_numpy(lat), torch.from_numpy(ctx),
                  torch.tensor(ip_scale))
    assert sched.num_steps == 4
    assert tuple(res_t.trajectory.shape) == (5, 1, 8, 8, 4)
    np.testing.assert_array_equal(_np(res_t.trajectory[0]), lat)
    np.testing.assert_allclose(_np(res_t.trajectory),
                               np.asarray(res_j.trajectory), atol=2e-4)
    np.testing.assert_allclose(_np(res_t.latents), np.asarray(res_j.latents),
                               atol=2e-4)
    assert len(res_t.ref_attn) == len(res_j.ref_attn) == 3
    for mt, mj in zip(res_t.ref_attn, res_j.ref_attn):
        assert tuple(mt.shape) == mj.shape
        np.testing.assert_allclose(_np(mt), np.asarray(mj), atol=1e-5)
    if ip_scale == 0.0:
        hit = run_t(torch.from_numpy(lat), torch.from_numpy(ctx), 0.4)
        assert (hit.latents - res_t.latents).abs().max() > 1e-4


def test_character_pass_without_ip_or_capture():
    """use_ip=False runs the base UNet on a text-only context; without
    capture there are no reference maps."""
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu", with_ip=True)
    run, _ = tchar.make_character_pipeline(tb, 2, use_ip=False)
    lat = torch.randn(1, 8, 8, 4)
    res = run(lat, torch.randn(2, 16, 32))
    assert res.ref_attn is None and tuple(res.trajectory.shape) == (
        3, 1, 8, 8, 4)
    assert torch.isfinite(res.trajectory).all()


@pytest.mark.parametrize("kw", [dict(guided=True)])
def test_unported_knobs_raise(kw):
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu", with_ip=True)
    with pytest.raises(NotImplementedError):
        tchar.make_character_pipeline(tb, 2, **kw)


@pytest.mark.parametrize("kw", [dict(deepcache_interval=2),
                                dict(cfg_cutoff_fraction=0.5)])
def test_knobs_run(kw):
    """DeepCache and CFG cutoff (held to the JAX runner in
    test_torch_port_knobs.py): step 0 is a full CFG step under both, so
    the first step equals the exact run's bit for bit, and the second
    (shallow, or cond-only) moves the result off it; a DeepCache step's
    maps repeat step 0's."""
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu", with_ip=True)
    lat = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(3))
    ctx = torch.randn(2, 20, 32, generator=torch.Generator().manual_seed(4))
    exact, _ = tchar.make_character_pipeline(tb, 2, capture_ref_attn=True)
    run, _ = tchar.make_character_pipeline(tb, 2, capture_ref_attn=True, **kw)
    a, b = exact(lat, ctx, 0.4), run(lat, ctx, 0.4)
    torch.testing.assert_close(b.trajectory[:2], a.trajectory[:2], rtol=0,
                               atol=0)
    assert float((b.latents - a.latents).abs().max()) > 1e-4
    for m in b.ref_attn:
        if "deepcache_interval" in kw:
            torch.testing.assert_close(m[1], m[0], rtol=0, atol=0)


def test_xl_bundle_raises():
    """An SDXL bundle's character pass runs: with pooled text and time
    ids, exact CFG and Euler-Ancestral it matches the JAX runner
    (test_torch_port_xl_turn.py's bounds).  What raises is a run without
    the micro-conditioning, in the XL UNet."""
    xl_tests.test_character_runner_with_extra_cond_matches(
        "euler_ancestral", None, None)
    tb = init_bundle(tcfg.tiny_xl_config(), 0, device="cpu", with_ip=True)
    run, _ = tchar.make_character_pipeline(tb, 2)
    with pytest.raises(ValueError, match="pooled_text"):
        run(torch.zeros(1, 8, 8, 4), torch.zeros(2, 20, 80), 0.4,
            noise=torch.zeros(2, 1, 8, 8, 4))
