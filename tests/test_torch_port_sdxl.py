"""The port's SDXL txt2img slice against the JAX package at
``tiny_xl_config()``: Euler-Ancestral tables and steps, micro-conditioning
ids, both text towers, the ``text_time`` UNet, and prompt encoding →
4-step EA/CFG denoise → VAE decode on the same weights, with the same
numpy initial latents and per-step noise handed to both sides.  Both sides
run fp32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_models import random_params
from theatergen_tpu import config as jcfg
from theatergen_tpu.models.clip import CLIPTextEncoder as JText
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.ops import scheduler as jsched
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu.pipelines import sdxl as jsdxl
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models import layers as tl
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.models.weights import from_flax
from theatergen_tpu_torch.ops import scheduler as tsched
from theatergen_tpu_torch.pipelines import sd as tsd
from theatergen_tpu_torch.pipelines import sdxl as tsdxl
from theatergen_tpu_torch.pipelines.bundle import init_bundle

torch.set_num_threads(1)

PROMPTS = ["a red knight rides through a dark forest", "two cats, one dog!"]


@pytest.fixture(scope="module")
def xl():
    """JAX modules with seeded random trees, and the port's bundle loaded
    from the same trees (every key checked)."""
    cfg = jcfg.tiny_xl_config()
    unet, vae = JUNet(cfg.unet), JVAE(cfg.vae)
    text, text2 = JText(cfg.text), JText(cfg.text2)
    ids = jnp.zeros((1, 16), jnp.int32)
    up = random_params(unet, 0, jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 80)),
                       pooled_text=jnp.zeros((1, 32)),
                       time_ids=jnp.zeros((1, 6)))
    vp = random_params(vae, 1, jnp.zeros((1, 16, 16, 3)))
    tp = random_params(text, 2, ids)
    tp2 = random_params(text2, 3, ids)
    jb = JBundle(cfg=cfg, tokenizer=jtok.HashTokenizer(1024), unet=unet,
                 unet_params=up, vae=vae, vae_params=vp, text=text,
                 text_params=tp, text2=text2, text2_params=tp2)
    tb = init_bundle(tcfg.tiny_xl_config(), 0, device="cpu").load_flax(
        unet=up, vae=vp, text=tp, text2=tp2)
    return dict(cfg=cfg, jb=jb, tb=tb)


def test_xl_configs_match_the_jax_package():
    """Every part the port carries, field for field: the IP-Adapter XL
    (2048-wide at full size), the guidance keys and the ControlNet
    included."""
    for fn in ("tiny_xl_config", "sdxl_config"):
        j, t = getattr(jcfg, fn)(), getattr(tcfg, fn)()
        for part in ("unet", "vae", "text", "text2", "scheduler",
                     "pipeline", "ip_adapter", "guidance", "controlnet"):
            assert (dataclasses.asdict(getattr(t, part))
                    == dataclasses.asdict(getattr(j, part))), (fn, part)


def test_sdxl_unet_levels_heads_and_depths():
    """At full size: head dim 64 everywhere, 10 transformer blocks at the
    64² level (4 down + 6 up) and 60 at the 32² level (20 down, 10 mid,
    30 up): the 70 blocks whose flash and geglu_matmul calls chip_smoke.py
    counts (2100 each per 30-step request)."""
    cfg = tcfg.sdxl_config().unet
    assert [cfg.heads_at(i) for i in range(3)] == [5, 10, 20]
    assert [cfg.depth_at(i) for i in range(3)] == [0, 2, 10]
    with torch.device("meta"):
        unet = TUNet(cfg)
    per_width = {}
    for m in unet.modules():
        self_attn = (isinstance(m, tl.CrossAttention)
                     and m.to_k.in_features == m.to_q.in_features)
        if self_attn:
            assert m.head_dim == 64
            per_width[m.heads] = per_width.get(m.heads, 0) + 1
        if isinstance(m, tl.FeedForward):
            assert not m.fused_ff
    assert per_width == {10: 10, 20: 60}
    assert unet.add_embedding.linear_1.in_features == 2816


@pytest.mark.parametrize("steps,kw", [
    (30, {}), (4, {}), (50, {}),
    (25, dict(prediction_type="v_prediction")),
    (20, dict(rescale_zero_terminal_snr=True,
              prediction_type="v_prediction"))])
def test_ea_tables_equal(steps, kw):
    """Timesteps and sigmas bit for bit (the same numpy on both sides)."""
    j = jsched.make_euler_ancestral_schedule(jcfg.SchedulerConfig(**kw),
                                             steps)
    t = tsched.make_euler_ancestral_schedule(tcfg.SchedulerConfig(**kw),
                                             steps)
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    np.testing.assert_array_equal(t.sigmas, np.asarray(j.sigmas))
    assert t.sigmas.dtype == np.float32 and t.timesteps.dtype == np.int32
    assert t.init_noise_sigma == float(j.init_noise_sigma)
    assert t.prediction_type == j.prediction_type


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction", "sample"])
def test_ea_scale_and_step_match(pred):
    """ea_scale_model_input and ea_step at every loop position of a
    10-step schedule with injected noise, the port reading the schedule's
    tables moved to the device once.  fp32 elementwise on latents of
    scale up to sigma_0 (~14.6): bound 1e-5 absolute + 1e-5 relative."""
    sched_j = jsched.make_euler_ancestral_schedule(
        jcfg.SchedulerConfig(prediction_type=pred), 10)
    sched_t = tsched.make_euler_ancestral_schedule(
        tcfg.SchedulerConfig(prediction_type=pred), 10)
    tables = tsched.ea_device_tables(sched_t, "cpu")
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 4, 4, 4) * sched_t.init_noise_sigma).astype(np.float32)
    eps, noise = (rng.randn(2, 4, 4, 4).astype(np.float32) for _ in range(2))
    for i in range(10):
        ref = jsched.ea_scale_model_input(sched_j, jnp.asarray(x), i)
        got = tsched.ea_scale_model_input(tables, torch.from_numpy(x), i)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
        ref = jsched.ea_step(sched_j, jnp.asarray(eps), i, jnp.asarray(x),
                             jnp.asarray(noise))
        got = tsched.ea_step(tables, torch.from_numpy(eps), i,
                             torch.from_numpy(x), torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_default_time_ids_equal():
    for h, w, b in ((1024, 1024, 2), (16, 16, 4), (768, 1344, 1)):
        got = tsdxl.default_time_ids(h, w, b)
        assert got.dtype == torch.float32
        ref = np.asarray(jsdxl.default_time_ids(h, w, b))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", ["unet", "text2"])
def test_bridge_maps_every_key(xl, kind):
    """The UNet's add_embedding and tower 2's text_projection map key for
    key onto the port's modules."""
    tree = {"unet": xl["jb"].unet_params, "text2": xl["jb"].text2_params}[kind]
    ref = getattr(xl["tb"], kind).state_dict()
    sd = from_flax("unet" if kind == "unet" else "text", tree)
    assert set(sd) == set(ref)
    assert any(k.startswith({"unet": "add_embedding.",
                             "text2": "text_projection."}[kind]) for k in sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(ref[k].numpy(), v)


def test_text2_tower_matches(xl):
    """Tower 2 (gelu MLPs, text_projection): hidden states, projected
    pooled output and the penultimate state; fp32, 2 layers: bound 5e-5."""
    jb = xl["jb"]
    ids = jtok.HashTokenizer(1024)(PROMPTS + [""], max_length=16,
                                   pad_token_id=0)
    ref = jax.jit(lambda p, i: jb.text2.apply(
        {"params": p}, i, return_penultimate=True))(jb.text2_params,
                                                    jnp.asarray(ids))
    got = xl["tb"].text2(torch.from_numpy(ids).long(),
                         return_penultimate=True)
    assert got[1].shape == (3, 32)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-5)


def test_encode_prompts_xl_matches(xl):
    """Concatenated penultimate states [2B, 16, 80] and tower 2's pooled
    output [2B, 32], uncond rows first; fp32: bound 5e-5."""
    ctx_j, pooled_j = jsdxl.encode_prompts_xl(xl["jb"], PROMPTS, "blurry")
    ctx_t, pooled_t = tsdxl.encode_prompts_xl(xl["tb"], PROMPTS, "blurry")
    assert ctx_t.shape == (4, 16, 80) and pooled_t.shape == (4, 32)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=5e-5)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j),
                               atol=5e-5)
    with pytest.raises(ValueError):
        tsdxl.encode_prompts_xl(xl["tb"], PROMPTS, ["a", "b", "c"])


def test_text_time_unet_matches(xl):
    """eps with pooled text and time ids at two timesteps; bound 5e-5 as
    the SD1.5 UNet's (fp32, summation order).  The micro-conditioning
    must move the output."""
    jb = xl["jb"]
    rng = np.random.RandomState(10)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([999, 500], np.int32)
    ctx = rng.randn(2, 16, 80).astype(np.float32)
    pooled = rng.randn(2, 32).astype(np.float32)
    tids = np.array(jsdxl.default_time_ids(16, 16, 2))
    ref = np.asarray(jax.jit(lambda p, *a: jb.unet.apply(
        {"params": p}, *a[:3], pooled_text=a[3], time_ids=a[4]))(
        jb.unet_params, *map(jnp.asarray, (x, t, ctx, pooled, tids))))
    unet = xl["tb"].unet
    args = (torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
            torch.from_numpy(ctx))
    got = unet(*args, pooled_text=torch.from_numpy(pooled),
               time_ids=torch.from_numpy(tids))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=5e-5, rtol=1e-5)
    other = unet(*args, pooled_text=2 * torch.from_numpy(pooled),
                 time_ids=torch.from_numpy(tids))
    assert (other - got).abs().max() > 1e-4
    with pytest.raises(ValueError):
        unet(*args)


def test_sdxl_slice_matches(xl):
    """encode_prompts_xl → denoise_xl (4 EA steps, CFG 7.5, the same
    initial latents and per-step noise) → decode_with, against a JAX loop
    built from ea_scale_model_input, the UNet, cfg_combine, ea_step and
    decode_with.  fp32 on both sides; the latents are O(sigma_0) and CFG
    7.5 amplifies each step's eps difference, so the trajectory gets 2e-4
    absolute + 1e-5 relative and the [0, 1] image 5e-5."""
    cfg, jb, tb = xl["cfg"], xl["jb"], xl["tb"]
    steps = 4
    sched_j = jsched.make_euler_ancestral_schedule(cfg.scheduler, steps)
    sched_t = tsched.make_euler_ancestral_schedule(tb.cfg.scheduler, steps)
    rng = np.random.RandomState(6)
    lat = (rng.randn(2, 8, 8, 4) * sched_t.init_noise_sigma).astype(np.float32)
    noise = rng.randn(steps, 2, 8, 8, 4).astype(np.float32)

    ctx_j, pooled_j = jsdxl.encode_prompts_xl(jb, PROMPTS)
    tids_j = jsdxl.default_time_ids(16, 16, 4)

    @jax.jit
    def run_j(lat, ctx, pooled, noise):
        def step(x, i_n):
            i, n = i_n
            s = jsched.ea_scale_model_input(sched_j, x, i)
            eps = jb.unet.apply(
                {"params": jb.unet_params}, jnp.concatenate([s, s], axis=0),
                jnp.broadcast_to(sched_j.timesteps[i], (4,)), ctx,
                pooled_text=pooled, time_ids=tids_j)
            eps = jsd.cfg_combine(eps.astype(jnp.float32), 7.5)
            return jsched.ea_step(sched_j, eps, i, x, n), x

        final, traj = jax.lax.scan(step, lat, (jnp.arange(steps), noise))
        traj = jnp.concatenate([traj, final[None]], axis=0)
        return traj, jsd.decode_with(jb.vae, jb.vae_params,
                                     cfg.vae.scaling_factor, final)

    traj_j, img_j = run_j(jnp.asarray(lat), ctx_j, pooled_j,
                          jnp.asarray(noise))

    ctx_t, pooled_t = tsdxl.encode_prompts_xl(tb, PROMPTS)
    final, traj_t = tsdxl.denoise_xl(
        tb.unet, sched_t, None, torch.from_numpy(lat), ctx_t, pooled_t,
        tsdxl.default_time_ids(16, 16, 4), 7.5,
        noise=torch.from_numpy(noise), collect_trajectory=True)
    img_t = tsd.decode_with(tb.vae, tb.cfg.vae.scaling_factor, final)

    assert traj_t.shape == (steps + 1, 2, 8, 8, 4)
    np.testing.assert_array_equal(traj_t[0].numpy(), lat)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), atol=2e-4,
                               rtol=1e-5)
    assert img_t.shape == (2, 16, 16, 3)
    assert 0.0 <= float(img_t.min()) and float(img_t.max()) <= 1.0
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=5e-5)


def test_text2img_xl_runs_end_to_end(xl):
    """The entry point a user calls: seeded, deterministic, [B, H, W, 3]
    in [0, 1]; denoising_end runs a prefix of the schedule; a T2I-Adapter
    hint refuses on a bundle without the adapter (with one it runs:
    test_torch_port_xl_turn.py)."""
    tb = xl["tb"]
    pipe = tsdxl.Text2ImgXL(tb, num_steps=3)
    a = pipe(torch.Generator().manual_seed(5), "a knight")
    c = pipe(torch.Generator().manual_seed(5), "a knight")
    assert a.shape == (1, 16, 16, 3)
    assert torch.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    half = tsdxl.Text2ImgXL(tb, num_steps=4, denoising_end=0.5)
    assert half.sched.num_steps == 2 and len(half.sched.sigmas) == 3
    img, lat = half(torch.Generator().manual_seed(5), ["a", "b"],
                    output_type="latent")
    assert img.shape == (2, 16, 16, 3) and lat.shape == (2, 8, 8, 4)
    with pytest.raises(ValueError, match="adapter"):
        pipe(torch.Generator().manual_seed(5), "a knight",
             hint=torch.zeros(16, 16, 3))

def test_text2img_xl_lcm_matches(xl, monkeypatch):
    """Text2ImgXL under the config's LCM sampler: the cond rows of the
    context, pooled text and time ids through 4 consistency steps and the
    decode, against the JAX request with its starting latents
    (``seeded_latents(split(rng)[0])``) and per-step draws
    (``fold_in(split(rng)[1], i)``) injected: image bound 1e-5 (values in
    [0, 1]; no CFG).  denoising_end is refused under LCM."""
    cfg, jb, tb = xl["cfg"], xl["jb"], xl["tb"]

    def lcm(c):
        return dataclasses.replace(c, pipeline=dataclasses.replace(
            c.pipeline, scheduler_type="lcm"))

    rng = jax.random.key(8)
    lat_rng, anc_rng = jax.random.split(rng)
    lat = np.asarray(jsd.seeded_latents(lat_rng, 1, 8, 8))
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(anc_rng, i), (1, 8, 8, 4), jnp.float32))
        for i in range(4)])
    ref = jsdxl.Text2ImgXL(dataclasses.replace(jb, cfg=lcm(cfg)),
                           num_steps=4)(rng, PROMPTS[0])
    monkeypatch.setattr(tsd, "seeded_latents",
                        lambda *a, **k: torch.tensor(lat))
    tb_lcm = dataclasses.replace(tb, cfg=lcm(tb.cfg))
    pipe = tsdxl.Text2ImgXL(tb_lcm, num_steps=4)
    assert pipe.is_lcm and pipe.sched.kind == "lcm"
    got = pipe(torch.Generator().manual_seed(0), PROMPTS[0],
               noise=torch.from_numpy(noise))
    assert got.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    with pytest.raises(ValueError):
        tsdxl.Text2ImgXL(tb_lcm, num_steps=4, denoising_end=0.5)
