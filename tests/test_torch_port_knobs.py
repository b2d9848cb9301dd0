"""The step knobs in the port's runners, its Theater and CLI config, and the
LoRA merge, against the JAX package at ``tiny_config()`` in fp32 on the
CPU:

- the character and final runners under each knob and under
  combinations: DeepCache × CFG cutoff, the ControlNet interval × cutoff
  (also with a ControlNet window that closes mid-run), LCM, and
  Euler-Ancestral (v-prediction, zero terminal SNR) with the JAX draws of
  ``fold_in(rng, i)`` injected.  Trajectories, final latents, the
  reference maps of every step (a DeepCache step's are the last full
  step's) and the frozen region, bit for bit equal to the composition;
- ``Theater.run_turn`` over the four turns of dialogue_0 with DeepCache 2,
  CFG cutoff 0.5 and the ControlNet interval 2, as
  ``test_torch_port_turn.py`` runs it without knobs;
- ``cli.generate.apply_pipeline_overrides``, field for field;
- ``models/lora.apply_lora_unet`` on peft and kohya state dicts, linear
  and convolution factors, against the JAX merge carried across by
  ``weights.from_flax``.
"""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_turn as turn_tests
from test_torch_port_samplers import _close, bundles, jax_noise
from theatergen_tpu import config as jcfg
from theatergen_tpu.cli import generate as jgen
from theatergen_tpu.models import lora as jlora
from theatergen_tpu.ops import latents as JL
from theatergen_tpu.pipelines import character as jchar
from theatergen_tpu.pipelines import final as jfinal
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.models import lora as tlora
from theatergen_tpu_torch.models.weights import from_flax
from theatergen_tpu_torch.pipelines import character as tchar
from theatergen_tpu_torch.pipelines import final as tfinal

torch.set_num_threads(1)

CFG = jcfg.tiny_config()
h = w = CFG.pipeline.latent_height
H = W = CFG.pipeline.height
STEPS = 5
FROZEN = 2


def _knob_bundles(kind: str = "ddim", pred: str = "epsilon",
                  zsnr: bool = False):
    """The shared weights under a sampler kind and scheduler settings."""
    return bundles((("pipeline", "scheduler_type", kind),
                    ("scheduler", "prediction_type", pred),
                    ("scheduler", "rescale_zero_terminal_snr", zsnr)))


def _np(t):
    return t.detach().float().numpy()


# (kind, steps, deepcache, cfg cutoff, (prediction type, zero SNR))
CHAR_CASES = [
    ("ddim", STEPS, 2, None, None), ("ddim", STEPS, 2, 0.5, None),
    ("ddim", STEPS, 3, 0.2, None), ("ddim", STEPS, None, 0.5, None),
    ("lcm", 4, None, None, None), ("lcm", 4, 2, None, None),
    ("euler_ancestral", STEPS, None, 0.5, ("v_prediction", True))]


@functools.lru_cache(maxsize=None)
def _jax_char_runner(kind, steps, dc, cutoff, sched):
    jb, _ = _knob_bundles(kind, *(sched or ("epsilon", False)))
    run, _ = jchar.make_character_pipeline(
        jb, steps, use_ip=True, capture_ref_attn=True,
        cfg_cutoff_fraction=cutoff, deepcache_interval=dc)
    return run


@pytest.mark.parametrize("kind,steps,dc,cutoff,sched", CHAR_CASES)
def test_character_runner_knobs_match(kind, steps, dc, cutoff, sched):
    """The IP character pass at ip_scale 0.4 under each knob: trajectory
    and final latents, and the reference maps of every step, against the
    JAX runner on the same inputs and draws.  CFG 7.5 amplifies each
    step's eps difference over the steps and the latents grow to O(10):
    bound 2e-5·max|ref| (EA's latents start at sigma_0 ~ 14.6); the maps
    (probabilities) 1e-5.  On a DeepCache step the maps repeat the last
    full step's."""
    jb, tb = _knob_bundles(kind, *(sched or ("epsilon", False)))
    rng = np.random.RandomState(31)
    run_t, sampler = tchar.make_character_pipeline(
        tb, steps, use_ip=True, capture_ref_attn=True,
        cfg_cutoff_fraction=cutoff, deepcache_interval=dc)
    lat = (rng.randn(1, h, w, 4) * sampler.init_noise_sigma).astype(
        np.float32)
    ctx = rng.randn(2, 20, 32).astype(np.float32)
    key = jax.random.key(4)
    res_j = _jax_char_runner(kind, steps, dc, cutoff, sched)(
        jb.unet_ip_params, jnp.asarray(lat), jnp.asarray(ctx),
        jnp.float32(0.4), None, rng=key)
    noise = None
    if sampler.needs_noise:
        noise = torch.from_numpy(jax_noise(key, sampler.num_steps, lat.shape))
    res_t = run_t(torch.from_numpy(lat), torch.from_numpy(ctx), 0.4,
                  noise=noise)
    assert tuple(res_t.trajectory.shape) == (steps + 1, 1, h, w, 4)
    _close(_np(res_t.trajectory), res_j.trajectory, 2e-5, "trajectory")
    _close(_np(res_t.latents), res_j.latents, 2e-5, "final")
    assert len(res_t.ref_attn) == len(res_j.ref_attn)
    for mt, mj in zip(res_t.ref_attn, res_j.ref_attn):
        assert tuple(mt.shape) == tuple(mj.shape)
        _close(_np(mt), mj, 1e-5, "ref maps")
        if dc:
            for i in range(steps):
                if i % dc:
                    torch.testing.assert_close(mt[i], mt[i - 1], rtol=0,
                                               atol=0)


def test_character_runner_draws_from_its_generator():
    """Without injected noise an ancestral runner draws from its generator:
    seeded, deterministic, and refused without either."""
    _, tb = _knob_bundles("euler_ancestral")
    run, sampler = tchar.make_character_pipeline(tb, 3, use_ip=True)
    lat = torch.randn(1, h, w, 4) * sampler.init_noise_sigma
    ctx = torch.randn(2, 20, 32)
    a = run(lat, ctx, 0.4, 0, torch.Generator().manual_seed(1))
    b = run(lat, ctx, 0.4, 0, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a.trajectory, b.trajectory, rtol=0, atol=0)
    assert torch.isfinite(a.trajectory).all()
    with pytest.raises(ValueError):
        run(lat, ctx, 0.4)


# (kind, steps, deepcache, cfg cutoff, ControlNet interval, window end)
FINAL_CASES = [
    ("ddim", STEPS, 2, None, None, 1.0), ("ddim", STEPS, 3, 0.5, None, 1.0),
    ("ddim", STEPS, None, None, 2, 1.0), ("ddim", STEPS, None, 0.5, 3, 1.0),
    ("ddim", STEPS, 2, 0.5, 2, 1.0), ("ddim", STEPS, None, 0.2, 2, 0.5),
    ("lcm", 4, None, None, 2, 1.0), ("euler_ancestral", STEPS, None, None,
                                     None, 1.0)]


@functools.lru_cache(maxsize=None)
def _jax_final_runner(kind, steps, dc, cutoff, cn, end):
    jb, _ = _knob_bundles(kind)
    run, _ = jfinal.make_final_pipeline(
        jb, steps, use_ip=True, cfg_cutoff_fraction=cutoff,
        deepcache_interval=dc, controlnet_interval=cn,
        control_guidance_end=end)
    return run


@pytest.mark.parametrize("kind,steps,dc,cutoff,cn,end", FINAL_CASES)
def test_final_runner_knobs_match(kind, steps, dc, cutoff, cn, end):
    """The ControlNet final pass at ip_scale 0.1 under each knob and
    combination (the ControlNet cache cut to its cond rows at the cutoff;
    a window that closes after step 2 of 5 with the interval's cache
    spanning it), against the JAX runner on the same composition, mask,
    contexts, hint and draws: bound 2e-5·max|ref| as for the character
    pass.  Below frozen_steps the masked region of every step is the
    composed trajectory's, bit for bit."""
    jb, tb = _knob_bundles(kind)
    rng = np.random.RandomState(32)
    run_t, sampler = tfinal.make_final_pipeline(
        tb, steps, use_ip=True, cfg_cutoff_fraction=cutoff,
        deepcache_interval=dc, controlnet_interval=cn,
        control_guidance_end=end)
    la = rng.randn(steps + 1, 1, h, w, 4).astype(np.float32)
    la[0] *= sampler.init_noise_sigma
    fm = np.zeros((h, w), np.float32)
    fm[2:6, 1:5] = 1.0
    ctx = rng.randn(2, 20, 32).astype(np.float32)
    cn_ctx = rng.randn(2, 16, 32).astype(np.float32)
    cond = rng.rand(H, W, 3).astype(np.float32)
    key = jax.random.key(5)
    fj, trj = _jax_final_runner(kind, steps, dc, cutoff, cn, end)(
        jb.unet_ip_params, jb.controlnet_params, jnp.asarray(la),
        jnp.asarray(fm), jnp.int32(FROZEN), jnp.asarray(ctx),
        jnp.asarray(cn_ctx), jnp.asarray(cond), jnp.float32(0.1), rng=key)
    noise = None
    if sampler.needs_noise:
        noise = torch.from_numpy(jax_noise(key, steps, la.shape[1:]))
    ft, trt = run_t(torch.from_numpy(la), torch.from_numpy(fm), FROZEN,
                    torch.from_numpy(ctx), torch.from_numpy(cn_ctx),
                    torch.from_numpy(cond), 0.1, noise=noise)
    _close(_np(trt), trj, 2e-5, "trajectory")
    _close(_np(ft), fj, 2e-5, "final")
    on = torch.from_numpy(fm > 0)
    for j in range(FROZEN + 1):
        torch.testing.assert_close(trt[j, 0][on], torch.from_numpy(la[j, 0])[
            on], rtol=0, atol=0)


@pytest.fixture()
def _jax_align_shifts_hw(monkeypatch):
    monkeypatch.setattr(JL, "align_with_boxes",
                        turn_tests._align_hw(JL.align_with_boxes))


def test_run_turn_with_knobs_matches_over_dialogue_0(
        tmp_path, monkeypatch, _jax_align_shifts_hw):
    """dialogue_0's four turns through both Theaters with
    deepcache_interval 2, cfg_cutoff_fraction 0.5 and controlnet_interval
    2 in the config (the runners built from it), noise injected at the
    method level as in test_torch_port_turn.py: images, character images
    and collage within its IMG_TOL, masks and detections equal, DB hits
    as without knobs."""
    knobs = (("pipeline", "deepcache_interval", 2),
             ("pipeline", "cfg_cutoff_fraction", 0.5),
             ("pipeline", "controlnet_interval", 2))
    base_j, base_t = turn_tests._bundles()
    jc, tc = base_j.cfg, base_t.cfg
    for part, field, value in knobs:
        jc = dataclasses.replace(jc, **{part: dataclasses.replace(
            getattr(jc, part), **{field: value})})
        tc = dataclasses.replace(tc, **{part: dataclasses.replace(
            getattr(tc, part), **{field: value})})
    jb = dataclasses.replace(base_j, cfg=jc)
    tb = dataclasses.replace(base_t, cfg=tc)
    monkeypatch.setattr(turn_tests, "_bundles", lambda: (jb, tb))
    jt, tt, rec, noise = turn_tests._theaters(tmp_path, monkeypatch)
    assert tt.char_sched.num_steps == jt.char_sched.num_steps
    hits = [[False, False], [True], [True], [True, False]]
    for t_idx, spec in enumerate(turn_tests._specs()):
        seed = tgen.turn_seed(0, 0, t_idx, 0)
        jr = jt.run_turn(spec, seed, frozen_step_ratio=0.5)
        tr = tt.run_turn(spec, seed, frozen_step_ratio=0.5)
        assert tr.db_hits == hits[t_idx]
        turn_tests._compare(jr, tr, rec, noise, jt, tt, len(hits[t_idx]))


@pytest.mark.parametrize("kw", [
    {}, dict(cfg_cutoff=0.5), dict(deepcache=3, cn_interval=2),
    dict(scheduler="lcm"), dict(scheduler="euler_ancestral",
                                prediction_type="v_prediction",
                                zero_snr=True),
    dict(cfg_cutoff=0.25, deepcache=2, scheduler="ddim", cn_interval=3,
         prediction_type="sample", zero_snr=False)])
def test_apply_pipeline_overrides_matches(kw):
    """The port's resulting config equals the JAX CLI's, field for
    field, at the tiny and the full SD1.5 config."""
    for fn in ("tiny_config", "sd15_config"):
        j = jgen.apply_pipeline_overrides(getattr(jcfg, fn)(), **kw)
        t = tgen.apply_pipeline_overrides(getattr(tcfg, fn)(), **kw)
        for part in ("pipeline", "scheduler", "unet", "controlnet"):
            assert (dataclasses.asdict(getattr(t, part))
                    == dataclasses.asdict(getattr(j, part))), (fn, part)


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

def _lora_sd(kind: str, rank: int = 4, seed: int = 40) -> dict:
    """A synthetic LoRA over attention projections, an FF linear, 3×3 and
    1×1 convolutions, a 2-D factor pair into a 1×1 projection and (peft
    only: kohya's flattening has no rule for it in either package) the
    time embedding, in peft or kohya naming (kohya with ``.alpha``), plus
    a text-encoder entry the UNet merge skips."""
    rng = np.random.RandomState(seed)
    mods = {  # diffusers module name: (in, out, kernel or None)
        "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q":
            (32, 32, None),
        "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k":
            (32, 32, None),
        "up_blocks.1.attentions.1.transformer_blocks.0.attn1.to_out.0":
            (64, 64, None),
        "mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj":
            (64, 512, None),
        "up_blocks.2.attentions.0.transformer_blocks.0.ff.net.2":
            (128, 32, None),
        "down_blocks.1.resnets.0.conv1": (32, 64, 3),
        "up_blocks.0.resnets.1.conv_shortcut": (128, 64, 1),
        "mid_block.attentions.0.proj_in": (64, 64, None),
        "down_blocks.0.downsamplers.0.conv": (32, 32, 3)}
    if kind == "peft":
        mods["time_embedding.linear_1"] = (32, 128, None)
    sd = {"lora_te_text_model_encoder_layers_0_mlp_fc1.lora_down.weight":
          rng.randn(rank, 8).astype(np.float32)}
    for name, (cin, cout, k) in mods.items():
        if k is None:
            a = rng.randn(rank, cin) / np.sqrt(cin)
            b = rng.randn(cout, rank) * 0.1
        else:
            a = rng.randn(rank, cin, k, k) / np.sqrt(cin * k * k)
            b = rng.randn(cout, rank, 1, 1) * 0.1
        a, b = a.astype(np.float32), b.astype(np.float32)
        if kind == "peft":
            sd[f"unet.{name}.lora_A.weight"] = a
            sd[f"unet.{name}.lora_B.weight"] = b
        else:
            flat = f"lora_unet_{name.replace('.', '_')}"
            sd[f"{flat}.lora_down.weight"] = a
            sd[f"{flat}.lora_up.weight"] = b
            sd[f"{flat}.alpha"] = np.float32(rng.randint(1, 2 * rank))
    return sd


@pytest.mark.parametrize("kind,scale", [("peft", 1.0), ("kohya", 0.7)])
def test_apply_lora_unet_matches(kind, scale):
    """Every tensor of the port's merged UNet against the JAX merge carried
    across by from_flax: bound 1e-6 absolute (one fp32 add of the same
    numpy delta).  The merged tensors moved and the rest did not; the
    input UNet is left as it was; the kohya names map back to the
    diffusers ones."""
    jb, tb = bundles()
    sd = _lora_sd(kind)
    if kind == "kohya":
        assert set(tlora.extract_lora_pairs(sd)) == set(
            jlora.extract_lora_pairs(sd))
    before = {k: v.clone() for k, v in tb.unet.state_dict().items()}
    merged_t = tlora.apply_lora_unet(tb.unet, sd, scale=scale).state_dict()
    merged_j = from_flax("unet", jlora.apply_lora_unet(jb.unet_params, sd,
                                                       scale=scale))
    assert set(merged_t) == set(merged_j)
    moved = 0
    for name, ref in merged_j.items():
        got = merged_t[name].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=name)
        torch.testing.assert_close(tb.unet.state_dict()[name], before[name],
                                   rtol=0, atol=0)
        moved += not np.array_equal(got, before[name].numpy())
    assert moved == (10 if kind == "peft" else 9)


def test_apply_lora_unet_ip_processor_names_and_refusals():
    """The IP UNet's diffusers processor names (attn2.processor.to_k_ip)
    merge as in the JAX package; an unmatched module, a state dict without
    pairs and a misshapen factor raise."""
    jb, tb = bundles()
    rng = np.random.RandomState(41)
    name = ("up_blocks.1.attentions.0.transformer_blocks.0.attn2."
            "processor.to_k_ip")
    sd = {f"unet.{name}.lora_A.weight": rng.randn(2, 32).astype(np.float32),
          f"unet.{name}.lora_B.weight": rng.randn(64, 2).astype(np.float32)}
    got = tlora.apply_lora_unet(tb.unet_ip, sd).state_dict()
    ref = from_flax("unet", jlora.apply_lora_unet(jb.unet_ip_params, sd))
    key = name.replace(".processor", "") + ".weight"
    np.testing.assert_allclose(got[key].numpy(), ref[key], rtol=0, atol=1e-6)
    bad = {"unet.down_blocks.9.resnets.0.conv1.lora_A.weight":
           np.zeros((2, 4, 3, 3), np.float32),
           "unet.down_blocks.9.resnets.0.conv1.lora_B.weight":
           np.zeros((4, 2, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="no matching param"):
        jlora.apply_lora_unet(jb.unet_params, bad)
    with pytest.raises(ValueError, match="unmapped"):
        tlora.apply_lora_unet(tb.unet, bad)
    with pytest.raises(ValueError):
        tlora.apply_lora_unet(tb.unet, {"x.alpha": np.float32(1)})
    wrong = {f"unet.{name}.lora_A.weight": np.zeros((2, 31), np.float32),
             f"unet.{name}.lora_B.weight": np.zeros((64, 2), np.float32)}
    with pytest.raises(ValueError):
        tlora.apply_lora_unet(tb.unet_ip, wrong)


# ---------------------------------------------------------------------------
# chip_smoke.py's launch derivation against the layers' own routing
# ---------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_derived_launches_are_the_sites(monkeypatch):
    """chip_smoke.eval_launches, which derives each evaluation kind's
    launches from the routing functions, against the kernel calls the
    full-size bf16 models make on the meta device (GroupNorm switch "1"):
    the SD1.5 IP UNet at 512 px in each of the four kinds (CFG or
    cond-only, full or shallow; DeepCache at cache_level 1 and 2), the
    ControlNet at batch 2 and 1, and SDXL at 1024 px, full at batch 1 and
    shallow.  Also the batch-1 FF and GroupNorm shapes chip_smoke.py checks
    (FF_SHAPES, GN_SHAPES) are the cond-only evaluation's sites."""
    from theatergen_tpu_torch.models.controlnet import ControlNet as TCN
    from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
    from theatergen_tpu_torch.ops import attention as tat
    from theatergen_tpu_torch.ops import flash_attention as tfa
    from theatergen_tpu_torch.ops import geglu_matmul as tgg
    from theatergen_tpu_torch.ops import groupnorm as tgn
    cs = _chip_smoke()
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    calls, ff_shapes, gn_shapes = (collections.Counter() for _ in range(3))
    real = (tfa.flash_attention, tgg.ff_matmul, tgg.geglu_matmul,
            tgn.fused_group_norm)

    def flash(q, k, v, route=None):
        calls[cs.FLASH_COUNTERS[tfa.COUNTERS[route]]] += 1
        return real[0](q, k, v, route=route)

    def ff(x, w1, b1, w2):
        calls["ff_geglu"] += 1
        ff_shapes[(x.reshape(-1, x.shape[-1]).shape[0], x.shape[-1],
                   w2.shape[1])] += 1
        return real[1](x, w1, b1, w2)

    def geglu(hg, w):
        calls["geglu_matmul"] += 1
        return real[2](hg, w)

    def norm(x, *a, **k):
        calls["group_norm"] += 1
        gn_shapes[(x.shape[0], x.shape[1], x.shape[2] * x.shape[3])] += 1
        return real[3](x, *a, **k)

    real_cross = tat.cross_attention

    def cross(*a, **k):
        calls["cross_attention"] += 1
        return real_cross(*a, **k)

    monkeypatch.setattr(tfa, "flash_attention", flash)
    monkeypatch.setattr(tgg, "ff_matmul", ff)
    monkeypatch.setattr(tgg, "geglu_matmul", geglu)
    monkeypatch.setattr(tgn, "fused_group_norm", norm)
    monkeypatch.setattr(tat, "cross_attention", cross)
    sd, xl = tcfg.sd15_config(), tcfg.sdxl_config()

    def site_counts(fn):
        calls.clear()
        with torch.device("meta"), torch.no_grad():
            fn()
        return dict(calls)

    with torch.device("meta"):
        unet = TUNet(dataclasses.replace(sd.unet, ip_num_tokens=4)).to(
            torch.bfloat16)
        cn = TCN(sd.controlnet).to(torch.bfloat16)
        xl_unet = TUNet(xl.unet).to(torch.bfloat16)
    for b in (2, 1):
        with torch.device("meta"):
            x = torch.empty(b, 4, 64, 64)
            t = torch.empty(b, dtype=torch.long)
            ctx = torch.empty(b, 81, 768)
        got = site_counts(lambda: cn(x, t, ctx[:, :77],
                                     torch.empty(b, 3, 512, 512)))
        assert got == dict(cs.eval_launches(sd.controlnet.unet, 64, b,
                                            encoder_only=True)), ("cn", b)
        ff_shapes.clear()
        gn_shapes.clear()
        got = site_counts(lambda: unet(x, t, ctx, ip_scale=0.4))
        assert got == dict(cs.eval_launches(sd.unet, 64, b)), ("full", b)
        if b == 1:
            for shapes, listed in ((ff_shapes, cs.FF_SHAPES),
                                   (gn_shapes, cs.GN_SHAPES)):
                assert dict(shapes) == {tuple(s): n for m, s, n in listed
                                        if m == cs.SD15_B1}
        for level in (1, 2):
            with torch.device("meta"), torch.no_grad():
                _, cache = unet(x, t, ctx, ip_scale=0.4,
                                return_deep_cache=True, cache_level=level)
            got = site_counts(lambda: unet(x, t, ctx, ip_scale=0.4,
                                           deep_cache=cache,
                                           cache_level=level))
            assert got == dict(cs.eval_launches(
                sd.unet, 64, b, shallow=True, cache_level=level)), (
                "shallow", b, level)
    with torch.device("meta"):
        x = torch.empty(1, 4, 128, 128)
        t = torch.empty(1, dtype=torch.long)
        kw = dict(pooled_text=torch.empty(1, 1280),
                  time_ids=torch.empty(1, 6))
        ctx = torch.empty(1, 77, 2048)
    got = site_counts(lambda: xl_unet(x, t, ctx, **kw))
    assert got == dict(cs.eval_launches(xl.unet, 128, 1)), "sdxl"
    with torch.device("meta"), torch.no_grad():
        _, cache = xl_unet(x, t, ctx, return_deep_cache=True, **kw)
    got = site_counts(lambda: xl_unet(x, t, ctx, deep_cache=cache, **kw))
    assert got == dict(cs.eval_launches(xl.unet, 128, 1, shallow=True))
