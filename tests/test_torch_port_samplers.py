"""The port's samplers and the denoise loop's knobs against the JAX
package, at ``tiny_config()`` in fp32 on the CPU:

- ``ops/scheduler.py``: the tables of every ``make_sampler`` kind, each
  ``Sampler.step`` with injected noise under every prediction type (with
  and without the zero-terminal-SNR rescale), DDIM inversion,
  ``add_noise`` and ``cfg_cutoff_steps``.  The port's steps read tables
  moved to the device once (``Sampler.on``), the JAX steps index
  host-made arrays.
- ``models/unet.py``'s DeepCache: the full forward's ``(eps, cache)`` and
  the shallow forward from a given cache at ``cache_level`` 1 and 2, with
  IP tokens and with ControlNet residuals.
- ``pipelines/sd.py``: ``denoise`` under DeepCache × CFG cutoff,
  ``lcm_denoise``, ``invert`` and ``Text2Img(sampler="lcm")``.

Both sides get the same weights (seeded numpy trees, carried across by
``weights.from_flax``), inputs and noise: the JAX draws of
``jax.random.fold_in(rng, i)`` are made here and injected into the port,
whose own streams are ``torch.Generator``s.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_models import random_params
from theatergen_tpu import config as jcfg
from theatergen_tpu.models.clip import CLIPTextEncoder as JText
from theatergen_tpu.models.controlnet import ControlNet as JControlNet
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.ops import scheduler as jsched
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.ops import scheduler as tsched
from theatergen_tpu_torch.pipelines import sd as tsd
from theatergen_tpu_torch.pipelines.bundle import init_bundle

torch.set_num_threads(1)

CFG = jcfg.tiny_config()
H = W = CFG.pipeline.height          # 16 px canvas
h = w = CFG.pipeline.latent_height   # 8 latent pixels
PROMPTS = ["a red knight rides through a dark forest"]


def _close(got, ref, bound: float, what: str = "") -> None:
    """max|got − ref| ≤ bound·max(max|ref|, 1), finite where ref is."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    np.testing.assert_array_equal(got[~fin], ref[~fin], err_msg=what)
    scale = max(float(np.abs(ref[fin]).max(initial=0.0)), 1.0)
    err = float(np.abs(got[fin] - ref[fin]).max(initial=0.0))
    assert err <= bound * scale, (what, err, bound * scale)


def _cfgs(**kw):
    return jcfg.SchedulerConfig(**kw), tcfg.SchedulerConfig(**kw)


@pytest.mark.parametrize("kind,steps,kw", [
    ("ddim", 50, {}), ("ddim", 20, dict(fast_after_steps=5)),
    ("ddim", 4, {}), ("euler_ancestral", 30, {}),
    ("euler_ancestral", 25, dict(zsnr=True)),
    ("lcm", 4, {}), ("lcm", 8, {}), ("lcm", 50, {}),
    ("lcm", 6, dict(zsnr=True))])
def test_make_sampler_tables_equal(kind, steps, kw):
    """Timesteps equal; every table within 1e-7 (the same numpy, fp32);
    LCM's boundary weights against the JAX step's fp32 formula;
    init_noise_sigma and the number of steps equal."""
    fast = kw.get("fast_after_steps")
    jc, tc = _cfgs(rescale_zero_terminal_snr=kw.get("zsnr", False))
    j = jsched.make_sampler(jc, steps, kind=kind, fast_after_steps=fast)
    t = tsched.make_sampler(tc, steps, kind=kind, fast_after_steps=fast)
    assert t.kind == j.kind and t.num_steps == j.num_steps
    np.testing.assert_array_equal(t.timesteps, np.asarray(j.timesteps))
    assert t.init_noise_sigma == float(j.init_noise_sigma)
    names = {"ddim": ("alphas_cumprod", "alpha_prod", "alpha_prod_prev"),
             "euler_ancestral": ("sigmas",),
             "lcm": ("alpha_prod", "alpha_prod_prev")}[kind]
    for name in names:
        np.testing.assert_allclose(getattr(t.schedule, name),
                                   np.asarray(getattr(
                                       j.ddim or j.ea or j.lcm, name)),
                                   rtol=0, atol=1e-7, err_msg=name)
    if kind == "lcm":
        st = jnp.asarray(j.lcm.timesteps).astype(jnp.float32) * 10.0
        np.testing.assert_allclose(t.lcm.c_skip, 0.25 / (st ** 2 + 0.25),
                                   rtol=0, atol=1e-7)
        np.testing.assert_allclose(
            t.lcm.c_out, st / jnp.sqrt(st ** 2 + 0.25), rtol=0, atol=1e-7)
    dev = t.on("cpu")
    assert dev.timesteps.dtype == torch.long
    np.testing.assert_array_equal(dev.timesteps.numpy(), t.timesteps)


@pytest.mark.parametrize("zsnr", [False, True])
@pytest.mark.parametrize("pred", ["epsilon", "v_prediction", "sample"])
@pytest.mark.parametrize("kind", ["ddim", "euler_ancestral", "lcm"])
def test_sampler_step_matches(kind, pred, zsnr):
    """scale_model_input and step at every loop position of a 6-step
    schedule, eps and noise injected.  fp32 elementwise; EA latents are
    O(sigma_0) ~ 14.6: bound 1e-5·max(max|ref|, 1).  Under zero SNR the
    LCM grid's t = 999 has alpha 0, so x0 divides by zero there in both
    packages: the infinities must agree."""
    jc, tc = _cfgs(prediction_type=pred, rescale_zero_terminal_snr=zsnr)
    j = jsched.make_sampler(jc, 6, kind=kind)
    t = tsched.make_sampler(tc, 6, kind=kind)
    assert t.needs_noise == (kind != "ddim")
    dev = t.on("cpu")
    rng = np.random.RandomState(11)
    x = (rng.randn(1, 4, 4, 4) * t.init_noise_sigma).astype(np.float32)
    eps, noise = (rng.randn(1, 4, 4, 4).astype(np.float32)
                  for _ in range(2))
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(6):
            ref = j.scale_model_input(jnp.asarray(x), i)
            got = dev.scale_model_input(torch.from_numpy(x), i)
            _close(got.numpy(), ref, 1e-5, f"scale {i}")
            ref = j.step(jnp.asarray(eps), i, jnp.asarray(x),
                         noise=jnp.asarray(noise))
            n = None if kind == "lcm" and i == 5 else torch.from_numpy(noise)
            got = dev.step(torch.from_numpy(eps), i, torch.from_numpy(x), n)
            _close(got.numpy(), ref, 1e-5, f"step {i}")


def test_steps_that_draw_refuse_without_noise():
    dev = tsched.make_sampler(tcfg.SchedulerConfig(), 4,
                              kind="euler_ancestral").on("cpu")
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError):
        dev.step(x, 0, x)
    lcm = tsched.make_sampler(tcfg.SchedulerConfig(), 4, kind="lcm").on("cpu")
    with pytest.raises(ValueError):
        lcm.step(x, 0, x)
    assert torch.isfinite(lcm.step(x, 3, x)).all()     # the last needs none
    for kind, want in (("ddim", [False] * 4), ("euler_ancestral", [True] * 4),
                       ("lcm", [True, True, True, False])):
        s = tsched.make_sampler(tcfg.SchedulerConfig(), 4, kind=kind)
        assert [s.draws(i) for i in range(4)] == want
    with pytest.raises(ValueError):
        tsched.make_sampler(tcfg.SchedulerConfig(), 4, kind="heun")


@pytest.mark.parametrize("pred", ["epsilon", "v_prediction"])
def test_inversion_schedule_and_step_match(pred):
    """make_inversion_schedule's tables bit for bit, and ddim_inverse_step
    at every position: bound 2e-6 relative to O(1) latents."""
    jc, tc = _cfgs(prediction_type=pred)
    j = jsched.make_inversion_schedule(jc, 10)
    t = tsched.make_inversion_schedule(tc, 10)
    for name in ("timesteps", "alphas_cumprod", "alpha_prod",
                 "alpha_prod_prev"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))
    assert np.all(np.diff(t.timesteps) > 0)
    tables = tsched.device_tables(t, "cpu")
    rng = np.random.RandomState(12)
    x, eps = (rng.randn(2, 4, 4, 4).astype(np.float32) for _ in range(2))
    for i in range(10):
        ref = jsched.ddim_inverse_step(j, jnp.asarray(eps), i, jnp.asarray(x))
        got = tsched.ddim_inverse_step(tables, torch.from_numpy(eps), i,
                                       torch.from_numpy(x))
        _close(got.numpy(), ref, 2e-6, f"inverse step {i}")


def test_add_noise_matches():
    """A scalar timestep and a vector of per-row targets (the frozen-latent
    preparation's broadcast over a leading axis): bound 1e-6."""
    jc, tc = _cfgs()
    j = jsched.make_schedule(jc, 50)
    t = tsched.make_schedule(tc, 50)
    rng = np.random.RandomState(13)
    x, n = (rng.randn(5, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    for tv in (981, np.array([981, 501, 21, 1, 999], np.int32)):
        ref = jsched.add_noise(j, jnp.asarray(x), jnp.asarray(n),
                               jnp.asarray(tv))
        got = tsched.add_noise(t, torch.from_numpy(x), torch.from_numpy(n),
                               torch.as_tensor(tv))
        _close(got.numpy(), ref, 1e-6)


@pytest.mark.parametrize("steps", [1, 4, 50])
@pytest.mark.parametrize("fraction", [None, 0, 0.01, 0.5, 1, 1.5])
def test_cfg_cutoff_steps_equal(fraction, steps):
    got = tsched.cfg_cutoff_steps(steps, fraction)
    assert got == jsched.cfg_cutoff_steps(steps, fraction)
    assert 1 <= got <= steps


# ---------------------------------------------------------------------------
# DeepCache in the UNet, and the txt2img loops
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def bundles(cfg_key: tuple = ()):
    """A JAX bundle and the port's on the same random weights: the text
    tower, the base UNet, the IP UNet (4 IP tokens), the ControlNet and
    the VAE.  ``cfg_key`` is a tuple of (part, field, value) overrides of
    the tiny config, applied to both."""
    jc, tc = jcfg.tiny_config(), tcfg.tiny_config()
    for part, field, value in cfg_key:
        jc = dataclasses.replace(jc, **{part: dataclasses.replace(
            getattr(jc, part), **{field: value})})
        tc = dataclasses.replace(tc, **{part: dataclasses.replace(
            getattr(tc, part), **{field: value})})
    zeros = functools.partial(jnp.zeros, dtype=jnp.float32)
    t0 = jnp.zeros((1,), jnp.int32)
    text = JText(jc.text)
    tp = random_params(text, 3, jnp.zeros((1, 16), jnp.int32))
    unet = JUNet(jc.unet)
    up = random_params(unet, 0, zeros((1, h, w, 4)), t0, zeros((1, 16, 32)))
    unet_ip = JUNet(dataclasses.replace(jc.unet, ip_num_tokens=4))
    uip = random_params(unet_ip, 1, zeros((1, h, w, 4)), t0,
                        zeros((1, 20, 32)))
    cn = JControlNet(jc.controlnet)
    cp = random_params(cn, 2, zeros((1, h, w, 4)), t0, zeros((1, 16, 32)),
                       zeros((1, H, W, 3)))
    vae = JVAE(jc.vae)
    vp = random_params(vae, 6, zeros((1, H, W, 3)))
    jb = JBundle(cfg=jc, tokenizer=jtok.HashTokenizer(1024), unet=unet,
                 unet_params=up, vae=vae, vae_params=vp, text=text,
                 text_params=tp, unet_ip=unet_ip, unet_ip_params=uip,
                 controlnet=cn, controlnet_params=cp)
    tb = init_bundle(tc, 0, device="cpu", with_ip=True,
                     with_controlnet=True).load_flax(
        text=tp, unet=up, unet_ip=uip, controlnet=cp, vae=vp)
    return jb, tb


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def jax_noise(rng, steps: int, shape) -> np.ndarray:
    """The JAX samplers' per-step draws, ``normal(fold_in(rng, i))``."""
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(rng, i), shape, jnp.float32))
        for i in range(steps)])


def _unet_case(ip: bool, residuals: bool, seed: int = 21):
    jb, tb = bundles()
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, 4).astype(np.float32)
    t = np.array([501, 501], np.int32)
    ctx = rng.randn(2, 20 if ip else 16, 32).astype(np.float32)
    jkw, tkw = {}, {}
    if ip:
        jkw["ip_scale"] = jnp.float32(0.4)
        tkw["ip_scale"] = torch.tensor(0.4)
    if residuals:
        cond = rng.rand(2, H, W, 3).astype(np.float32)
        down, mid = jb.controlnet.apply(
            {"params": jb.controlnet_params}, jnp.asarray(x), jnp.asarray(t),
            jnp.asarray(ctx[:, :16]), jnp.asarray(cond), 1.0)
        jkw.update(down_residuals=down, mid_residual=mid)
        tkw.update(down_residuals=tuple(_nchw(r) for r in down),
                   mid_residual=_nchw(mid))
    module, params = ((jb.unet_ip, jb.unet_ip_params) if ip
                      else (jb.unet, jb.unet_params))
    unet_t = tb.unet_ip if ip else tb.unet
    return (lambda **kw: module.apply({"params": params}, jnp.asarray(x),
                                      jnp.asarray(t), jnp.asarray(ctx),
                                      **jkw, **kw),
            lambda **kw: unet_t(_nchw(x), torch.from_numpy(t),
                                torch.from_numpy(ctx), **tkw, **kw), rng)


@pytest.mark.parametrize("ip,residuals", [(False, False), (True, False),
                                          (False, True), (True, True)])
@pytest.mark.parametrize("level", [1, 2])
def test_deep_cache_matches(level, ip, residuals):
    """The full forward's (eps, cache) and the shallow forward from a
    random cache of that shape, against the JAX UNet at ``cache_level`` 1
    and 2, with IP tokens and with ControlNet residuals (the shallow
    forward adds only the prefix of the residuals it has skips for).  The
    cache is compared itself: a cache taken and resumed at the same wrong
    point would pass a self-check.  fp32 through the tiny UNet: bound
    1e-5·max|ref|."""
    run_j, run_t, rng = _unet_case(ip, residuals)
    with torch.no_grad():
        eps_j, cache_j = run_j(return_deep_cache=True, cache_level=level)
        eps_t, cache_t = run_t(return_deep_cache=True, cache_level=level)
        _close(_nhwc(eps_t), eps_j, 1e-5, "eps")
        _close(_nhwc(cache_t), cache_j, 1e-5, "cache")
        fake = rng.randn(*cache_j.shape).astype(np.float32)
        shallow_j = run_j(deep_cache=jnp.asarray(fake), cache_level=level)
        shallow_t = run_t(deep_cache=_nchw(fake), cache_level=level)
        _close(_nhwc(shallow_t), shallow_j, 1e-5, "shallow")
        assert float(np.abs(np.asarray(shallow_j) - np.asarray(eps_j)).max()
                     ) > 1e-3


@pytest.mark.parametrize("level", [1, 2, 3])
def test_shallow_forward_from_its_own_cache_is_the_full_forward(level):
    """The same computation: the shallow forward recomputes the encoder
    prefix and the last up blocks exactly as the full forward does, so
    from the full forward's own cache it is equal bit for bit."""
    _, run_t, _ = _unet_case(True, True)
    with torch.no_grad():
        eps, cache = run_t(return_deep_cache=True, cache_level=level)
        torch.testing.assert_close(
            run_t(deep_cache=cache, cache_level=level), eps, rtol=0, atol=0)
        with pytest.raises(ValueError):
            run_t(deep_cache=cache, cache_level=4)


@functools.lru_cache(maxsize=None)
def _jax_denoise(steps, interval, cutoff):
    jb, _ = bundles()
    sched = jsched.make_schedule(CFG.scheduler, steps)

    def unet_apply(x, t, ctx, **kw):
        return jb.unet.apply({"params": jb.unet_params}, x,
                             jnp.broadcast_to(t[None], (x.shape[0],)), ctx,
                             **kw)

    return jax.jit(lambda lat, ctx: jsd.denoise(
        unet_apply, sched, lat, ctx, 7.5, collect_trajectory=True,
        cfg_cutoff_steps=cutoff, deepcache_interval=interval))


@pytest.mark.parametrize("cutoff", [None, 1, 3])
@pytest.mark.parametrize("interval", [2, 3])
def test_denoise_deepcache_and_cutoff_match(interval, cutoff):
    """sd.denoise, 5 DDIM steps at CFG 7.5, DeepCache every 2nd or 3rd
    step × CFG cutoff after 1 or 3 steps (the cache cut to its cond rows
    at the switch), trajectory included, against the JAX scan.  CFG 7.5
    amplifies each step's eps difference and the latents grow to O(10):
    bound 2e-5·max|ref| (measured ≤ 3e-6)."""
    jb, tb = bundles()
    rng = np.random.RandomState(22)
    lat = rng.randn(1, h, w, 4).astype(np.float32)
    ctx = rng.randn(2, 16, 32).astype(np.float32)
    fj, trj = _jax_denoise(5, interval, cutoff)(jnp.asarray(lat),
                                                jnp.asarray(ctx))
    sched = tsched.make_schedule(tb.cfg.scheduler, 5)
    ft, trt = tsd.denoise(tb.unet, sched, torch.from_numpy(lat),
                          torch.from_numpy(ctx), 7.5, collect_trajectory=True,
                          cfg_cutoff_steps=cutoff,
                          deepcache_interval=interval)
    _close(trt.numpy(), trj, 2e-5, "trajectory")
    _close(ft.numpy(), fj, 2e-5, "final")
    exact, _ = tsd.denoise(tb.unet, sched, torch.from_numpy(lat),
                           torch.from_numpy(ctx), 7.5)
    assert float((exact - ft).abs().max()) > 1e-4    # the knobs took effect


def test_lcm_denoise_matches():
    """4 LCM steps, cond-only, the JAX draws injected: bound 1e-5·max|ref|
    (no CFG amplification)."""
    jb, tb = bundles()
    rng = np.random.RandomState(23)
    lat = rng.randn(1, h, w, 4).astype(np.float32)
    ctx = rng.randn(1, 16, 32).astype(np.float32)
    key = jax.random.key(3)
    js = jsched.make_sampler(CFG.scheduler, 4, kind="lcm")

    def unet_apply(x, t, c):
        return jb.unet.apply({"params": jb.unet_params}, x,
                             jnp.broadcast_to(t[None], (x.shape[0],)), c)

    ref = jax.jit(lambda l, c: jsd.lcm_denoise(unet_apply, js, l, c, key))(
        jnp.asarray(lat), jnp.asarray(ctx))
    noise = jax_noise(key, 4, lat.shape)
    got = tsd.lcm_denoise(tb.unet, tsched.make_sampler(
        tb.cfg.scheduler, 4, kind="lcm"), torch.from_numpy(lat),
        torch.from_numpy(ctx), noise=torch.from_numpy(noise))
    _close(got.numpy(), ref, 1e-5)
    with pytest.raises(ValueError):
        tsd.lcm_denoise(tb.unet, tsched.make_sampler(
            tb.cfg.scheduler, 4, kind="lcm"), torch.from_numpy(lat),
            torch.from_numpy(ctx))


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_invert_matches(scale):
    """DDIM inversion over 4 ascending steps, trajectory included: bound
    1e-5·max|ref| at guidance 1, 2e-5 at 3 (which amplifies the eps
    difference)."""
    jb, tb = bundles()
    rng = np.random.RandomState(24)
    lat = rng.randn(1, h, w, 4).astype(np.float32)
    ctx = rng.randn(2, 16, 32).astype(np.float32)
    fj, trj = jsd.invert(jb, jnp.asarray(lat), jnp.asarray(ctx), 4, scale)
    ft, trt = tsd.invert(tb, torch.from_numpy(lat), torch.from_numpy(ctx), 4,
                         scale)
    assert tuple(trt.shape) == (5, 1, h, w, 4)
    np.testing.assert_array_equal(trt[0].numpy(), lat)
    bound = 1e-5 if scale == 1.0 else 2e-5
    _close(trt.numpy(), trj, bound, "trajectory")
    _close(ft.numpy(), fj, bound, "final")


def test_text2img_lcm_matches(monkeypatch):
    """Text2Img(sampler="lcm"): the prompt's cond rows through 4 LCM steps
    and the decode, the JAX request's starting latents and per-step draws
    (``fold_in(fold_in(rng, 1), i)``) injected.  Image bound 1e-5 (values
    in [0, 1])."""
    jb, tb = bundles()
    rng = jax.random.key(9)
    lat = np.asarray(jsd.seeded_latents(rng, 1, h, w))
    noise = jax_noise(jax.random.fold_in(rng, 1), 4, lat.shape)
    ref = jsd.Text2Img(jb, num_steps=4, sampler="lcm")(rng, PROMPTS)
    monkeypatch.setattr(tsd, "seeded_latents",
                        lambda *a, **k: torch.tensor(lat))
    pipe = tsd.Text2Img(tb, num_steps=4, sampler="lcm")
    assert pipe.sampler.kind == "lcm" and pipe.sched is None
    got = pipe(torch.Generator().manual_seed(0), PROMPTS,
               noise=torch.from_numpy(noise))
    _close(got.numpy(), ref, 1e-5)
    with pytest.raises(ValueError):
        tsd.Text2Img(tb, num_steps=4, sampler="euler_ancestral")


def test_text2img_runs_each_sampler_with_a_generator():
    """The entry point as a user calls it, drawing its own noise: LCM, and
    DDIM with DeepCache from the config (cfg.pipeline.deepcache_interval),
    seeded and deterministic, [1, H, W, 3] in [0, 1]."""
    _, tb = bundles((("pipeline", "deepcache_interval", 2),))
    for sampler in ("lcm", "ddim"):
        pipe = tsd.Text2Img(tb, num_steps=4, sampler=sampler)
        a = pipe(torch.Generator().manual_seed(5), "a knight")
        b = pipe(torch.Generator().manual_seed(5), "a knight")
        assert a.shape == (1, H, W, 3)
        assert torch.isfinite(a).all() and 0 <= a.min() and a.max() <= 1
        torch.testing.assert_close(a, b, rtol=0, atol=0)
