"""The port's trainer against ``theatergen_tpu.training`` on the CPU.

Both sides run fp32 at ``tiny_config()`` with the IP-Adapter's tokens
(an IP UNet, so the IP recipe's filter has leaves to train), on the same
weights (``from_flax``) and the same draws: the JAX loss splits its key
into ``randint`` and ``normal`` draws (``diffusion.py:54-56``), which the
test reproduces with ``jax.random`` and hands to the port as ``t=`` and
``noise=``.  The optimizer is held to optax on identical gradient streams.
Each test states its bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.ops import quant as JQ
from theatergen_tpu.ops import scheduler as jsched
from theatergen_tpu.training import diffusion as jtrain
from theatergen_tpu_torch.config import tiny_config
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.models.weights import from_flax, load_into
from theatergen_tpu_torch.pipelines.bundle import build_module
from theatergen_tpu_torch.training import diffusion as ttrain

from test_torch_port_models import random_params

torch.set_num_threads(1)

IP_TOKENS = 4
B, SIDE = 2, 8
TEXT_LEN = jcfg.tiny_config().text.max_length
CTX_LEN = TEXT_LEN + IP_TOKENS


def attn2_filter(name):
    """The JAX test's filter (tests/test_parallel.py:104)."""
    return "attn2" in name


def ip_filter(name):
    """The IP-Adapter recipe: only the decoupled image projections."""
    return "to_k_ip" in name or "to_v_ip" in name


def _np(t):
    return t.detach().float().cpu().numpy()


def jax_draws(key, shape):
    """The JAX loss's draws from ``key`` (diffusion.py:54-56)."""
    t_rng, n_rng = jax.random.split(key)
    t = jax.random.randint(t_rng, (shape[0],), 0, 1000)
    noise = jax.random.normal(n_rng, shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


def port_names(params):
    """JAX leaf path ("/"-joined, as the JAX filter sees it) → the port's
    parameter name, through from_flax's map: each leaf is tagged with its
    index."""
    leaves = jax.tree_util.tree_leaves_with_path(params)
    paths = ["/".join(str(getattr(k, "key", k)) for k in p)
             for p, _ in leaves]
    tagged = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full(np.shape(v), i, np.float32)
         for i, (_, v) in enumerate(leaves)])
    out = {}
    for name, arr in from_flax("unet", tagged).items():
        out[paths[int(arr.flat[0])]] = name
    return out


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.tiny_config()
    jucfg = dataclasses.replace(jc.unet, ip_num_tokens=IP_TOKENS)
    junet = JUNet(jucfg)
    params = random_params(junet, 0, jnp.zeros((1, SIDE, SIDE, 4)),
                           jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1, CTX_LEN, 32)))
    rng = np.random.RandomState(5)
    lat = (0.5 * rng.randn(B, SIDE, SIDE, 4)).astype(np.float32)
    ctx = rng.randn(B, CTX_LEN, 32).astype(np.float32)

    def apply(p, x, t, c):
        return junet.apply({"params": p}, x, t, c)

    return dict(jc=jc, junet=junet, params=params, apply=apply, lat=lat,
                ctx=ctx, names=port_names(params))


def port_unet(params):
    cfg = tiny_config()
    ucfg = dataclasses.replace(cfg.unet, ip_num_tokens=IP_TOKENS)
    unet = build_module(TUNet, ucfg, torch.float32, "cpu")
    return load_into(unet, from_flax("unet", params)), cfg


def jax_step(setup, opt, trainable_filter=None):
    return jax.jit(jtrain.make_train_step(
        setup["apply"], opt, setup["jc"].scheduler,
        trainable_filter=trainable_filter))


def flat_port(tree):
    return {k: np.asarray(v) for k, v in from_flax("unet", tree).items()}


# ---------------------------------------------------------------- optimizer


@pytest.mark.parametrize("kw", [{}, {"warmup": 0},
                                {"lr": 1e-2, "warmup": 5}],
                         ids=["defaults", "warmup0", "lr1e-2_warmup5"])
def test_optimizer_matches_optax(kw):
    """20 steps on identical seeded gradients, alternately under (x0.05)
    and over (x5) the clipping norm 1: parameters, moments and count after
    every step.  Bound: fp32 rounding of the same formulas in another
    order (torch's fused multiply-adds): on the moments 2e-6 relative
    plus 1e-6 of the tensor's max|ref| (b1·m and (1 - b1)·g cancel where
    they have opposite signs, so the rounding of the terms is the scale),
    on parameters of magnitude <= 3 1e-7 absolute."""
    rng = np.random.RandomState(0)
    shapes = {"a": (4, 3), "b": (5,), "c": (2, 3, 2)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    jopt = jtrain.make_optimizer(**kw)
    topt = ttrain.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jopt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = topt.init(tp)
    clipped = []
    for i in range(20):
        scale = 0.05 if i % 2 == 0 else 5.0
        g = {k: (scale * rng.randn(*s)).astype(np.float32)
             for k, s in shapes.items()}
        clipped.append(float(optax.global_norm(g)) >= 1.0)
        upd, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              js, jp)
        jp = optax.apply_updates(jp, upd)
        rate = topt.update(tp, {k: torch.from_numpy(v.copy())
                                for k, v in g.items()}, ts)
        adam = js[1][0]
        assert ts.count == int(adam.count) == int(js[1][2].count) == i + 1
        assert rate == pytest.approx(float(optax.warmup_cosine_decay_schedule(
            0.0, topt.lr, topt.warmup, 100_000, topt.lr * 0.1)(i)), rel=1e-6)
        assert rate == float(topt.learning_rate(i))
        for k in shapes:
            np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                       rtol=0, atol=1e-7)
            for got, ref in ((ts.mu[k], adam.mu[k]), (ts.nu[k], adam.nu[k])):
                ref = np.asarray(ref)
                np.testing.assert_allclose(_np(got), ref, rtol=2e-6,
                                           atol=1e-6 * np.abs(ref).max())
    assert any(clipped) and not all(clipped)
    moved = max(np.abs(_np(tp[k]) - p0[k]).max() for k in shapes)
    assert moved > 0


@pytest.mark.parametrize("warmup", [100, 0, 7])
def test_schedule_matches_optax(warmup):
    """The rate at counts 0, 1, warmup, warmup + k and past decay_steps;
    bound 1e-6 relative (fp32 cos in numpy and in XLA)."""
    opt = ttrain.make_optimizer(lr=3e-4, warmup=warmup)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, 100_000,
                                             3e-5)
    for count in (0, 1, warmup, warmup + 1, warmup + 37, warmup + 50_000,
                  100_000, 100_500):
        want = float(ref(count))
        got = float(opt.learning_rate(count))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), count
    if warmup:
        # read before the count advances: the first update has rate 0
        assert float(opt.learning_rate(0)) == 0.0


# --------------------------------------------------------------- the loss


def test_loss_and_every_gradient_match_jax(setup):
    """diffusion_loss and the gradient of every parameter against
    jax.value_and_grad, with JAX's own draws handed over.  Bounds: the
    loss 1e-5 relative; each gradient within 2e-4 of its tensor's
    max|ref| plus 1e-6 absolute (fp32 through ~40 layers forward and
    back, as the UNet's eps at 5e-5)."""
    unet, cfg = port_unet(setup["params"])
    key = jax.random.key(11)
    sched = jsched.make_schedule(setup["jc"].scheduler, 1000)
    lat, ctx = jnp.asarray(setup["lat"]), jnp.asarray(setup["ctx"])
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.diffusion_loss(setup["apply"], p, sched, lat, ctx,
                                        key)))(setup["params"])
    ts = ttrain.make_train_step(unet, ttrain.make_optimizer(),
                                cfg.scheduler, device="cpu")
    t, noise = jax_draws(key, setup["lat"].shape)
    loss = ts.loss(torch.from_numpy(setup["lat"]),
                   torch.from_numpy(setup["ctx"]), t=t, noise=noise)
    grads = ts.grads(loss)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    want = flat_port(jgrads)
    assert set(grads) == set(want) == set(dict(unet.named_parameters()))
    for name, g in grads.items():
        ref = want[name]
        np.testing.assert_allclose(
            _np(g), ref, rtol=0, atol=2e-4 * np.abs(ref).max() + 1e-6,
            err_msg=name)
        assert g.dtype == torch.float32
    assert all(p.grad is None for p in unet.parameters())


def test_loss_draws_from_the_generator_in_order():
    """t first, then the noise, from one generator; without one and
    without both draws injected the loss refuses."""
    cfg = tiny_config()
    unet = build_module(TUNet, cfg.unet, torch.float32, "cpu",
                        torch.Generator().manual_seed(0))
    sched = ttrain.sched_ops.make_schedule(cfg.scheduler, 1000)
    lat = torch.randn(2, SIDE, SIDE, 4, generator=torch.Generator()
                      .manual_seed(1))
    ctx = torch.randn(2, TEXT_LEN, 32)
    with torch.no_grad():
        got = ttrain.diffusion_loss(unet, sched, lat, ctx,
                                    torch.Generator().manual_seed(7))
        g = torch.Generator().manual_seed(7)
        t = torch.randint(0, 1000, (2,), generator=g)
        noise = torch.randn(lat.shape, generator=g)
        want = ttrain.diffusion_loss(unet, sched, lat, ctx, t=t, noise=noise)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="generator"):
        ttrain.diffusion_loss(unet, sched, lat, ctx, t=t)


# ---------------------------------------------------------------- the step


def _compare_params(port_params, jparams, names, lr, steps, frozen=()):
    """Parameters after ``steps`` steps: within 2·lr·steps everywhere (a
    first Adam step is ±lr wherever |g| >> eps, so a gradient that rounds
    to the other sign near zero moves a parameter 2·lr the other way) and
    within 1e-3·lr for 99.9 % of the elements; frozen leaves bit-equal on
    both sides."""
    jflat = flat_port(jparams)
    diffs = []
    for path, name in names.items():
        got, ref = _np(port_params[name]), jflat[name]
        if name in frozen:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        diffs.append(np.abs(got - ref).ravel())
    d = np.concatenate(diffs)
    assert d.max() <= 2 * lr * steps, d.max()
    assert np.quantile(d, 0.999) <= 1e-3 * lr, np.quantile(d, 0.999)


def test_train_step_matches_jax_over_three_steps(setup):
    """make_train_step over 3 steps (lr 1e-3, no warmup, the full UNet):
    each step's loss within 1e-4 relative (the parameters part by the
    rounding bound below), the parameters by _compare_params, the step
    and Adam counts 3."""
    unet, cfg = port_unet(setup["params"])
    lr = 1e-3
    jopt = jtrain.make_optimizer(lr=lr, warmup=0)
    jstep = jax_step(setup, jopt)
    jstate = jtrain.TrainState(setup["params"], jopt.init(setup["params"]),
                               jnp.int32(0))
    ts = ttrain.make_train_step(unet, ttrain.make_optimizer(lr=lr, warmup=0),
                                cfg.scheduler, device="cpu")
    state = ts.init_state()
    lat, ctx = torch.from_numpy(setup["lat"]), torch.from_numpy(setup["ctx"])
    for i in range(3):
        key = jax.random.key(100 + i)
        jstate, jloss = jstep(jstate, jnp.asarray(setup["lat"]),
                              jnp.asarray(setup["ctx"]), key)
        t, noise = jax_draws(key, setup["lat"].shape)
        state, loss = ts(state, lat, ctx, t=t, noise=noise)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-4), i
    assert state.step == int(jstate.step) == 3
    assert state.opt_state.count == 3
    _compare_params(state.params, jstate.params, setup["names"], lr, 3)
    # the module holds the state it returned
    for name, p in unet.named_parameters():
        assert torch.equal(p.detach(), state.params[name]), name


@pytest.mark.parametrize("which", ["attn2", "ip_recipe"])
def test_trainable_filter_freezes_the_same_leaves(setup, which):
    """The JAX test's "attn2" filter and the IP recipe's: the port freezes
    exactly the leaves JAX freezes (matched through from_flax's map, not
    by the strings), frozen leaves stay bit-equal on both sides,
    something moves, the trained ones agree (_compare_params, one step at
    lr 1e-2), and the port's optimizer holds moments only for the
    trainable parameters."""
    jfilter = attn2_filter if which == "attn2" else ip_filter
    unet, cfg = port_unet(setup["params"])
    lr = 1e-2
    jopt = jtrain.make_optimizer(lr=lr, warmup=0)
    jstate = jtrain.TrainState(setup["params"], jopt.init(setup["params"]),
                               jnp.int32(0))
    key = jax.random.key(3)
    new, _ = jax_step(setup, jopt, jfilter)(
        jstate, jnp.asarray(setup["lat"]), jnp.asarray(setup["ctx"]), key)
    jfrozen = {setup["names"][path] for path in setup["names"]
               if not jfilter(path)}
    ts = ttrain.make_train_step(unet, ttrain.make_optimizer(lr=lr, warmup=0),
                                cfg.scheduler, trainable_filter=jfilter,
                                device="cpu")
    assert set(ts.trainable) == set(setup["names"].values()) - jfrozen
    state = ts.init_state()
    before = {n: p.clone() for n, p in state.params.items()}
    assert set(state.opt_state.mu) == set(ts.trainable)
    t, noise = jax_draws(key, setup["lat"].shape)
    state, _ = ts(state, torch.from_numpy(setup["lat"]),
                  torch.from_numpy(setup["ctx"]), t=t, noise=noise)
    moved = {n for n in before if not torch.equal(before[n],
                                                  state.params[n])}
    assert moved and not moved & jfrozen
    assert moved == set(ts.trainable)
    jflat_before = flat_port(setup["params"])
    jflat = flat_port(new.params)
    assert {n for n in jflat if not np.array_equal(jflat[n],
                                                   jflat_before[n])} == moved
    _compare_params(state.params, new.params, setup["names"], lr, 1,
                    frozen=jfrozen)


def test_loss_decreases_on_a_fixed_batch():
    """tests/test_parallel.py:72-95 on one device: 5 steps (lr 1e-3, no
    warmup) on one batch with the same draws every step; the loss falls
    and stays finite."""
    cfg = tiny_config()
    unet = build_module(TUNet, cfg.unet, torch.float32, "cpu",
                        torch.Generator().manual_seed(2))
    ts = ttrain.make_train_step(unet, ttrain.make_optimizer(lr=1e-3,
                                                            warmup=0),
                                cfg.scheduler, device="cpu")
    g = torch.Generator().manual_seed(3)
    lat = 0.2 * torch.randn(8, SIDE, SIDE, 4, generator=g)
    ctx = torch.randn(8, TEXT_LEN, 32, generator=g)
    t = torch.randint(0, 1000, (8,), generator=g)
    noise = torch.randn(lat.shape, generator=g)
    state, losses = ts.init_state(), []
    for _ in range(5):
        state, loss = ts(state, lat, ctx, t=t, noise=noise)
        losses.append(float(loss))
    assert state.step == 5
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_ema_matches_jax():
    """ema_update against the JAX one on seeded trees (decay 0.9999 and
    0.5); bound 2 fp32 ulps of the values (the port multiplies and adds
    in place)."""
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 4), "b": (7,)}
    e = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    p = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    for decay in (0.9999, 0.5):
        want = jtrain.ema_update(e, p, decay)
        got = ttrain.ema_update({k: torch.from_numpy(v.copy())
                                 for k, v in e.items()},
                                {k: torch.from_numpy(v) for k, v in p.items()},
                                decay)
        for k in shapes:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                       rtol=2.4e-7, atol=0)


def test_a_quantized_unet_refuses_to_train(setup):
    """The JAX package's W8A8 tree has int8 leaves, which jax.grad
    refuses; the port's make_train_step refuses a quantized UNet (its
    quant_matmul raises under autograd on the card)."""
    qparams = JQ.quantize_params(setup["params"])
    jq = JUNet(dataclasses.replace(setup["junet"].cfg, quantized=True))
    sched = jsched.make_schedule(setup["jc"].scheduler, 1000)
    lat, ctx = jnp.asarray(setup["lat"]), jnp.asarray(setup["ctx"])
    with pytest.raises(TypeError):
        jax.grad(lambda p: jtrain.diffusion_loss(
            lambda q, x, t, c: jq.apply({"params": q}, x, t, c), p, sched,
            lat, ctx, jax.random.key(0)))(qparams)
    cfg = tiny_config()
    ucfg = dataclasses.replace(cfg.unet, quantized=True)
    unet = build_module(TUNet, ucfg, torch.float32, "cpu",
                        torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="W8A8"):
        ttrain.make_train_step(unet, ttrain.make_optimizer(), cfg.scheduler,
                               device="cpu")


def test_shard_train_step_refuses_a_mesh():
    """One device: the step comes back unchanged, on a one-rank mesh too;
    a mesh of several ranks refuses anything but a ``TrainStep`` (the
    sharded step itself: ``test_torch_port_mesh_run.py``)."""
    import types

    def step(*a):
        return a

    assert ttrain.shard_train_step(step, None) is step
    assert ttrain.shard_train_step(step) is step
    assert ttrain.shard_train_step(step, types.SimpleNamespace(
        world=1)) is step
    with pytest.raises(TypeError, match="TrainStep"):
        ttrain.shard_train_step(step, types.SimpleNamespace(world=2))


def test_the_trainer_needs_the_card_unless_asked():
    cfg = tiny_config()
    unet = build_module(TUNet, cfg.unet, torch.float32, "cpu",
                        torch.Generator().manual_seed(0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.make_train_step(unet, ttrain.make_optimizer(),
                                   cfg.scheduler)
    else:
        with pytest.raises(ValueError, match="on cpu"):
            ttrain.make_train_step(unet, ttrain.make_optimizer(),
                                   cfg.scheduler)
    ts = ttrain.make_train_step(unet, ttrain.make_optimizer(), cfg.scheduler,
                                device="cpu")
    assert ts.init_state().step == 0


def test_chip_smoke_train_launches_are_the_sites(monkeypatch):
    """chip_smoke.py's train_path holds each training step to one batch-4
    forward's launches (eval_launches(ucfg, 64, 4)): the kernel wrappers
    the step's forward and backward reach at full width on the meta
    device (the SD1.5 IP UNet at 512 px, every parameter trainable,
    GroupNorm switch "1") are those, and the TRAIN rows of FLASH_SHAPES
    and FF_SHAPES are their flash and FF sites, with their counts."""
    from theatergen_tpu_torch import config as tcfg
    from theatergen_tpu_torch.ops import attention as tat
    from theatergen_tpu_torch.ops import flash_attention as tfa
    from theatergen_tpu_torch.ops import geglu_matmul as tgg
    from theatergen_tpu_torch.ops import groupnorm as tgn
    from test_torch_port_knobs import _chip_smoke

    cs = _chip_smoke()
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    calls, shapes = {}, {}
    real = (tfa.flash_attention, tgg.ff_matmul, tgg.geglu_matmul,
            tgn.fused_group_norm)

    def count(name):
        calls[name] = calls.get(name, 0) + 1

    def flash(q, k, v, route=None):
        count(cs.FLASH_COUNTERS[tfa.COUNTERS[route]])
        key = ("flash", tuple(q.shape))
        shapes[key] = shapes.get(key, 0) + 1
        return real[0](q, k, v, route=route)

    def ff(x, w1, b1, w2):
        count("ff_geglu")
        key = ("ff", (x.numel() // x.shape[-1], x.shape[-1], w2.shape[1]))
        shapes[key] = shapes.get(key, 0) + 1
        return real[1](x, w1, b1, w2)

    def geglu(hg, w):
        count("geglu_matmul")
        return real[2](hg, w)

    def norm(x, *a, **k):
        count("group_norm")
        return real[3](x, *a, **k)

    real_cross = tat.cross_attention

    def cross(*a, **k):
        count("cross_attention")
        return real_cross(*a, **k)

    monkeypatch.setattr(tfa, "flash_attention", flash)
    monkeypatch.setattr(tgg, "ff_matmul", ff)
    monkeypatch.setattr(tgg, "geglu_matmul", geglu)
    monkeypatch.setattr(tgn, "fused_group_norm", norm)
    monkeypatch.setattr(tat, "cross_attention", cross)
    cfg = tcfg.sd15_config()
    ucfg = dataclasses.replace(cfg.unet,
                               ip_num_tokens=cfg.ip_adapter.num_tokens)
    side = cfg.pipeline.latent_height
    unet = build_module(TUNet, ucfg, torch.bfloat16, "meta")
    ts = ttrain.make_train_step(unet, ttrain.make_optimizer(),
                                cfg.scheduler, device="meta")
    with torch.device("meta"):
        lat = torch.empty(cs.TRAIN_BATCH, side, side, 4)
        ctx = torch.empty(cs.TRAIN_BATCH, 77 + 4, ucfg.cross_attention_dim)
        t = torch.zeros(cs.TRAIN_BATCH, dtype=torch.long)
        loss = ts.loss(lat, ctx, t=t, noise=torch.empty(lat.shape))
        grads = ts.grads(loss)
    assert set(grads) == set(ts.trainable) == {
        n for n, _ in unet.named_parameters()}
    assert cs.counts(**calls) == cs.counts(**cs.eval_launches(
        ucfg, side, cs.TRAIN_BATCH))
    assert calls["flash_attention"] == 10 and calls["ff_geglu"] == 16
    assert calls["group_norm"] == 61 and calls["cross_attention"] == 16
    want = {("flash", s): n for m, s, n in cs.FLASH_SHAPES if m == cs.TRAIN}
    want.update({("ff", s): n for m, s, n in cs.FF_SHAPES if m == cs.TRAIN})
    assert len(want) == 6 and shapes == want
