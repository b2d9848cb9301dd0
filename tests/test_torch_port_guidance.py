"""Latent guidance on the CPU: the port's energy, update, guided runners,
guided turn and CLI flag against the JAX package's.

Inputs are numpy draws from fixed seeds; weights cross over by
``from_flax`` (the tiny bundles of ``test_torch_port_turn.py``: text
tower, IP UNet, vision tower, ControlNet, VAE).  Both sides run fp32.
The kernels' autograd Functions (``ops/recompute.py``) are exercised here
with their launch swapped for the plain version, which is what a CUDA
tensor's launch computes; ``tests/test_torch_port_cuda.py`` holds the real
launches to the same gradients on the card.  Each test states its bound.
"""

import collections
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu.config import GuidanceConfig as JGuidanceConfig
from theatergen_tpu import theater as jth
from theatergen_tpu.ops import guidance as jgd
from theatergen_tpu.ops import latents as JL
from theatergen_tpu.ops import scheduler as jsched
from theatergen_tpu.pipelines import character as jchar
from theatergen_tpu.pipelines import final as jfinal
from theatergen_tpu.pipelines import guidance as jguid
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch import theater as tth
from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.ops import flash_attention as tfa
from theatergen_tpu_torch.ops import geglu_matmul as tgg
from theatergen_tpu_torch.ops import groupnorm as tgn
from theatergen_tpu_torch.ops import guidance as tgd
from theatergen_tpu_torch.ops import quant_matmul as tqm
from theatergen_tpu_torch.ops import recompute
from theatergen_tpu_torch.ops import scheduler as tsched
from theatergen_tpu_torch.pipelines import character as tchar
from theatergen_tpu_torch.pipelines import final as tfinal
from theatergen_tpu_torch.pipelines import guidance as tguid

import test_torch_port_turn as turn_tests

torch.set_num_threads(1)

CFG = turn_tests.CFG
GCFG = CFG.guidance
KEYS = GCFG.attn_keys
h = w = CFG.pipeline.latent_height
LATENT_HW = (h, w)
TEXT_LEN = CFG.text.max_length
JTheater, TTheater = jth.Theater, tth.Theater


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x)


@pytest.fixture(autouse=True)
def _jax_align_shifts_hw(monkeypatch):
    """The JAX alignment shifts (h, w), as the port's does (ROADMAP §3)."""
    monkeypatch.setattr(JL, "align_with_boxes",
                        turn_tests._align_hw(JL.align_with_boxes))


# ---------------------------------------------------------------------------
# the energy (ops/guidance.py)
# ---------------------------------------------------------------------------


def _maps(seed, heads=2, hw=64, t=10):
    """Softmax-normalised continuous maps [heads, HW, T] (no ties)."""
    x = np.random.RandomState(seed).randn(heads, hw, t).astype(np.float32)
    e = np.exp(x)
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _problem(k=3, p=4):
    """Three object slots (the last padding), a ragged token axis."""
    boxes = np.array([[0.1, 0.2, 0.6, 0.9], [0.4, 0.0, 1.0, 0.5],
                      [0.0, 0.0, 0.0, 0.0]], np.float32)[:k]
    pos = np.array([[1, 2, 3, 0], [5, 6, 0, 0], [0, 0, 0, 0]], np.int64)
    pv = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 0]], bool)
    ov = np.array([True, True, False])
    word = np.array([3, 6, 0], np.int64)
    return boxes, pos, pv, ov, word


def _jax_and_port_grad(jfn, tfn, *arrays):
    """(value, grads) of jfn by jax.value_and_grad and of tfn by
    torch.autograd over the same float arrays."""
    jv, jg = jax.value_and_grad(jfn, argnums=tuple(range(len(arrays))))(
        *(jnp.asarray(a) for a in arrays))
    leaves = [_t(a).requires_grad_(True) for a in arrays]
    tv = tfn(*leaves)
    tg = torch.autograd.grad(tv, leaves)
    return (np.asarray(jv), [np.asarray(g) for g in jg],
            _np(tv), [_np(g) for g in tg])


@pytest.mark.parametrize("k", [1, 3, 7, 200])
def test_topk_mean_matches_jax(k):
    """Mean of the k largest of seeded continuous rows (k clipped to [1,
    n], a float k truncated), values and gradients 1e-5 absolute."""
    x = np.random.RandomState(k).randn(4, 5, 64).astype(np.float32)
    kk = np.float32(k + 0.7)
    jv, (jg,), tv, (tg,) = _jax_and_port_grad(
        lambda a: jgd.topk_mean(a, jnp.asarray(kk)).sum(),
        lambda a: tgd.topk_mean(a, torch.tensor(kk)).sum(), x)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-5)
    ref = np.sort(x, -1)[..., ::-1][..., :min(k, 64)].mean(-1)
    np.testing.assert_allclose(
        _np(tgd.topk_mean(_t(x), torch.tensor(kk))), ref, rtol=1e-5)


@pytest.mark.parametrize("latent_hw", [None, (8, 16)])
def test_box_loss_matches_jax(latent_hw):
    """The box loss of one key over two objects and a padded slot, a
    ragged token axis, square and 1:2 maps: value and gradient with
    respect to the maps 1e-5 absolute."""
    boxes, pos, pv, ov, _ = _problem()
    hw = 128 if latent_hw else 64
    attn = _maps(1, hw=hw)
    kw = dict(fg_top_p=0.2, bg_top_p=0.3, fg_weight=1.0, bg_weight=4.0,
              latent_hw=latent_hw)
    jv, (jg,), tv, (tg,) = _jax_and_port_grad(
        lambda a: jgd.box_ca_loss_single_key(
            a, jnp.asarray(boxes), jnp.asarray(pos), jnp.asarray(pv),
            jnp.asarray(ov), **kw),
        lambda a: tgd.box_ca_loss_single_key(
            a, _t(boxes), _t(pos), _t(pv), _t(ov), **kw), attn)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    np.testing.assert_allclose(tg, jg, atol=1e-5)
    assert np.abs(tg).max() > 1e-3


def test_ref_transfer_loss_matches_jax():
    """The attention-transfer L1 of one key: value and gradients with
    respect to the maps and the reference maps 1e-5 absolute; zero for a
    reference equal to the current map."""
    boxes, _, _, ov, word = _problem()
    attn = _maps(2)
    ref = np.random.RandomState(3).rand(3, 2, 64).astype(np.float32)
    jv, jg, tv, tg = _jax_and_port_grad(
        lambda a, r: jgd.ref_ca_transfer_loss_single_key(
            a, r, jnp.asarray(boxes), jnp.asarray(word), jnp.asarray(ov)),
        lambda a, r: tgd.ref_ca_transfer_loss_single_key(
            a, r, _t(boxes), _t(word), _t(ov)), attn, ref)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-5)
    same = np.transpose(attn, (2, 0, 1))[word]
    assert float(tgd.ref_ca_transfer_loss_single_key(
        _t(attn), _t(same), _t(boxes), _t(word), _t(ov))) < 1e-5


@pytest.mark.parametrize("with_refs", [False, True])
def test_compute_ca_loss_matches_jax(with_refs):
    """The energy over three keys of two map sizes, normalised by objects
    × keys, with and without reference maps (weight 2): value and
    gradients with respect to every map 1e-5 absolute."""
    boxes, pos, pv, ov, word = _problem()
    maps = [_maps(4, hw=64), _maps(5, hw=16), _maps(6, hw=16)]
    refs = [np.random.RandomState(7 + i).rand(3, 2, m.shape[1]).astype(
        np.float32) for i, m in enumerate(maps)]
    kw = dict(fg_top_p=0.2, bg_top_p=0.2, fg_weight=1.0, bg_weight=4.0,
              ref_ca_loss_weight=2.0)

    def jfn(*ms):
        return jgd.compute_ca_loss(
            list(ms[:3]), jnp.asarray(boxes), jnp.asarray(pos),
            jnp.asarray(pv), jnp.asarray(ov),
            ref_attn_maps=list(ms[3:]) if with_refs else None,
            word_token=jnp.asarray(word), **kw)

    def tfn(*ms):
        return tgd.compute_ca_loss(
            list(ms[:3]), _t(boxes), _t(pos), _t(pv), _t(ov),
            ref_attn_maps=list(ms[3:]) if with_refs else None,
            word_token=_t(word), **kw)

    args = maps + (refs if with_refs else [])
    jv, jg, tv, tg = _jax_and_port_grad(jfn, tfn, *args)
    assert tv.dtype == np.float32 and tv.shape == ()
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, atol=1e-5)


# ---------------------------------------------------------------------------
# the step scale (ops/scheduler.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ddim", "euler_ancestral", "lcm"])
def test_guidance_step_scale_matches_jax(kind):
    """Every position's scale, DDIM sqrt(1-alpha), Euler-Ancestral sigma²,
    LCM sqrt(1-alpha): the host Sampler's and the device tables' equal to
    the JAX Sampler's bit for bit (fp32)."""
    steps = 6
    js = jsched.make_sampler(CFG.scheduler, steps, kind=kind)
    ts = tsched.make_sampler(tcfg.tiny_config().scheduler, steps, kind=kind)
    dev = ts.on("cpu")
    for i in range(steps):
        want = np.float32(js.guidance_step_scale(i))
        assert np.float32(ts.guidance_step_scale(i)) == want
        assert dev.guidance_step_scale(i).dtype == torch.float32
        assert np.float32(dev.guidance_step_scale(i).item()) == want
    if kind == "ddim":
        jd = jsched.make_schedule(CFG.scheduler, steps)
        td = tsched.make_schedule(tcfg.tiny_config().scheduler, steps)
        for i in range(steps):
            assert np.float32(tsched.guidance_step_scale(td, i)) == \
                np.float32(jsched.guidance_step_scale(jd, i))


# ---------------------------------------------------------------------------
# the energy through the tiny IP UNet, and one guidance update
# ---------------------------------------------------------------------------


def _gin_pair(boxes, token_pos, refs=None):
    """The JAX GuidanceInputs of the JAX Theater's padding and the port's
    of its own, for the same boxes, tokens and (numpy) reference maps."""
    jt = JTheater.__new__(JTheater)
    jt.cfg = CFG
    tt = TTheater.__new__(TTheater)
    tt.cfg, tt.bundle = tcfg.tiny_config(), turn_tests._bundles()[1]
    jr = tr = None
    if refs is not None:
        jr = [tuple(jnp.asarray(m) for m in r) for r in refs]
        tr = [tuple(_t(m) for m in r) for r in refs]
    return (jt._guidance_inputs(boxes, token_pos, jr),
            tt._guidance_inputs(boxes, token_pos, tr))


def _energies(ip_scale=0.4):
    """The JAX energy (the IP UNet's cond-only capture) and the port's
    (``unet_energy_fn``, the runners'), on the same weights."""
    jb, tb = turn_tests._bundles()

    def japply(lat, t, ctx):
        return jb.unet_ip.apply(
            {"params": jb.unet_ip_params}, lat,
            jnp.broadcast_to(t, (lat.shape[0],)), ctx,
            ip_scale=jnp.float32(ip_scale), capture_keys=KEYS,
            mutable=["attn"])[1]["attn"]

    return (jguid.make_energy_fn(japply, GCFG, TEXT_LEN, LATENT_HW),
            tguid.unet_energy_fn(tb.unet_ip, tcfg.tiny_config(),
                                 ip_scale=torch.tensor(ip_scale)))


def _ref_maps(steps, n_obj, seed=11):
    """Per object, per key, seeded [steps, heads, HW] reference maps of the
    tiny IP UNet's capture shapes."""
    _, tb = turn_tests._bundles()
    x = torch.zeros(1, 4, h, w)
    _, cap = tb.unet_ip(x, torch.tensor([1]), torch.zeros(1, 20, 32),
                        capture_keys=KEYS)
    rng = np.random.RandomState(seed)
    return [tuple(rng.rand(steps, *cap[tuple(k)].shape[1:3]).astype(
        np.float32) for k in KEYS) for _ in range(n_obj)]


def test_unet_energy_gradient_matches_jax():
    """The guidance energy of two objects through the tiny IP UNet
    (cond-only, capture at the guidance keys, step-aggregated reference
    maps): its value 1e-5 relative and its latent gradient within 1e-4 of
    max|grad| of jax.grad's."""
    rng = np.random.RandomState(12)
    lat = rng.randn(1, h, w, 4).astype(np.float32)
    ctx = rng.randn(1, 20, 32).astype(np.float32)
    refs = [tuple(m[0] for m in r) for r in _ref_maps(1, 2)]
    jgin, tgin = _gin_pair([(0.1, 0.2, 0.6, 0.9), (0.5, 0.0, 1.0, 0.6)],
                           [[2, 3], [5]], refs)
    je, te = _energies()
    jv, jg = jax.jit(jax.value_and_grad(lambda x: je(
        x, jnp.int32(801), jnp.asarray(ctx), jgin)))(jnp.asarray(lat))
    leaf = _t(lat).permute(0, 3, 1, 2).requires_grad_(True)
    tv = te(leaf, torch.tensor(801), _t(ctx), tgin)
    (tg,) = torch.autograd.grad(tv, leaf)
    tg = _np(tg.permute(0, 2, 3, 1))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(jg).max() > 0
    assert np.abs(tg - jg).max() <= 1e-4 * np.abs(jg).max()


def _count_energy(energy, counter):
    """The energy, counting its evaluations on the host (jax.debug
    callback inside the JAX while_loop)."""
    def counted(*a):
        jax.debug.callback(lambda: counter.append(1))
        return energy(*a)
    return counted


@pytest.mark.parametrize("case", ["per_step", "converged", "threshold"])
def test_guidance_update_matches_jax(case):
    """One guidance_update at step 2 of a 4-step DDIM schedule with
    per-step [S, K, heads, HW] reference maps, against the JAX one:
    latents within 1e-4 of max|latents| moved, loss 1e-5 relative, the
    same iteration count.  ``per_step``: the tiny config (max_iter 2 at
    step 2); ``converged``: a previous loss below the threshold (no
    iteration, latents unchanged); ``threshold``: max_iter 5 and a
    threshold between the first two iterations' losses, so the loop stops
    on it after two."""
    rng = np.random.RandomState(13)
    lat = rng.randn(1, h, w, 4).astype(np.float32)
    ctx = rng.randn(1, 20, 32).astype(np.float32)
    jgin, tgin = _gin_pair([(0.1, 0.2, 0.6, 0.9), (0.5, 0.0, 1.0, 0.6)],
                           [[2, 3], [5]], _ref_maps(4, 2))
    je, te = _energies()
    jsam = jsched.make_sampler(CFG.scheduler, 4)
    tsam = tsched.make_sampler(tcfg.tiny_config().scheduler, 4).on("cpu")
    gcfg, prev = GCFG, None
    if case == "converged":
        prev = 0.5 * GCFG.loss_threshold * GCFG.loss_scale
    if case == "threshold":
        # the losses of the first two iterations (the port's), and a
        # threshold between them: the loop runs two of its five
        gcfg = dataclasses.replace(GCFG, max_iter=(5,) * 4)
        losses = [float(tguid.guidance_update(
            te, tsam, dataclasses.replace(GCFG, max_iter=(n,) * 4),
            _t(lat).permute(0, 3, 1, 2), 2, _t(ctx), tgin)[1])
            for n in (1, 2)]
        assert losses[1] < losses[0]
        gcfg = dataclasses.replace(
            gcfg, loss_threshold=sum(losses) / 2 / GCFG.loss_scale)
    counter = []
    jlat, jloss = jax.jit(functools.partial(
        jguid.guidance_update, _count_energy(je, counter), jsam,
        JGuidanceConfig(**dataclasses.asdict(gcfg))))(
        jnp.asarray(lat), jnp.int32(2), jnp.asarray(ctx), jgin,
        None if prev is None else jnp.float32(prev))
    jax.effects_barrier()
    tlat, tloss, iters = tguid.guidance_update(
        te, tsam, gcfg, _t(lat).permute(0, 3, 1, 2), 2, _t(ctx), tgin,
        prev_loss=None if prev is None else torch.tensor(prev))
    assert iters == len(counter)
    assert iters == {"per_step": GCFG.max_iter[2], "converged": 0,
                     "threshold": 2}[case]
    tlat = _np(tlat.permute(0, 2, 3, 1))
    moved = np.abs(np.asarray(jlat) - lat).max()
    if case == "converged":
        np.testing.assert_array_equal(tlat, lat)
        assert moved == 0
    else:
        assert moved > 1e-3
        assert np.abs(tlat - np.asarray(jlat)).max() <= 1e-4 * moved
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), rtol=1e-5)


def test_guidance_update_selects_the_step_of_per_step_maps():
    """[S, K, heads, HW] reference maps are sliced at the step (clipped
    past S), giving the update of that step's [K, heads, HW] maps bit for
    bit and another than a neighbouring step's (the JAX package's
    tests/test_guidance.py::test_guidance_update_per_step_ref_slicing)."""
    sam = tsched.make_sampler(tcfg.tiny_config().scheduler, 4).on("cpu")
    S, K, heads, HW = 4, 1, 2, 16

    def energy(lat, t, ctx, gin):
        return gin.ref_attn_maps[0].sum() * (lat ** 2).sum() * 1e-3

    refs = torch.arange(S * K * heads * HW, dtype=torch.float32).reshape(
        S, K, heads, HW) / (S * K * heads * HW)
    base = tguid.GuidanceInputs(
        torch.zeros(K, 4), torch.zeros(K, 2, dtype=torch.long),
        torch.ones(K, 2, dtype=torch.bool), torch.ones(K, dtype=torch.bool),
        torch.zeros(K, dtype=torch.long))
    lat = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 4, 4)
                           .astype(np.float32))
    ctx = torch.zeros(1, 8, 16)
    for step in (0, 2, 3, 6):
        kw = dict(energy_fn=energy, sched=sam, gcfg=GCFG, latents=lat,
                  step_index=min(step, 3), cond_context=ctx)
        if step == 6:
            # a reference trajectory shorter than the schedule: the last
            kw["step_index"] = 3
            refs_in, sel = refs[:2], refs[1]
        else:
            refs_in, sel = refs, refs[step]
        a, _, _ = tguid.guidance_update(
            gin=dataclasses.replace(base, ref_attn_maps=(refs_in,)), **kw)
        b, _, _ = tguid.guidance_update(
            gin=dataclasses.replace(base, ref_attn_maps=(sel,)), **kw)
        assert torch.equal(a, b)
        c, _, _ = tguid.guidance_update(gin=dataclasses.replace(
            base, ref_attn_maps=(refs[(step + 1) % S],)), **kw)
        assert (a - c).abs().max() > 0


# ---------------------------------------------------------------------------
# the kernels' autograd Functions (ops/recompute.py)
# ---------------------------------------------------------------------------


def _function_cases():
    rng = np.random.RandomState(20)

    def r(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32))

    return {
        "flash_attention": (tfa, "_launch", tfa.FlashAttentionFn,
                            tfa.flash_attention_plain,
                            (r(1, 16, 2, 8), r(1, 16, 2, 8), r(1, 16, 2, 8)),
                            ("flat",), {}),
        "ff_matmul": (tgg, "_ff_launch", tgg.FFMatmulFn, tgg.ff_matmul_plain,
                      (r(2, 6, 8), r(32, 8), r(32), r(8, 16)), (), {}),
        "geglu_matmul": (tgg, "_geglu_launch", tgg.GegluMatmulFn,
                         tgg.geglu_matmul_plain, (r(2, 6, 32), r(8, 16)), (),
                         {}),
        "group_norm": (tgn, "_launch", tgn.FusedGroupNormFn,
                       tgn.fused_group_norm_plain,
                       (r(2, 8, 4, 4), r(8), r(8)), (4, 1e-5, "silu"),
                       dict(num_groups=4, eps=1e-5, act="silu"))}


@pytest.mark.parametrize("name", ["flash_attention", "ff_matmul",
                                  "geglu_matmul", "group_norm"])
def test_kernel_function_gradient_is_the_plain_version(name, monkeypatch):
    """Each kernel's Function, its launch swapped for the plain version
    (the function a CUDA launch computes): one launch in the forward, none
    in the backward, and input gradients equal to the plain version's
    autograd gradients bit for bit, first for every input, then for the
    activation alone (None for the others)."""
    mod, attr, fn, plain, inputs, extra, kw = _function_cases()[name]
    launches = []

    def launch(*a):
        launches.append(1)
        return plain(*a[:len(inputs)], **kw)

    monkeypatch.setattr(mod, attr, launch)
    for needs in ([True] * len(inputs), [True] + [False] * (len(inputs) - 1)):
        leaves = [x.clone().requires_grad_(n) for x, n in zip(inputs, needs)]
        launches.clear()
        out = fn.apply(*leaves, *extra)
        assert len(launches) == 1 and out.grad_fn is not None
        g = torch.from_numpy(np.random.RandomState(21).randn(
            *out.shape).astype(np.float32))
        want = [x for x, n in zip(leaves, needs) if n]
        got = torch.autograd.grad(out, want, g)
        assert len(launches) == 1
        ref_leaves = [x.clone().requires_grad_(n)
                      for x, n in zip(inputs, needs)]
        ref = torch.autograd.grad(
            plain(*ref_leaves, **kw), [x for x, n in zip(ref_leaves, needs)
                                       if n], g)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_plain_vjp_and_needs_grad():
    """needs_grad: grad mode on and an input requiring grad; plain_vjp
    returns None where no gradient is asked and leaves no graph on the
    inputs."""
    x = torch.randn(3, requires_grad=True)
    y = torch.randn(3)
    assert recompute.needs_grad(x, None, y)
    assert not recompute.needs_grad(y, None)
    with torch.no_grad():
        assert not recompute.needs_grad(x)
    g = torch.ones(3)
    gx, gy = recompute.plain_vjp(lambda a, b: a * b, (x, y), (True, False), g)
    assert torch.equal(gx, y) and gy is None and not gx.requires_grad
    assert recompute.plain_vjp(lambda a: a, (y,), (False,), g) == (None,)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: reaches a wrapper's CUDA
    branch up to its first launch."""

    @property
    def is_cuda(self):
        return True


def test_quant_matmul_refuses_a_gradient():
    """quant_matmul has no gradient (the JAX W8A8 path has none): on CUDA
    inputs that need one it raises before any launch, under no_grad it
    does not refuse, and on the CPU its plain version runs."""
    x = torch.randn(2, 32)
    w_q = torch.randint(-127, 128, (16, 32), dtype=torch.int8)
    scale = torch.rand(16) + 0.5
    fake = torch.Tensor._make_subclass(_FakeCuda, x.to(torch.bfloat16),
                                       True)
    with pytest.raises(RuntimeError, match="no gradient"):
        tqm.quant_matmul(fake, w_q, scale)
    with torch.no_grad(), pytest.raises(Exception) as info:
        tqm.quant_matmul(fake, w_q, scale)
    assert "no gradient" not in str(info.value)
    out = tqm.quant_matmul(x, w_q, scale)
    assert out.shape == (2, 16)


# ---------------------------------------------------------------------------
# the guided runners
# ---------------------------------------------------------------------------


def _char_inputs(seed=30):
    rng = np.random.RandomState(seed)
    return (rng.randn(1, h, w, 4).astype(np.float32),
            rng.randn(2, 20, 32).astype(np.float32))


@pytest.mark.parametrize("kw", [{}, dict(deepcache_interval=2)])
def test_guided_character_pass_matches_jax(kw):
    """make_character_pipeline(guided=True, capture_ref_attn=True), 3 DDIM
    steps at CFG 7.5, ip_scale 0.4, a layout box and two phrase tokens,
    against the JAX runner (tests/test_character_final.py's guided run):
    trajectory within 1e-5 of max|trajectory| (CFG and the descent
    amplify each evaluation's fp32 difference), reference maps 1e-5; the
    guided latents differ from the unguided run's.  With DeepCache every
    2nd step the energy still runs the full UNet."""
    jb, tb = turn_tests._bundles()
    lat, ctx = _char_inputs()
    jgin, tgin = _gin_pair([(0.1, 0.1, 0.6, 0.9)], [[2, 3]])
    jrun, _ = jchar.make_character_pipeline(
        jb, 3, use_ip=True, guided=True, capture_ref_attn=True, **kw)
    jr = jrun(jb.unet_ip_params, jnp.asarray(lat), jnp.asarray(ctx),
              jnp.float32(0.4), jgin)
    trun, _ = tchar.make_character_pipeline(
        tb, 3, use_ip=True, guided=True, capture_ref_attn=True, **kw)
    tr = trun(_t(lat), _t(ctx), 0.4, 3, gin=tgin)
    jt = np.asarray(jr.trajectory)
    np.testing.assert_allclose(_np(tr.trajectory), jt,
                               atol=1e-5 * np.abs(jt).max())
    for a, b in zip(tr.ref_attn, jr.ref_attn):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5)
    urun, _ = tchar.make_character_pipeline(tb, 3, use_ip=True,
                                            capture_ref_attn=True, **kw)
    ur = urun(_t(lat), _t(ctx), 0.4, 3)
    assert float((ur.latents - tr.latents).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="gin"):
        trun(_t(lat), _t(ctx), 0.4, 3)


def test_guided_final_pass_matches_jax():
    """make_final_pipeline(guided=True), 3 DDIM steps, 1 frozen step,
    ControlNet, ip_scale 0.1, the overall guidance of two objects with
    per-step reference maps, against the JAX runner: final latents and
    trajectory within 1e-5 of max|trajectory| (the trajectory holds each
    step's guided latents, as the JAX runner's does); guided differs from
    unguided."""
    jb, tb = turn_tests._bundles()
    rng = np.random.RandomState(31)
    la = rng.randn(4, 1, h, w, 4).astype(np.float32)
    fm = np.zeros((h, w), np.float32)
    fm[2:6, 1:5] = 1.0
    ctx = rng.randn(2, 20, 32).astype(np.float32)
    cn_ctx = rng.randn(2, 16, 32).astype(np.float32)
    cond = rng.rand(CFG.pipeline.height, CFG.pipeline.width, 3).astype(
        np.float32)
    jgin, tgin = _gin_pair([(0.1, 0.2, 0.6, 0.9), (0.5, 0.0, 1.0, 0.6)],
                           [[2, 3], [5]], _ref_maps(3, 2))
    jrun, _ = jfinal.make_final_pipeline(jb, 3, guided=True)
    fj, trj = jrun(jb.unet_ip_params, jb.controlnet_params, jnp.asarray(la),
                   jnp.asarray(fm), jnp.int32(1), jnp.asarray(ctx),
                   jnp.asarray(cn_ctx), jnp.asarray(cond), jnp.float32(0.1),
                   jgin)
    trun, _ = tfinal.make_final_pipeline(tb, 3, guided=True)
    args = (_t(la), _t(fm), 1, _t(ctx), _t(cn_ctx), _t(cond), 0.1)
    ft, trt = trun(*args, gin=tgin)
    bound = 1e-5 * np.abs(np.asarray(trj)).max()
    np.testing.assert_allclose(_np(trt), np.asarray(trj), atol=bound)
    np.testing.assert_allclose(_np(ft), np.asarray(fj), atol=bound)
    urun, _ = tfinal.make_final_pipeline(tb, 3)
    fu, _ = urun(*args)
    assert float((fu - ft).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the guided turn and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["per_step", "aggregate"])
def test_guided_run_turn_matches_jax(tmp_path, monkeypatch, mode):
    """Turn 1 of dialogue_0 (two DB misses) through Theater(guided=True,
    attn_transfer=mode), 4 DDIM steps, frozen_step_ratio 0 (with frozen
    steps the tiny masks' replacement overwrites the guided latents, which
    would hide the reference maps), against the JAX Theater with the same
    injected noise (tests/test_theater.py's guided turn): images, masks,
    DB entries and phase counts as in test_torch_port_turn.py's turn
    parity, images within its IMG_TOL (1e-4; 3.6e-6 measured).  The port's
    turn under the other mode gives another image."""
    images = {}
    for m in (mode, "aggregate" if mode == "per_step" else "per_step"):
        monkeypatch.setattr(jth, "Theater", functools.partial(
            JTheater, guided=True, attn_transfer=m))
        monkeypatch.setattr(tth, "Theater", functools.partial(
            TTheater, guided=True, attn_transfer=m))
        jt, tt, rec, noise = turn_tests._theaters(tmp_path / m, monkeypatch)
        assert tt.guided and tt.attn_transfer == m
        spec = turn_tests._specs()[0]
        seed = tgen.turn_seed(0, 0, 0, 0)
        tr = tt.run_turn(spec, seed, frozen_step_ratio=0.0)
        images[m] = tr.image
        if m == mode:
            jr = jt.run_turn(spec, seed, frozen_step_ratio=0.0)
            turn_tests._compare(jr, tr, rec, noise, jt, tt, 2)
    assert np.abs(images["per_step"] - images["aggregate"]).max() > 1e-4


def test_guided_background_only_turn_matches_jax(tmp_path, monkeypatch):
    """A turn without characters under guidance: the whole canvas as the
    box, token 1 of the overall prompt, against the JAX Theater (image
    within IMG_TOL, as the guided turn); the unguided port turn on the
    same noise gives another image."""
    spec = dict(turn_tests._specs()[2], gen_boxes=[], obj_ids=[])
    images = []
    for guided in (True, False):
        monkeypatch.setattr(jth, "Theater", functools.partial(
            JTheater, guided=guided))
        monkeypatch.setattr(tth, "Theater", functools.partial(
            TTheater, guided=guided))
        jt, tt, rec, noise = turn_tests._theaters(tmp_path / str(guided),
                                                  monkeypatch)
        tr = tt.run_turn(spec, 5)
        images.append(tr.image)
        if guided:
            jr = jt.run_turn(spec, 5)
            turn_tests._compare(jr, tr, rec, noise, jt, tt, 0)
    assert np.abs(images[0] - images[1]).max() > 1e-4


def test_theater_attn_transfer_checked():
    _, tb = turn_tests._bundles()
    with pytest.raises(ValueError, match="attn_transfer"):
        TTheater(tb, None, attn_transfer="mean")


@pytest.mark.parametrize("flags,guided", [
    (["--guidance"], True), (["--guidance", "--no_guidance"], False),
    ([], False)])
def test_cli_guidance_flag(tmp_path, monkeypatch, flags, guided):
    """--guidance builds guided Theaters unless --no_guidance is given (the
    JAX CLI's reading); the guided dialogue runs all four turns into the
    tree with finite images."""
    seen = []
    real = TTheater.__init__

    def init(self, *a, **kw):
        seen.append(kw.get("guided", False))
        real(self, *a, **kw)

    monkeypatch.setattr(TTheater, "__init__", init)
    assert "guidance" not in tgen.UNPORTED_FLAGS
    tgen.main(turn_tests._cli(tmp_path, *flags))
    assert seen == [guided]
    events = turn_tests._log(tmp_path)
    assert [e["turn"] for e in events if e["event"] == "turn"] == [
        f"turn {i}" for i in range(1, 5)]
    assert not any(e["event"] == "quarantine" for e in events)
    run = tmp_path / "out" / "story" / "run0" / "dialogue_0"
    assert os.path.exists(run / "turn 4" / "img_0.png")


def test_chip_smoke_guided_iteration_launches_are_the_sites(monkeypatch):
    """chip_smoke.py derives a guided request's launches as one cond-only
    IP UNet evaluation per guidance iteration (guided_iter_want): the
    kernel wrappers the energy's forward and its gradient reach at full
    size on the meta device (SD1.5 IP UNet at 512 px, the XL IP UNet at
    1024 px; GroupNorm switch "1") are those, and GRAD_SHAPES, the
    gradient gates' shapes, are among the SD1.5 energy's sites."""
    from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
    from test_torch_port_knobs import _chip_smoke

    cs = _chip_smoke()
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    calls, shapes = collections.Counter(), set()
    real = (tfa.flash_attention, tgg.ff_matmul, tgg.geglu_matmul,
            tgn.fused_group_norm)

    def flash(q, k, v, route=None):
        calls[cs.FLASH_COUNTERS[tfa.COUNTERS[route]]] += 1
        shapes.add(("flash_attention", tuple(q.shape)))
        return real[0](q, k, v, route=route)

    def ff(x, w1, b1, w2):
        calls["ff_geglu"] += 1
        shapes.add(("ff_geglu", (x.numel() // x.shape[-1], x.shape[-1],
                                 w2.shape[1])))
        return real[1](x, w1, b1, w2)

    def geglu(hg, w):
        calls["geglu_matmul"] += 1
        return real[2](hg, w)

    def norm(x, *a, act=None, **k):
        calls["group_norm"] += 1
        shapes.add(("group_norm", (x.shape[0], x.shape[1],
                                   x.shape[2] * x.shape[3], act)))
        return real[3](x, *a, act=act, **k)

    monkeypatch.setattr(tfa, "flash_attention", flash)
    monkeypatch.setattr(tgg, "ff_matmul", ff)
    monkeypatch.setattr(tgg, "geglu_matmul", geglu)
    monkeypatch.setattr(tgn, "fused_group_norm", norm)
    for model, cfg in ((cs.CHAR, tcfg.sd15_config()),
                       (cs.XL_CHAR, tcfg.sdxl_config())):
        ucfg, side, _ = cs.path_cfg(model)
        with torch.device("meta"):
            unet = TUNet(ucfg).to(torch.bfloat16)
            lat = torch.empty(1, 4, side, side, requires_grad=True)
            ctx = torch.empty(1, 77 + 4, ucfg.cross_attention_dim)
            extra = {} if model == cs.CHAR else dict(
                pooled_text=torch.empty(1, 1280), time_ids=torch.empty(1, 6))
            gin = cs.guided_inputs(2, cfg, device="meta")
        energy = tguid.unet_energy_fn(unet, cfg, ip_scale=0.4, **extra)
        calls.clear()
        shapes.clear()
        with torch.device("meta"):
            e = energy(lat, torch.tensor(801), ctx, gin)
            (g,) = torch.autograd.grad(e, lat)
        assert g.shape == lat.shape and g.dtype == torch.float32
        assert cs.counts(**calls) == cs.guided_iter_want(model), model
        if model == cs.CHAR:
            assert {(n, tuple(s)) for n, m, s in cs.GRAD_SHAPES
                    if m == cs.SD15_B1} <= shapes


def test_guidance_modules_are_under_the_port_rules():
    """The modules this slice adds are among those
    test_torch_port_rules.py imports without JAX."""
    from test_torch_port_rules import _modules

    mods = _modules()
    for m in ("ops.guidance", "ops.recompute", "pipelines.guidance"):
        assert f"theatergen_tpu_torch.{m}" in mods
