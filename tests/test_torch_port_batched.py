"""The port's batched runners on the CPU: a turn's characters and a wave's
final passes as one batch, against the JAX package's
``parallel/driver.py`` runners (the ``vmap`` of its batch-1 runners, on a
one-device CPU mesh) and against the port's own batch-1 runners element by
element.

Weights are the tiny bundles of ``test_torch_port_turn.py`` (fp32), inputs
numpy draws from fixed seeds; where a sampler draws each step, the JAX
runner's per-element key is turned into the port's injected noise
(``jax_noise``), and against the port's batch-1 runner each element's
generator is seeded alike.  Covered: the per-row IP scale (a DB hit at 0.4
beside a miss at 0.0), per-row noise streams, the batched character runner
(DDIM with a CFG cutoff and DeepCache, Euler-Ancestral), the guided batch
whose elements stop after different iteration counts, the batched final
runner with per-element frozen steps, and batched detection and masks.
Each test states its bound.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import theater as jth
from theatergen_tpu.config import GuidanceConfig as JGuidanceConfig
from theatergen_tpu.ops import scheduler as jsched
from theatergen_tpu.parallel import driver as jdriver
from theatergen_tpu.parallel import mesh as jmesh
from theatergen_tpu.perception import detector as jdet
from theatergen_tpu.pipelines import guidance as jguid
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch import theater as tth
from theatergen_tpu_torch.ops import attention as tattn
from theatergen_tpu_torch.ops import scheduler as tsched
from theatergen_tpu_torch.parallel import driver as tdriver
from theatergen_tpu_torch.perception import detector as tdet
from theatergen_tpu_torch.pipelines import character as tchar
from theatergen_tpu_torch.pipelines import final as tfinal
from theatergen_tpu_torch.pipelines import guidance as tguid
from theatergen_tpu_torch.pipelines import sd as tsd

import test_torch_port_guidance as guid_tests
import test_torch_port_turn as turn_tests
from test_torch_port_samplers import _close, jax_noise

torch.set_num_threads(1)

CFG = turn_tests.CFG
PL = CFG.pipeline
h = w = PL.latent_height
K = PL.max_objects
STEPS = 3
# a runner's trajectory, fp32: the batch changes only the summation order
# of the UNet's reductions, which CFG 7.5 amplifies step by step
# (bound·max(|ref|, 1); EA's latents start at sigma_0 ~ 15)
TRAJ_TOL = 1e-4
# the reference maps: softmax probabilities in [0, 1]
MAP_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().float().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _bundles(kind: str = "ddim"):
    """The JAX and port tiny bundles under the sampler ``kind``."""
    jb, tb = turn_tests._bundles()
    if kind == PL.scheduler_type:
        return jb, tb
    return tuple(dataclasses.replace(b, cfg=dataclasses.replace(
        b.cfg, pipeline=dataclasses.replace(b.cfg.pipeline,
                                            scheduler_type=kind)))
        for b in (jb, tb))


@functools.lru_cache(maxsize=None)
def _mesh():
    return jmesh.make_mesh(dp=1, tp=1, devices=jax.devices()[:1])


def _jax_gins(words, boxes=None):
    """Batched JAX GuidanceInputs: per element one box and its word token
    (the JAX character runner captures at ``word_token[0]``)."""
    b = len(words)
    bx = np.zeros((b, K, 4), np.float32)
    pos = np.zeros((b, K, 8), np.int32)
    valid = np.zeros((b, K, 8), bool)
    ov = np.zeros((b, K), bool)
    wt = np.zeros((b, K), np.int32)
    for i, word in enumerate(words):
        bx[i, 0] = (0.1, 0.1, 0.6, 0.9) if boxes is None else boxes[i]
        pos[i, 0, :2] = (word - 1, word)
        valid[i, 0, :2] = True
        ov[i, 0] = True
        wt[i, 0] = word
    return jguid.GuidanceInputs(jnp.asarray(bx), jnp.asarray(pos),
                                jnp.asarray(valid), jnp.asarray(ov),
                                jnp.asarray(wt))


def _port_gins(jgins):
    """The port's GuidanceInputs of the same arrays."""
    return tguid.GuidanceInputs(
        _t(np.asarray(jgins.boxes)),
        _t(np.asarray(jgins.token_pos)).long(),
        _t(np.asarray(jgins.token_valid)),
        _t(np.asarray(jgins.obj_valid)),
        _t(np.asarray(jgins.word_token)).long())


def _stacked_noise(keys, shape):
    """Each JAX element key's per-step draws, ``[S, B, h, w, 4]``."""
    return np.concatenate([jax_noise(k, STEPS, shape) for k in keys], 1)


# ---------------------------------------------------------------------------
# module 1: one IP scale per row
# ---------------------------------------------------------------------------


def test_decoupled_attention_takes_a_scale_per_row():
    """A ``[B]`` scale weights each row's IP branch alone: rows 0.4, 0.0 and
    0.4 equal three calls at their own 0-dim scale, bit for bit, and not
    one call at 0.4 (the silent fault a broadcast bug would give)."""
    rng = np.random.RandomState(0)
    q, kt, vt = (_t(rng.randn(3, 16, 2, 8).astype(np.float32))
                 for _ in range(3))
    ki, vi = (_t(rng.randn(3, 4, 2, 8).astype(np.float32)) for _ in range(2))
    scales = [0.4, 0.0, 0.4]
    got = tattn.decoupled_attention(q, kt, vt, ki, vi, torch.tensor(scales))
    for i, s in enumerate(scales):
        one = tattn.decoupled_attention(q[i:i + 1], kt[i:i + 1], vt[i:i + 1],
                                        ki[i:i + 1], vi[i:i + 1],
                                        torch.tensor(s))
        torch.testing.assert_close(got[i:i + 1], one, rtol=0, atol=0)
    same = tattn.decoupled_attention(q, kt, vt, ki, vi, torch.tensor(0.4))
    assert float((same[1] - got[1]).abs().max()) > 1e-3


def test_ip_unet_mixes_a_hit_and_a_miss():
    """The tiny IP UNet at batch 2 with ip_scale [0.4, 0.0]: each row's eps
    within 1e-5 of max|eps| of a batch-1 evaluation at its own scale; the
    miss row differs from the same row at 0.4."""
    _, tb = _bundles()
    rng = np.random.RandomState(1)
    x = _t(rng.randn(2, 4, h, w).astype(np.float32))
    ctx = _t(rng.randn(2, 20, 32).astype(np.float32))
    t = torch.tensor([501, 501])
    with torch.no_grad():
        got = tb.unet_ip(x, t, ctx, ip_scale=torch.tensor([0.4, 0.0]))
        for i, s in enumerate((0.4, 0.0)):
            one = tb.unet_ip(x[i:i + 1], t[:1], ctx[i:i + 1],
                             ip_scale=torch.tensor(s))
            bound = 1e-5 * float(one.abs().max())
            assert float((got[i:i + 1] - one).abs().max()) <= bound
        hit = tb.unet_ip(x[1:], t[:1], ctx[1:], ip_scale=torch.tensor(0.4))
    assert float((hit - got[1:]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# module 2: one noise stream per row
# ---------------------------------------------------------------------------


def test_step_noise_draws_each_row_from_its_stream():
    """A generator list draws row by row what each generator draws alone,
    bit for bit; a list of the wrong length raises."""
    gens = [torch.Generator().manual_seed(s) for s in (3, 4, 5)]
    got = tsd.step_noise(0, (3, h, w, 4), "cpu", gens)
    for i, s in enumerate((3, 4, 5)):
        one = tsd.step_noise(0, (1, h, w, 4), "cpu",
                             torch.Generator().manual_seed(s))
        torch.testing.assert_close(got[i:i + 1], one, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generators"):
        tsd.step_noise(0, (2, h, w, 4), "cpu", gens)


# ---------------------------------------------------------------------------
# module 3 and 6: the batched character runner
# ---------------------------------------------------------------------------

CHAR_CASES = [("ddim", dict(cfg_cutoff_fraction=0.5, deepcache_interval=2)),
              ("euler_ancestral", {})]
WORDS, SCALES = [3, 5, 2], [0.4, 0.0, 0.4]


def _char_batch(seed, sigma):
    rng = np.random.RandomState(seed)
    lat = (rng.randn(3, h, w, 4) * sigma).astype(np.float32)
    ctx = rng.randn(3, 2, 20, 32).astype(np.float32)
    return lat, ctx


@pytest.mark.parametrize("kind,kw", CHAR_CASES)
def test_batched_character_runner_matches_jax_and_batch_1(kind, kw):
    """Three characters (ip_scale 0.4, 0.0, 0.4; word tokens 3, 5, 2) as
    one batch through ``driver.make_dp_character_runner``: trajectory and
    final latents within TRAJ_TOL·max(|ref|, 1) and every step's
    reference maps within MAP_TOL of the JAX runner on a 1-device mesh
    (its per-element keys' draws injected under Euler-Ancestral), and of
    the port's batch-1 runner element by element (Euler-Ancestral: the
    batch's generators seeded as the batch-1 runs' are)."""
    jb, tb = _bundles(kind)
    jrun, jsam = jdriver.make_dp_character_runner(
        jb, STEPS, _mesh(), use_ip=True, capture_ref_attn=True, **kw)
    trun, tsam = tdriver.make_dp_character_runner(
        tb, STEPS, use_ip=True, capture_ref_attn=True, **kw)
    lat, ctx = _char_batch(40, float(tsam.init_noise_sigma))
    keys = jax.random.split(jax.random.key(7), 3)
    jr = jrun(jb.unet_ip_params, jnp.asarray(lat[:, None]),
              jnp.asarray(ctx), jnp.asarray(SCALES, jnp.float32),
              _jax_gins(WORDS), keys)
    noise = (_t(_stacked_noise(keys, (1, h, w, 4))) if tsam.needs_noise
             else None)
    tr = trun(_t(lat[:, None]), _t(ctx), SCALES, None,
              word_tokens=WORDS, noise=noise)
    assert tuple(tr.trajectory.shape) == (3, STEPS + 1, 1, h, w, 4)
    _close(_np(tr.trajectory), jr.trajectory, TRAJ_TOL, "trajectory")
    _close(_np(tr.latents), jr.latents, TRAJ_TOL, "final")
    for mt, mj in zip(tr.ref_attn, jr.ref_attn):
        assert mt.shape[:2] == (3, STEPS)
        _close(_np(mt), mj, MAP_TOL, "ref maps")

    one, _ = tchar.make_character_pipeline(tb, STEPS, use_ip=True,
                                           capture_ref_attn=True, **kw)
    gens = ([torch.Generator().manual_seed(20 + i) for i in range(3)]
            if tsam.needs_noise else None)
    bt = tdriver.make_dp_character_runner(
        tb, STEPS, use_ip=True, capture_ref_attn=True, **kw)[0](
        _t(lat[:, None]), _t(ctx), SCALES, None, gens, word_tokens=WORDS)
    for i in range(3):
        gen = torch.Generator().manual_seed(20 + i) if gens else None
        r1 = one(_t(lat[i:i + 1]), _t(ctx[i]), SCALES[i], WORDS[i], gen)
        _close(_np(bt.trajectory[i]), _np(r1.trajectory), TRAJ_TOL,
               f"batch-1 trajectory {i}")
        for mb, m1 in zip(bt.ref_attn, r1.ref_attn):
            _close(_np(mb[i]), _np(m1), MAP_TOL, f"batch-1 maps {i}")


def test_batched_character_runner_reads_word_tokens_from_gins():
    """Without word tokens the driver's runner captures at
    ``gins.word_token[:, 0]``, as the JAX runner does.  On a one-rank mesh
    the runner computes the same, bit for bit; a mesh refuses a
    ``torch.Generator`` (a stream is sent as ``NoiseStream``)."""
    _, tb = _bundles()
    run, sam = tdriver.make_dp_character_runner(tb, 2, capture_ref_attn=True)
    lat, ctx = _char_batch(41, 1.0)
    a = run(_t(lat[:, None]), _t(ctx), SCALES, _port_gins(_jax_gins(WORDS)))
    b = run(_t(lat[:, None]), _t(ctx), SCALES, None, word_tokens=WORDS)
    for ma, mb in zip(a.ref_attn, b.ref_attn):
        torch.testing.assert_close(ma, mb, rtol=0, atol=0)
    from theatergen_tpu_torch.parallel import mesh as tmesh

    one = tmesh.make_mesh(1, 1, device="cpu")
    mrun, _ = tdriver.make_dp_character_runner(tb, 2, one,
                                               capture_ref_attn=True)
    c = mrun(_t(lat[:, None]), _t(ctx), SCALES, None, word_tokens=WORDS)
    torch.testing.assert_close(c.trajectory, b.trajectory, rtol=0, atol=0)
    for mc, mb in zip(c.ref_attn, b.ref_attn):
        torch.testing.assert_close(mc, mb, rtol=0, atol=0)
    with pytest.raises(TypeError, match="NoiseStream"):
        mrun(_t(lat[:, None]), _t(ctx), SCALES, None,
             [torch.Generator()] * 3, word_tokens=WORDS)


# ---------------------------------------------------------------------------
# module 4: the guided batch
# ---------------------------------------------------------------------------


def test_guided_batch_stops_each_element_on_its_own():
    """guidance_update over two problems at once (step 2 of 4 DDIM steps,
    max_iter 4, the threshold between the two elements' first losses):
    the element below it stops after one iteration while the other goes
    on, each
    element's latents within 1e-4 of what it moved and its loss 1e-5
    relative of the port's batch-1 update and of the JAX package's vmap
    of its while_loop; the counts are the batch-1 runs'."""
    _, tb = _bundles()
    rng = np.random.RandomState(14)
    lat = rng.randn(2, h, w, 4).astype(np.float32)
    ctx = rng.randn(2, 1, 20, 32).astype(np.float32)
    boxes = [(0.1, 0.2, 0.6, 0.9), (0.5, 0.0, 1.0, 0.6)]
    jg = _jax_gins([3, 5], boxes)
    tg = _port_gins(jg)
    tsam = tsched.make_sampler(tcfg.tiny_config().scheduler, 4).on("cpu")
    te1 = tguid.unet_energy_fn(tb.unet_ip, tcfg.tiny_config(),
                               ip_scale=torch.tensor(0.4))
    teb = tguid.unet_energy_fn(tb.unet_ip, tcfg.tiny_config(),
                               ip_scale=torch.tensor([0.4, 0.4]))
    x = _t(lat).permute(0, 3, 1, 2)

    def one(i, gcfg):
        return tguid.guidance_update(te1, tsam, gcfg, x[i:i + 1], 2,
                                     _t(ctx[i]), tg.element(i))

    first = [float(one(i, dataclasses.replace(
        guid_tests.GCFG, max_iter=(1,) * 4))[1]) for i in range(2)]
    lo = int(np.argmin(first))
    gcfg = dataclasses.replace(
        guid_tests.GCFG, max_iter=(4,) * 4,
        loss_threshold=sum(first) / 2 / guid_tests.GCFG.loss_scale)
    blat, bloss, its = tguid.guidance_update(teb, tsam, gcfg, x, 2,
                                             _t(ctx[:, 0]), tg)
    assert its[lo] == 1 and its[1 - lo] > 1
    je, _ = guid_tests._energies()
    jsam = jsched.make_sampler(CFG.scheduler, 4)
    jlat, jloss = jax.jit(jax.vmap(functools.partial(
        jguid.guidance_update, je, jsam,
        JGuidanceConfig(**dataclasses.asdict(gcfg))),
        in_axes=(0, None, 0, 0)))(
        jnp.asarray(lat[:, None]), jnp.int32(2), jnp.asarray(ctx), jg)
    for i in range(2):
        ol, oloss, oit = one(i, gcfg)
        assert oit == its[i]
        got = _np(blat[i].permute(1, 2, 0))
        moved = np.abs(np.asarray(jlat[i, 0]) - lat[i]).max()
        assert moved > 1e-3
        assert np.abs(got - np.asarray(jlat[i, 0])).max() <= 1e-4 * moved
        assert np.abs(got - _np(ol[0].permute(1, 2, 0))).max() <= 1e-4 * moved
        np.testing.assert_allclose(_np(bloss[i]), np.asarray(jloss[i]),
                                   rtol=1e-5)
        np.testing.assert_allclose(_np(bloss[i]), _np(oloss), rtol=1e-5)


def test_guided_batched_character_runner_matches_jax():
    """The guided character runner at batch 2 (ip_scale 0.4 and 0.0, a box
    and two tokens each, 3 DDIM steps) against the JAX guided runner on a
    1-device mesh: trajectory within 1e-5·max|trajectory|, reference maps
    MAP_TOL."""
    jb, tb = _bundles()
    jrun, _ = jdriver.make_dp_character_runner(
        jb, STEPS, _mesh(), use_ip=True, guided=True, capture_ref_attn=True)
    trun, _ = tdriver.make_dp_character_runner(
        tb, STEPS, use_ip=True, guided=True, capture_ref_attn=True)
    lat, ctx = _char_batch(42, 1.0)
    lat, ctx = lat[:2], ctx[:2]
    jg = _jax_gins([3, 5])
    jr = jrun(jb.unet_ip_params, jnp.asarray(lat[:, None]), jnp.asarray(ctx),
              jnp.asarray([0.4, 0.0], jnp.float32), jg,
              jax.random.split(jax.random.key(0), 2))
    tr = trun(_t(lat[:, None]), _t(ctx), [0.4, 0.0], _port_gins(jg))
    jt = np.asarray(jr.trajectory)
    np.testing.assert_allclose(_np(tr.trajectory), jt,
                               atol=1e-5 * np.abs(jt).max())
    for a, b in zip(tr.ref_attn, jr.ref_attn):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=MAP_TOL)


# ---------------------------------------------------------------------------
# module 5 and 6: the batched final runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["ddim", "euler_ancestral"])
def test_batched_final_runner_matches_jax_and_batch_1(kind):
    """Two dialogues' final passes (frozen steps 1 and 3, each its own
    frozen mask, contexts and hint; ControlNet, ip_scale 0.1) through
    ``driver.make_dp_final_runner``: final latents within
    TRAJ_TOL·max(|ref|, 1) of the JAX runner on a 1-device mesh (its keys'
    draws injected under Euler-Ancestral) and of the port's batch-1 runner
    per element; below each element's frozen steps its masked region is
    the composition's, bit for bit."""
    jb, tb = _bundles(kind)
    rng = np.random.RandomState(33)
    tsam = tsched.make_sampler(tcfg.tiny_config().scheduler, STEPS,
                               kind=kind)
    la = rng.randn(2, STEPS + 1, 1, h, w, 4).astype(np.float32)
    la[:, 0] *= tsam.init_noise_sigma
    fm = np.zeros((2, h, w), np.float32)
    fm[0, 2:6, 1:5] = 1.0
    fm[1, 1:4, 3:8] = 1.0
    frozen = [1, 3]
    ctx = rng.randn(2, 2, 20, 32).astype(np.float32)
    cn = rng.randn(2, 2, 16, 32).astype(np.float32)
    cond = rng.rand(2, PL.height, PL.width, 3).astype(np.float32)
    jrun, _ = jdriver.make_dp_final_runner(jb, STEPS, _mesh(), guided=False)
    keys = jax.random.split(jax.random.key(9), 2)
    jf = jrun(jb.unet_ip_params, jb.controlnet_params, jnp.asarray(la),
              jnp.asarray(fm), jnp.asarray(frozen, jnp.int32),
              jnp.asarray(ctx), jnp.asarray(cn), jnp.asarray(cond),
              jnp.float32(0.1), None, keys)
    trun, sam = tdriver.make_dp_final_runner(tb, STEPS, guided=False)
    noise = (_t(_stacked_noise(keys, (1, h, w, 4))) if sam.needs_noise
             else None)
    args = (_t(la), _t(fm), frozen, _t(ctx), _t(cn), _t(cond), 0.1, None)
    tf = trun(*args, noise=noise)
    assert tuple(tf.shape) == (2, 1, h, w, 4)
    _close(_np(tf), jf, TRAJ_TOL, "final")

    run_b, _ = tfinal.make_batched_final_pipeline(tb, STEPS)
    one, _ = tfinal.make_final_pipeline(tb, STEPS)
    gens = ([torch.Generator().manual_seed(50 + i) for i in range(2)]
            if sam.needs_noise else None)
    fb, trb = run_b(*args[:7], gens)
    for i in range(2):
        gen = torch.Generator().manual_seed(50 + i) if gens else None
        f1, tr1 = one(_t(la[i]), _t(fm[i]), frozen[i], _t(ctx[i]),
                      _t(cn[i]), _t(cond[i]), 0.1, gen)
        _close(_np(trb[i]), _np(tr1), TRAJ_TOL, f"batch-1 trajectory {i}")
        on = torch.from_numpy(fm[i] > 0)
        for j in range(frozen[i] + 1):
            torch.testing.assert_close(trb[i, j, 0][on],
                                       _t(la[i, j, 0])[on], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# module 7: detection and masks over a batch
# ---------------------------------------------------------------------------


def _maps(seed, b=4):
    """Per key, B characters' step-mean maps [B, heads, HW] at the tiny
    UNet's capture sides: one concentrated in a band (a clear detection),
    one flat, one a lone peak over a broad floor (too little mass in the
    box: a failed detection)."""
    rng = np.random.RandomState(seed)
    out = []
    for hw in (64, 16, 64):
        m = rng.rand(b, 2, hw).astype(np.float32)
        m[0, :, : hw // 4] += 4.0
        m[1] = 1.0
        m[2] = 0.4
        m[2, :, 0] = 1.0
        out.append(m)
    return out


def test_batched_detection_equals_per_image():
    """``attention_detect_batch`` over four characters: each element's box
    and verdict equal attention_detect's of its own maps, confidence 1e-6;
    against the JAX package's vmapped attention_detect the same."""
    maps = _maps(60)
    got = tdet.attention_detect_batch([_t(m) for m in maps])
    jb = jax.vmap(lambda *ms: jdet.attention_detect(list(ms), None))(
        *[jnp.asarray(m) for m in maps])
    assert got.ok.shape == (4,) and got.box.shape == (4, 4)
    for i in range(4):
        one = tdet.attention_detect([_t(m[i]) for m in maps], None)
        torch.testing.assert_close(got.box[i], one.box, rtol=0, atol=0)
        assert bool(got.ok[i]) == bool(one.ok)
        np.testing.assert_allclose(_np(got.confidence[i]),
                                   _np(one.confidence), atol=1e-6)
    np.testing.assert_array_equal(_np(got.box), np.asarray(jb.box))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(jb.ok))
    assert got.ok.tolist() == [True, True, False, True]


def test_batched_masks_equal_per_character():
    """The attention-threshold masks of four characters at once (the
    batched turn's ``_attn_mask_fallback``) equal each character's own,
    and the JAX package's vmapped fallback, bit for bit."""
    maps = _maps(61)
    hints = np.array([(0.1, 0.2, 0.5, 0.9), (0.0, 0.0, 1.0, 1.0),
                      (0.3, 0.1, 0.9, 0.6), (0.5, 0.5, 0.7, 0.7)],
                     np.float32)
    H = PL.height
    lat_b, pix_b = tth._attn_mask_fallback([_t(m) for m in maps], _t(hints),
                                           h, w, H, H)
    jl, jp = jax.vmap(lambda *a: jth._attn_mask_fallback(
        a[:-1], a[-1], h, w, H, H))(*[jnp.asarray(m) for m in maps],
                                    jnp.asarray(hints))
    for i in range(4):
        lat1, pix1 = tth._attn_mask_fallback([_t(m[i]) for m in maps],
                                             _t(hints[i]), h, w, H, H)
        torch.testing.assert_close(lat_b[i], lat1, rtol=0, atol=0)
        torch.testing.assert_close(pix_b[i], pix1, rtol=0, atol=0)
    np.testing.assert_array_equal(_np(lat_b), np.asarray(jl))
    np.testing.assert_array_equal(_np(pix_b), np.asarray(jp))
