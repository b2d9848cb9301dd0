"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions and the Pallas
kernels run in interpret mode, so these tests hold the plain versions to
the TPU kernels' semantics.  ``test_torch_port_cuda.py`` holds the CUDA
kernels to the plain versions on the card.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.ops import flash_attention as fa
from theatergen_tpu.ops import geglu_matmul as gg
from theatergen_tpu.ops import groupnorm as gn
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models import layers as tl
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.ops import flash_attention as tfa
from theatergen_tpu_torch.ops import geglu_matmul as tgg
from theatergen_tpu_torch.ops import groupnorm as tgn
from theatergen_tpu_torch.pipelines.bundle import init_bundle

from test_torch_port_models import random_params
from test_torch_port_routes import SETTINGS, jax_route, switches

torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(fa, "INTERPRET", True)
    monkeypatch.setattr(gg, "INTERPRET", True)


def _pack(x, dp):
    b, s, h, d = x.shape
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, 0), (0, dp - d))
                   ).reshape(b, s, h * dp)


@pytest.mark.parametrize("d", [40, 80])
def test_flash_plain_matches_packed_pallas(interpret, d):
    """flash_attention_packed (interpret) vs the port's flash_attention on
    CPU tensors.  Both run fp32; the Pallas kernel takes base-2 logits of a
    pre-scaled q, the port scales fp32 logits — 1e-5 covers that rounding
    (outputs are O(1))."""
    b, s, h = 1, 128, 2
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    dp = fa._pad_head_dim(d)
    out = fa.flash_attention_packed(
        _pack(q * (d ** -0.5 * fa.LOG2E), dp), _pack(k, dp), _pack(v, dp),
        h, d)
    ref = np.asarray(out).reshape(b, s, h, dp)[..., :d]
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_ff_plain_matches_pallas(interpret):
    """ff_matmul (interpret) vs the port's ff_matmul on CPU tensors at
    M=256, D=32, K=256.  The Pallas kernel's gate uses a 3-term erf with
    max error 2.5e-5; through gelu (|g| ≲ 1 here) and a K=256 down
    product with 0.05-scale weights that stays below 1e-4 absolute."""
    m, d, k = 256, 32, 256
    rng = np.random.RandomState(1)
    x = rng.randn(m, d).astype(np.float32)
    w1 = (rng.randn(d, 2 * k) * 0.05).astype(np.float32)
    b1 = (rng.randn(2 * k) * 0.1).astype(np.float32)
    w2 = (rng.randn(k, d) * 0.05).astype(np.float32)
    ref = np.asarray(gg.ff_matmul(jnp.asarray(x), jnp.asarray(w1),
                                  jnp.asarray(b1), jnp.asarray(w2)))
    # the port takes the modules' [out, in] weights as they are
    got = tgg.ff_matmul(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                        torch.from_numpy(b1), torch.from_numpy(w2.T.copy()))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_geglu_plain_matches_pallas(interpret, dtype):
    """geglu_matmul (interpret) vs the port's geglu_matmul on CPU tensors
    at M=256, K=256, N=128 (a block _plan accepts).  fp32: the Pallas
    gate's erf (max error 1.5e-7) through a K=256 product with
    0.05-scale weights stays below 1e-4 absolute.  bf16: both round h to
    bf16 before the product and round the output; the erf difference can
    flip an h rounding (2^-8 relative), so 1e-2·max|ref|."""
    m, k, n = 256, 256, 128
    rng = np.random.RandomState(2)
    hg = rng.randn(m, 2 * k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    ref = np.asarray(gg.geglu_matmul(jnp.asarray(hg, dtype),
                                     jnp.asarray(w, dtype))).astype(np.float32)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    # the port takes the module's [out, in] weight as it is
    got = tgg.geglu_matmul(torch.from_numpy(hg).to(tdt),
                           torch.from_numpy(w.T.copy()).to(tdt))
    assert got.dtype == tdt and got.shape == (m, n)
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)
    else:
        assert np.abs(got.float().numpy() - ref).max() <= (
            1e-2 * np.abs(ref).max())


def test_gates_cover_the_sd15_shapes():
    """The flash gate is the TPU gates' domain (8 heads of 40 here): 1024
    to 32768 tokens in steps of 512, the 768-px canvas's 9216 included; a
    head dim without a kernel instance raises on the card instead
    (``test_torch_port_cuda.py``)."""
    for s in (1024, 1536, 4096, 8192, 9216):
        assert tfa.supported(s, s, 8, 40)
    assert not tfa.supported(256, 256, 8, 40)      # below the flash domain
    assert not tfa.supported(4096, 77, 8, 40)      # cross-attention
    assert not tfa.supported(1100, 1100, 8, 40)    # not a multiple of 512
    assert not tfa.supported(2304, 2304, 8, 80)    # 768 px, level 1
    assert not tfa.supported(33280, 33280, 8, 40)  # above the domain


@pytest.mark.parametrize("s", [1024, 2304, 4096, 4608, 9216, 16384, 32768,
                               33280])
@pytest.mark.parametrize("d", [40, 64, 80])
def test_flash_gate_equals_the_jax_route(s, d):
    """The port's route() is the route the JAX package's CrossAttention
    takes (found by spying on its four Pallas entry points under
    jax.eval_shape, test_torch_port_routes.jax_route), at 8 heads and at
    SDXL's 20 (where the online blocks' budget binds earlier), in a float
    and a quantized layer, under each switch setting; supported() says
    whether there is a route; cross-attention lengths route nowhere."""
    for heads in (8, 20):
        for quantized in (False, True):
            for setting in SETTINGS:
                want = jax_route(s, heads, d, quantized, setting)
                with switches(setting):
                    got = tfa.route(s, s, heads, d, 2, quantized)
                    assert tfa.supported(s, s, heads, d, 2,
                                         quantized) == (want is not None)
                assert got == want, (heads, quantized, setting)
    assert not tfa.supported(s, 77, 8, d)


@pytest.mark.parametrize("gate,shape", [
    # SD1.5 at 512 px (M = 2·H·W; D, inner K): levels 0-2 and the mid block
    ("ff", (8192, 320, 1280)), ("ff", (2048, 640, 2560)),
    ("ff", (512, 1280, 5120)), ("ff", (128, 1280, 5120)),
    # SD1.5 at 768 px: levels 0-2 take the kernel, the mid block's 288
    # rows do not
    ("ff", (18432, 320, 1280)), ("ff", (4608, 640, 2560)),
    ("ff", (1152, 1280, 5120)), ("ff", (288, 1280, 5120)),
    # SDXL's FF through the whole-FF gate, and rows that miss
    ("ff", (8192, 640, 2560)), ("ff", (2048, 1280, 5120)),
    ("ff", (16, 320, 1280)), ("ff", (100, 640, 2560)),
    # geglu_matmul's (M, K, N): SDXL's two levels, SD1.5's widths, N past
    # 2048, and rows that miss
    ("geglu", (8192, 2560, 640)), ("geglu", (2048, 5120, 1280)),
    ("geglu", (1152, 5120, 1280)), ("geglu", (512, 5120, 2560)),
    ("geglu", (288, 5120, 1280)), ("geglu", (16, 1280, 320))])
def test_ff_gates_equal_the_jax_gates(monkeypatch, gate, shape):
    """The port's ff_supported() and supported() give the JAX package's
    ff_supported / supported answers (under INTERPRET, so its TPU check
    passes on the CPU) at the SD1.5 (512 and 768 px) and SDXL FF shapes
    and at rows no block divides, so one configuration sends the same FF
    sites to a kernel in both packages."""
    monkeypatch.setattr(gg, "INTERPRET", True)
    if gate == "ff":
        got, want = tgg.ff_supported(*shape), gg.ff_supported(*shape,
                                                               jnp.bfloat16)
    else:
        got, want = tgg.supported(*shape), gg.supported(*shape, jnp.bfloat16)
    assert got == want


def test_flash_plain_matches_flat_online_pallas(interpret):
    """_flat_online_call (the Sk > 4096 route's Pallas kernel, interpret)
    forced onto 256-row q blocks and two 512-key K blocks, so the online
    correction runs, vs the port's flash_attention on CPU tensors at
    (1, 1024, 2, 40); logits of scale ~9 (q, k × 3), up to ~40.  Both
    fp32, but the Pallas kernel rounds q·d^-0.5·log2e before the product
    and takes exp2, the port scales the logits and takes exp: ~4e-6 apart
    in a logit of 40, which the softmax passes on as relative error, so
    5e-5 absolute on outputs of O(1) (1.6e-5 measured)."""
    b, s, h, d = 1, 1024, 2, 40
    rng = np.random.RandomState(3)
    q, k = (rng.randn(b, s, h, d).astype(np.float32) * 3 for _ in range(2))
    v = rng.randn(b, s, h, d).astype(np.float32)
    dp = fa._pad_head_dim(d)
    out = fa._flat_online_call(
        _pack(q * (d ** -0.5 * fa.LOG2E), dp), _pack(k, dp), _pack(v, dp),
        h, dp, bq=256, bk=512)
    ref = np.asarray(out).reshape(b, s, h, dp)[..., :d]
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)
    np.testing.assert_array_equal(
        tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v)).numpy(), got.numpy())


def test_flash_route_counters_stay_apart_on_cpu():
    """On CPU tensors neither counter moves, at either route's length."""
    before = (tfa.launches, tfa.launches_long)
    for s in (1024, 4608):
        x = torch.randn(1, s, 1, 40)
        assert tfa.flash_attention(x, x, x).shape == x.shape
    assert (tfa.launches, tfa.launches_long) == before


# ff_matmul's (M, D, K) on the main paths (SD1.5 at 512 px, the 768-px
# final pass), and ragged row counts
FF_PLAN_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120),
                  (128, 1280, 5120), (18432, 320, 1280), (4608, 640, 2560),
                  (1152, 1280, 5120), (100, 320, 1280), (1000, 640, 2560)]


@pytest.mark.parametrize("m,d,k", FF_PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 120])
def test_ff_plan_fills_the_card(m, d, k, sms):
    """The FF kernel's launch plan: a cluster of D/160 CTAs per 128 rows,
    splits that hold whole chunks, split counters for every CTA of a split,
    and CTAs enough to keep at least 80 % of the SMs busy, or every chunk
    of the shape in flight where it has less work than that (one full wave
    of whole clusters beats a second, near-empty one)."""
    c, bm, splits = tgg.ff_plan(m, d, k, sms)
    assert (c, bm) == (d // tgg.FF_CTA_COLS, tgg.FF_BM)
    chunks = k // tgg.ff_chunk(d)
    assert k % tgg.ff_chunk(d) == 0 and chunks % splits == 0
    ctas = -(-m // bm) * c
    assert tgg.ff_counter_slots(m, d) == ctas
    assert ctas * splits >= 0.8 * min(sms, ctas * chunks)


def test_ff_split_counters_grow_to_the_row_blocks():
    """The counter buffer is sized by the CTAs of a split (row blocks x
    cluster size), not by the SM count, and grows for a larger call."""
    dev = torch.device("cpu")
    tgg._split_counters.pop(dev, None)
    small = tgg._counters(dev, tgg.ff_counter_slots(512, 1280))
    assert small.numel() == 32 and not small.any()
    big = tgg._counters(dev, tgg.ff_counter_slots(18432, 320))
    assert big.numel() == 288 and not big.any()
    assert tgg._counters(dev, 8) is big
    tgg._split_counters.pop(dev, None)


@pytest.mark.parametrize("s", [9216, 4608, 2304])
def test_flash_q_block_divides_the_sp_shards(s):
    """The flash kernel's 128-row q block divides the 768-px level-0 length
    and its 2- and 4-way sequence-parallel shards, so every shard's blocks
    hold the same rows as the unsharded call's (bit-equal concatenation)."""
    assert s % tfa.Q_BLOCK == 0


def test_layers_route_to_the_kernels(monkeypatch):
    """In the kernels' domains the layers call the kernel wrappers, whatever
    the head dim or width; on CPU tensors the wrappers run the plain
    versions and launch nothing."""
    calls = []
    real_fa, real_ff = tfa.flash_attention, tgg.ff_matmul
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append("flash")
                        or real_fa(*a, **k))
    monkeypatch.setattr(tgg, "ff_matmul",
                        lambda *a: calls.append("ff") or real_ff(*a))
    launches = (tfa.launches, tgg.ff_launches, tgg.geglu_launches)
    torch.manual_seed(0)
    for heads, head_dim in ((2, 40), (1, 64)):
        attn = tl.CrossAttention(80, heads, head_dim).to(torch.bfloat16)
        x = torch.randn(1, 1024, 80, dtype=torch.bfloat16)
        attn(x)
        attn(x, torch.randn(1, 77, 80, dtype=torch.bfloat16))  # cross: plain
    assert calls == ["flash", "flash"]
    for dim in (320, 32):
        ff = tl.FeedForward(dim, fused_ff=True).to(torch.bfloat16)
        # 128 rows: the smallest row block of the JAX FF gate
        y = torch.randn(1, 128, dim, dtype=torch.bfloat16)
        out = ff(y)
        ref = ff.net[2](ff.net[0](y)).float()
        # fused (fp32 gate) vs unfused (bf16 up-projection): bf16 rounding
        assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max()
        ff.float()(y.float())                  # fp32: the plain path
    assert calls == ["flash", "flash", "ff", "ff"]
    assert (tfa.launches, tgg.ff_launches, tgg.geglu_launches) == launches


@pytest.mark.parametrize("fused_ff,dtype,plain,want", [
    (False, torch.bfloat16, False, "geglu"),
    (True, torch.bfloat16, False, "ff"),
    (False, torch.float32, False, None),
    (True, torch.float32, False, None),
    (False, torch.bfloat16, True, None),
    (True, torch.bfloat16, True, None)])
def test_ff_layer_routes(monkeypatch, fused_ff, dtype, plain, want):
    """FeedForward's routes, as the JAX package's layers.py:235-254 gates
    them (128 rows, which both of its gates take): fused_ff and bf16 →
    ff_matmul; bf16 without fused_ff → a plain up-projection, then
    geglu_matmul on it and net.2's weight; fp32, and anything inside
    plain_path(), → the plain modules.  Each route gives the plain
    modules' answer within bf16 rounding (2e-2·max|ref|)."""
    calls = []
    real_ff, real_gg = tgg.ff_matmul, tgg.geglu_matmul
    monkeypatch.setattr(tgg, "ff_matmul",
                        lambda *a: calls.append("ff") or real_ff(*a))
    monkeypatch.setattr(tgg, "geglu_matmul",
                        lambda *a: calls.append("geglu") or real_gg(*a))
    torch.manual_seed(1)
    ff = tl.FeedForward(64, fused_ff=fused_ff).to(dtype)
    x = torch.randn(2, 64, 64, dtype=dtype)
    if plain:
        with tl.plain_path():
            out = ff(x)
        assert tl._use_kernels
    else:
        out = ff(x)
    assert calls == ([want] if want else [])
    ref = ff.float().net[2](ff.net[0](x.float()))
    assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_plain_path_keeps_flash_off(monkeypatch):
    """A bf16 self-attention in the flash domain at SDXL's head dim 64
    reaches the flash wrapper, and inside plain_path() does not."""
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append("flash") or real(*a, **k))
    attn = tl.CrossAttention(128, 2, 64).to(torch.bfloat16)
    x = torch.randn(1, 1024, 128, dtype=torch.bfloat16)
    attn(x)
    with tl.plain_path():
        attn(x)
    assert calls == ["flash"]


# ---------------------------------------------------------------------------
# GroupNorm (+SiLU): ops/groupnorm.py against the Pallas kernel
# ---------------------------------------------------------------------------

# SD1.5 512 px with CFG: (C, H·W) of the UNet's GroupNorms and the calls of
# each per evaluation (61 in all, 45 with SiLU)
SD15_GN_SITES = {
    (320, 4096): 13, (640, 4096): 2, (960, 4096): 1,
    (320, 1024): 1, (640, 1024): 11, (960, 1024): 1, (1280, 1024): 1,
    (1920, 1024): 1,
    (640, 256): 1, (1280, 256): 11, (1920, 256): 1, (2560, 256): 2,
    (1280, 64): 12, (2560, 64): 3,
}


@pytest.mark.parametrize("cpg", [10, 30])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("offset", [0.0, 100.0])
def test_group_norm_plain_matches_pallas(monkeypatch, cpg, act, offset):
    """_gn_fused (Pallas, interpret) vs the port's fused_group_norm on CPU
    tensors, 4 groups of 10 or 30 channels over 8x8, fp32.  With offset 0
    (O(1) outputs) both agree to 2e-5 absolute; with a group mean of 100
    against a std of 0.1 (the centred variance matters: E[x²] - mean²
    would lose the variance to cancellation), the two fp32 sums of
    100-magnitude values round differently, 1e-3 absolute."""
    monkeypatch.setattr(gn, "INTERPRET", True)
    b, g, h, w = 2, 4, 8, 8
    c = g * cpg
    rng = np.random.RandomState(cpg)
    x = (rng.randn(b, h, w, c) * (0.1 if offset else 1.0) + offset).astype(
        np.float32)
    scale = (1.0 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    ref = np.asarray(gn._gn_fused(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), g, 1e-5, act))
    got = tgn.fused_group_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(scale), torch.from_numpy(bias), num_groups=g,
        act=act)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=1e-3 if offset else 2e-5)


def test_group_norm_plain_rounds_once_after_silu():
    """In bf16 the plain version rounds once, after the SiLU, as the kernel
    does: it equals the fp32 result rounded to bf16 exactly."""
    torch.manual_seed(0)
    x = torch.randn(2, 64, 8, 8).to(torch.bfloat16)
    w, b = torch.rand(64) + 0.5, torch.randn(64) * 0.1
    got = tgn.fused_group_norm(x, w.to(torch.bfloat16), b.to(torch.bfloat16),
                               act="silu")
    ref = tgn.fused_group_norm_plain(x.float(), w.to(torch.bfloat16).float(),
                                     b.to(torch.bfloat16).float(), act="silu")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.to(torch.bfloat16))
    with pytest.raises(ValueError, match="swish"):
        tgn.fused_group_norm(x, w, b, act="swish")


@pytest.mark.parametrize("cpg", [10, 30, 80])
def test_group_norm_plain_keeps_the_variance_centred(cpg):
    """The large-mean input of the card checks (mean 1024, std 1.5, in
    bf16: a few distinct values, mean/std ~ 700), 32 groups over 16x16:
    the plain version stays within 1e-3·max|ref| of an fp64 GroupNorm+SiLU,
    while the variance taken as E[x²] - mean² in fp32 misses even the
    kernels' 1e-2·max|ref|, so that input can tell the two apart."""
    g, c = 32, 32 * cpg
    rng = np.random.RandomState(cpg)
    x = torch.from_numpy(rng.randn(2, c, 16, 16) * 1.5 + 1024.0).to(
        torch.bfloat16)
    w = torch.from_numpy(1.0 + 0.2 * rng.randn(c)).float()
    b = torch.from_numpy(0.1 * rng.randn(c)).float()
    xd = x.double().reshape(2, g, -1)
    mean = xd.mean(-1, keepdim=True)
    var = (xd - mean).square().mean(-1, keepdim=True)
    ref = ((xd - mean) / torch.sqrt(var + 1e-5)).reshape(2, c, -1)
    ref = torch.nn.functional.silu(ref * w.double()[:, None]
                                   + b.double()[:, None]).reshape(x.shape)
    got = tgn.fused_group_norm_plain(x.float(), w, b, act="silu")
    assert x.unique().numel() >= 3
    assert (got.double() - ref).abs().max() <= 1e-3 * ref.abs().max()
    xf = x.float().reshape(2, g, -1)
    m32 = xf.mean(-1, keepdim=True)
    var32 = (xf.square().mean(-1, keepdim=True) - m32.square()).clamp_min(0)
    unc = ((xf - m32) * torch.rsqrt(var32 + 1e-5)).reshape(2, c, -1)
    unc = torch.nn.functional.silu(unc * w[:, None] + b[:, None])
    assert (unc.reshape(x.shape).double() - ref).abs().max() \
        > 1e-2 * ref.abs().max()


@pytest.mark.parametrize("hwc", [
    (64, 64, 320), (64, 64, 960), (32, 32, 640), (16, 16, 1280),
    (8, 8, 2560), (128, 128, 320), (128, 128, 640), (3, 3, 64),
    (4, 4, 48), (64, 64, 1920)])
def test_group_norm_gates_equal_the_tpu_gates(hwc):
    """supported() and profitable() on NCHW give the TPU gates' answers on
    the same NHWC shape, so one configuration routes the same sites in
    both packages (SDXL's 128²×320 is just inside the size limit,
    128²×640 outside)."""
    h, w, c = hwc
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        assert tgn.supported((2, c, h, w), dt) == gn.supported(
            (2, h, w, c), jdt)
    assert tgn.profitable((2, c, h, w)) == gn.profitable((2, h, w, c))


@pytest.mark.parametrize("mode,layer_fp32,plain,hw,want", [
    ("0", False, False, 64, 0), ("1", False, False, 64, 1),
    ("1", False, False, 16, 1), ("auto", False, False, 64, 1),
    ("auto", False, False, 16, 0), ("1", True, False, 64, 0),
    ("1", False, True, 64, 0), ("1", False, False, 3, 0)])
def test_group_norm_layer_routes(monkeypatch, mode, layer_fp32, plain, hw,
                                 want):
    """GroupNorm's route, as the JAX gate (layers.py:116-122) takes it: the
    switch on ("1", or "auto" where profitable: 64² yes, 16² at C = 64
    no), the norm in the model dtype (fp32=False, i.e. fast_norm), a
    supported shape (3x3: H·W % 8 != 0 is not), and never inside
    plain_path().  Each route gives the fp32 norm + SiLU within bf16
    rounding (2e-2·max|ref|)."""
    monkeypatch.setattr(tgn, "FUSED_MODE", mode)
    calls = []
    real = tgn.fused_group_norm
    monkeypatch.setattr(tgn, "fused_group_norm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    torch.manual_seed(2)
    norm = tl.GroupNorm(32, 64, act="silu", fp32=layer_fp32)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.normal_(0.0, 0.1)
    norm = norm.to(torch.bfloat16)
    x = torch.randn(1, 64, hw, hw, dtype=torch.bfloat16)
    if plain:
        with tl.plain_path():
            out = norm(x)
    else:
        out = norm(x)
    assert len(calls) == want
    ref = torch.nn.functional.silu(torch.nn.functional.group_norm(
        x.float(), 32, norm.weight.float(), norm.bias.float(), 1e-5))
    assert (out.float() - ref).abs().max() <= 2e-2 * ref.abs().max()


def test_sd15_unet_group_norm_sites(monkeypatch):
    """The full-size SD1.5 UNet, run on the meta device with bf16 weights
    at 512 px with CFG (B = 2): under "1" all 61 GroupNorms reach
    fused_group_norm at the shapes of SD15_GN_SITES, 45 of them with SiLU
    (3050 per 50-step request); under "auto" the profitable ones (H·W ≥
    4096, or C ≥ 1280 at H·W ≤ 256)."""
    sites = []
    real = tgn.fused_group_norm

    def spy(x, *a, **k):
        sites.append((x.shape[1], x.shape[2] * x.shape[3], k["act"]))
        return real(x, *a, **k)

    monkeypatch.setattr(tgn, "fused_group_norm", spy)
    with torch.device("meta"):
        unet = TUNet(tcfg.sd15_config().unet).to(torch.bfloat16)
        x = torch.empty(2, 4, 64, 64)
        t = torch.empty(2, dtype=torch.long)
        ctx = torch.empty(2, 77, 768)
    with torch.no_grad():
        for mode in ("1", "auto"):
            monkeypatch.setattr(tgn, "FUSED_MODE", mode)
            sites.clear()
            unet(x, t, ctx)
            got = collections.Counter((c, n) for c, n, _ in sites)
            want = {k: v for k, v in SD15_GN_SITES.items()
                    if mode == "1" or k[1] >= 4096
                    or (k[0] >= 1280 and k[1] <= 256)}
            assert dict(got) == want
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    sites.clear()
    unet(x, t, ctx)
    assert len(sites) == 61
    assert sum(act == "silu" for _, _, act in sites) == 45


def test_ip_unet_with_fused_gn_matches_jax(monkeypatch):
    """The tiny IP UNet with the switch at "1" on both sides (the JAX
    package's Pallas GroupNorm in interpret mode), fp32: the same norm
    sites take the kernel route (H·W = 64 and 16; 2x2 fails the gate in
    both), and eps agrees to 1e-4 absolute (fp32 through 5 transformer
    blocks, O(1) outputs)."""
    monkeypatch.setattr(gn, "FUSED", True)
    monkeypatch.setattr(gn, "FUSED_MODE", "1")
    monkeypatch.setattr(gn, "INTERPRET", True)
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    j_calls, t_calls = [], []
    real_j, real_t = gn._gn_fused, tgn.fused_group_norm
    monkeypatch.setattr(gn, "_gn_fused",
                        lambda *a: j_calls.append(1) or real_j(*a))
    monkeypatch.setattr(tgn, "fused_group_norm",
                        lambda *a, **k: t_calls.append(1) or real_t(*a, **k))
    cfg = jcfg.tiny_config()
    unet = JUNet(dataclasses.replace(cfg.unet, ip_num_tokens=4))
    up = random_params(unet, 7, jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 20, 32)))
    rng = np.random.RandomState(8)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(2, 20, 32).astype(np.float32)
    t = np.array([501, 501], np.int32)
    j_calls.clear()    # random_params traced the UNet once
    ref = unet.apply({"params": up}, jnp.asarray(x), jnp.asarray(t),
                     jnp.asarray(ctx), ip_scale=0.4)
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu",
                     with_ip=True).load_flax(unet_ip=up)
    with torch.no_grad():
        got = tb.unet_ip(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(t).long(), torch.from_numpy(ctx),
                         ip_scale=0.4)
    assert len(t_calls) == len(j_calls) > 0
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-4)
