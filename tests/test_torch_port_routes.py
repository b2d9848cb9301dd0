"""Flash attention's routes and rows 3 and 4 of the TPU kernel table.

The port's ``ops.flash_attention.route`` against the route the JAX package
takes, found by running its ``CrossAttention`` (or ``multi_head_attention``
for sequence-parallel shards) under ``jax.eval_shape`` with its four
Pallas entry points replaced by spies; and the port's plain attention
against the BSHD-native and copy-based Pallas kernels in interpret mode.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu.models.layers import CrossAttention as JCrossAttention
from theatergen_tpu.ops import attention as jattn
from theatergen_tpu.ops import flash_attention as fa
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

# the switch settings (module attributes of both packages, read at call
# time; each mirrors one JAX environment variable)
SETTINGS = {
    "defaults": {},
    "bshd": dict(BSHD_NATIVE=True),
    "flat_off": dict(FLAT=False),
    "flat16k_off": dict(FLAT_ONLINE=False),
    "packed_off": dict(PACKED=False),
    "bshd_flat_off": dict(BSHD_NATIVE=True, FLAT=False)}


@contextlib.contextmanager
def switches(setting: str):
    """Set a switch setting on both packages' flash modules."""
    saved = {}
    for mod in (fa, tfa):
        for name, value in SETTINGS[setting].items():
            saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, value)
    try:
        yield
    finally:
        for (mod, name), value in saved.items():
            setattr(mod, name, value)


@contextlib.contextmanager
def jax_spies(seen: list):
    """Replace the JAX package's Pallas entry points with shape-preserving
    spies that record which one a traced call reaches, on a simulated TPU
    (the gates check ``_on_tpu``; ``INTERPRET`` lets the packed gate
    pass)."""
    def zeros_like(name):
        def spy(x, *a, **k):
            seen.append(name)
            return jnp.zeros_like(x)
        return spy

    def pallas_call(kernel, out_shape, **kw):
        seen.append("copy")
        return lambda *a: jnp.zeros(out_shape.shape, out_shape.dtype)

    patches = [(fa, "flash_attention_packed", zeros_like("packed")),
               (fa, "_flat_call", zeros_like("flat")),
               (fa, "_flat_online_call", zeros_like("flat_online")),
               (fa, "_flash_attention_bshd", zeros_like("bshd")),
               (fa.pl, "pallas_call", pallas_call),
               (fa, "INTERPRET", True), (jattn, "_on_tpu", lambda: True)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def _one(seen):
    assert len(seen) <= 1, seen
    return seen[0] if seen else None


@functools.lru_cache(maxsize=None)
def jax_route(s: int, heads: int, d: int, quantized: bool, setting: str):
    """The Pallas route of a bf16 JAX self-attention layer at S tokens."""
    seen = []
    mod = JCrossAttention(num_heads=heads, head_dim=d, dtype=jnp.bfloat16,
                          quantized=quantized)
    x = jax.ShapeDtypeStruct((1, s, heads * d), jnp.bfloat16)
    with switches(setting), jax_spies(seen):
        jax.eval_shape(lambda x: mod.init_with_output(jax.random.key(0), x),
                       x)
    return _one(seen)


def model_sites():
    """(model, S, heads, d) of every self-attention of the SD1.5 UNet at
    512, 768 and 1024 px and the SDXL UNet at 1024 px (the levels with
    attention, and the mid block at the last level)."""
    sites = []
    for name, cfg, px in (("sd15", tcfg.sd15_config(), 512),
                          ("sd15", tcfg.sd15_config(), 768),
                          ("sd15", tcfg.sd15_config(), 1024),
                          ("sdxl", tcfg.sdxl_config(), 1024)):
        u = cfg.unet
        last = len(u.block_out_channels) - 1
        for level, ch in enumerate(u.block_out_channels):
            if u.attention_levels[level] or level == last:
                s = (px // 8 >> level) ** 2
                heads = u.heads_at(level)
                sites.append((f"{name}_{px}", s, heads, ch // heads))
    return sorted(set(sites))


SITES = model_sites()


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_routes_equal_the_jax_routes_at_the_model_sites(setting):
    """At every self-attention site of SD1.5 (512, 768, 1024 px; float and
    W8A8) and SDXL (1024 px, float), under each switch setting, the port's
    route is the JAX package's, and supported() says whether there is
    one."""
    assert ("sd15_1024", 1024, 8, 160) in SITES
    for model, s, heads, d in SITES:
        for quantized in ((False, True) if model.startswith("sd15")
                          else (False,)):
            want = jax_route(s, heads, d, quantized, setting)
            with switches(setting):
                got = tfa.route(s, s, heads, d, 2, quantized)
                assert tfa.supported(s, s, heads, d, 2, quantized) == (
                    got is not None)
            assert got == want, (model, s, heads, d, quantized, setting)


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_every_routed_head_dim_has_a_kernel_instance(setting):
    """Wherever a model site routes to flash, the kernel has an instance
    for its head dim (d = 160: SD1.5's level 2 on a 1024-px canvas)."""
    routed = set()
    with switches(setting):
        for model, s, heads, d in SITES:
            for quantized in (False, True):
                if tfa.route(s, s, heads, d, 2, quantized) is not None:
                    routed.add(d)
                    assert d in tfa.KERNEL_HEAD_DIMS, (model, s, d)
    assert 160 in routed and 40 in routed


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("sq,sk", [(4608, 9216), (2304, 9216),
                                   (4096, 4096), (100, 1024), (256, 77)])
def test_sequence_parallel_shards_route_like_the_jax_package(sq, sk,
                                                             setting):
    """Sq ≠ Sk (parallel/sp.py: Sq/n queries against all the keys, n = 2
    and 4 of the 768-px level 0): the port's route equals the JAX route of
    multi_head_attention on those shapes; keys outside the flash domain
    route nowhere."""
    seen = []
    q = jax.ShapeDtypeStruct((2, sq, 8, 40), jnp.bfloat16)
    k = jax.ShapeDtypeStruct((2, sk, 8, 40), jnp.bfloat16)
    with switches(setting), jax_spies(seen):
        jax.eval_shape(lambda q, k: jattn.multi_head_attention(q, k, k)[0],
                       q, k)
        # multi_head_attention never takes the packed projections, as a
        # quantized layer does not
        got = tfa.route(sq, sk, 8, 40, 2, quantized=True)
    assert got == _one(seen)
    if sq != sk and sk >= 1024:
        # BSHD-native takes a shard only where its 512-row q block divides
        # Sq (4608, 100), not at n = 4 (2304)
        bshd = setting.startswith("bshd") and sq % min(512, sq) == 0
        assert got == ("bshd" if bshd else "copy")


# ---------------------------------------------------------------------------
# rows 3 and 4 against their Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(fa, "INTERPRET", True)


def _qkv(b, sq, sk, h, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    return q, k, v


def _port(q, k, v):
    return tfa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               route="copy").numpy()


@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 256, 1024, 2, 40),
                                         (1, 256, 256, 1, 160),
                                         (2, 128, 512, 1, 64)])
def test_plain_matches_bshd_pallas(interpret, b, sq, sk, h, d):
    """_flash_attention_bshd (row 3; q blocks of 128, K blocks of 256, so
    the online correction runs) vs the port's flash_attention on CPU
    tensors, Sq ≠ Sk and d = 160 included.  Both fp32; the Pallas kernel
    rounds q·d^-0.5·log2e before the product and takes exp2, the port
    scales the logits and takes exp: 2e-5 on outputs of O(1)."""
    q, k, v = _qkv(b, sq, sk, h, d, 11)
    ref = fa._flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 128, 256)
    np.testing.assert_allclose(_port(q, k, v), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,h,d", [(1, 256, 1024, 2, 40),
                                         (1, 100, 512, 2, 40),
                                         (1, 200, 256, 1, 160)])
def test_plain_matches_copy_based_pallas(interpret, monkeypatch, b, sq, sk,
                                         h, d):
    """The copy-based _flash_attention_impl (row 4: FLAT and FLAT_ONLINE
    off; q padded to its 128-row block, the head dim to the lane pad) vs
    the port's flash_attention on CPU tensors: Sq ≠ Sk, a q length (100,
    200) that no block divides, and d = 160 (lane pad 256).  Bound as
    above."""
    monkeypatch.setattr(fa, "FLAT", False)
    monkeypatch.setattr(fa, "FLAT_ONLINE", False)
    monkeypatch.setattr(fa, "BSHD_NATIVE", False)
    q, k, v = _qkv(b, sq, sk, h, d, 12)
    ref = fa._flash_attention_impl(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 128, 256)
    np.testing.assert_allclose(_port(q, k, v), np.asarray(ref), atol=2e-5)


def test_route_counters_and_names_on_cpu():
    """On CPU tensors no counter moves on any route; an unknown route is
    refused on the card only (the CPU runs the plain version)."""
    names = ("launches", "launches_long", "launches_bshd", "launches_copy")
    before = [getattr(tfa, n) for n in names]
    x = torch.randn(1, 1024, 1, 40)
    for route in list(tfa.COUNTERS) + [None]:
        assert tfa.flash_attention(x, x, x, route=route).shape == x.shape
    assert [getattr(tfa, n) for n in names] == before
    assert set(tfa.COUNTERS.values()) == set(names)
    assert tfa.flops(2, 100, 8, 40, 1024) == 4.0 * 2 * 8 * 100 * 1024 * 40
    assert tfa.min_bytes(2, 100, 8, 40, 1024) == 2.0 * 2 * 8 * 40 * 1124 * 2
