"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain versions and the Pallas
kernels run in interpret mode, so these tests hold the plain versions to
the TPU kernels' semantics.  ``test_torch_port_cuda.py`` holds the CUDA
kernels to the plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu.ops import flash_attention as fa
from theatergen_tpu.ops import geglu_matmul as gg
from theatergen_tpu_torch.models import layers as tl
from theatergen_tpu_torch.ops import flash_attention as tfa
from theatergen_tpu_torch.ops import geglu_matmul as tgg

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
    """The flash gate is the TPU gate's domain, by sequence length alone;
    a head dim without a kernel instance raises on the card instead
    (``test_torch_port_cuda.py``)."""
    for s in (1024, 1536, 4096):
        assert tfa.supported(s, s)
    assert not tfa.supported(256, 256)      # below the flash domain
    assert not tfa.supported(4096, 77)      # cross-attention
    assert not tfa.supported(1100, 1100)    # not a multiple of 512
    assert not tfa.supported(8192, 8192)    # above the domain


@pytest.mark.parametrize("m,d,k,sms,want", [
    (8192, 320, 1280, 132, 1), (2048, 640, 2560, 132, 2),
    (512, 1280, 5120, 132, 4), (128, 1280, 5120, 132, 16),
    (128, 1280, 5120, 8, 1)])
def test_ff_inner_splits_fill_the_card(m, d, k, sms, want):
    """Row blocks x inner splits stay within one block per SM (so the split
    counters, one per row block, fit in SM-count slots), and every split
    holds whole 64-column chunks."""
    s = tgg.inner_splits(m, d, k, sms)
    assert s == want and (k // tgg.K_CHUNK) % s == 0
    assert s == 1 or -(-m // (tgg.BLOCK_ELEMS // d)) * s <= sms


def test_layers_route_to_the_kernels(monkeypatch):
    """In the kernels' domains the layers call the kernel wrappers, whatever
    the head dim or width; on CPU tensors the wrappers run the plain
    versions and launch nothing."""
    calls = []
    real_fa, real_ff = tfa.flash_attention, tgg.ff_matmul
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a: calls.append("flash") or real_fa(*a))
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
        y = torch.randn(1, 16, dim, dtype=torch.bfloat16)
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
    them: fused_ff and bf16 → ff_matmul; bf16 without fused_ff → a plain
    up-projection, then geglu_matmul on it and net.2's weight; fp32, and
    anything inside plain_path(), → the plain modules.  Each route gives
    the plain modules' answer within bf16 rounding (2e-2·max|ref|)."""
    calls = []
    real_ff, real_gg = tgg.ff_matmul, tgg.geglu_matmul
    monkeypatch.setattr(tgg, "ff_matmul",
                        lambda *a: calls.append("ff") or real_ff(*a))
    monkeypatch.setattr(tgg, "geglu_matmul",
                        lambda *a: calls.append("geglu") or real_gg(*a))
    torch.manual_seed(1)
    ff = tl.FeedForward(64, fused_ff=fused_ff).to(dtype)
    x = torch.randn(2, 16, 64, dtype=dtype)
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
                        lambda *a: calls.append("flash") or real(*a))
    attn = tl.CrossAttention(128, 2, 64).to(torch.bfloat16)
    x = torch.randn(1, 1024, 128, dtype=torch.bfloat16)
    attn(x)
    with tl.plain_path():
        attn(x)
    assert calls == ["flash"]
