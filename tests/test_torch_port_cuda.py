"""The port's CUDA kernels against their plain versions on the card.

Every test here needs an NVIDIA GPU and skips (deciding inside the test)
where ``torch.cuda.is_available()`` is false.  On a machine with a card:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q

This file imports no JAX, so it also runs where JAX is not installed.
"""

import pytest
import torch

from theatergen_tpu_torch.models import layers as tl
from theatergen_tpu_torch.ops import attention as tat
from theatergen_tpu_torch.ops import flash_attention as tfa
from theatergen_tpu_torch.ops import geglu_matmul as tgg
from theatergen_tpu_torch.ops import groupnorm as tgn
from theatergen_tpu_torch.ops import quant as tq
from theatergen_tpu_torch.ops import quant_matmul as tqm


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(4096, 40), (1024, 80)])
def test_flash_kernel_matches_plain_on_card(s, d):
    """Kernel vs plain (fp32 from the same bf16 inputs) at SD1.5's shapes
    with CFG batch 2, 8 heads; bound 1e-2·max|ref| for the bf16 output."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(2, s, 8, d, device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    out = tfa.flash_attention(q, k, v).float()
    ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("s,h", [(4096, 10), (1024, 20)])
def test_flash_kernel_d64_matches_plain_on_card(s, h):
    """The d = 64 instance at SDXL's shapes (CFG batch 2); bound
    1e-2·max|ref| for the bf16 output."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, s, h, 64, device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    out = tfa.flash_attention(q, k, v).float()
    ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
def test_flash_kernel_long_route_matches_plain_on_card():
    """SD1.5 on a 768-px canvas: level-0 self-attention at S = 9216, 8
    heads of 40, CFG batch 2 (the JAX package's _flat_online_call route).
    Kernel vs plain (fp32 from the same bf16 inputs), 1e-2·max|ref|; the
    launch counts on launches_long only."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(6)
    q, k, v = (torch.randn(2, 9216, 8, 40, device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    n0 = (tfa.launches, tfa.launches_long)
    out = tfa.flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.launches_long) == (n0[0], n0[1] + 1)
    ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
def test_self_attention_routes_at_768_px():
    """A bf16 self-attention layer at 96² = 9216 tokens (8 heads of 40)
    launches the kernel on the long route; at 48² = 2304 tokens (not a
    multiple of 512: outside the JAX package's flash domain) it launches
    nothing and runs the plain attention."""
    dev = _card()
    attn = tl.CrossAttention(320, 8, 40).to(dev, torch.bfloat16)
    n0 = (tfa.launches, tfa.launches_long)
    with torch.no_grad():
        attn(torch.randn(2, 9216, 320, device=dev, dtype=torch.bfloat16))
        mid = (tfa.launches, tfa.launches_long)
        attn2 = tl.CrossAttention(640, 8, 80).to(dev, torch.bfloat16)
        attn2(torch.randn(2, 2304, 640, device=dev, dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert mid == (n0[0], n0[1] + 1)
    assert (tfa.launches, tfa.launches_long) == mid


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d", [(1024, 1024, 160), (100, 1024, 40),
                                     (100, 1024, 160), (4608, 9216, 40)])
def test_flash_kernel_d160_and_sq_ne_sk_on_card(sq, sk, d):
    """The d = 160 instance (SD1.5's level 2 at 1024 px; dynamic shared
    memory past 48 KB), and Sq ≠ Sk with a q tail that the 128-row tile
    does not divide (Sq = 100) and at sequence parallelism's 2-shard
    shape: kernel vs plain, 1e-2·max|ref|."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(sq + d)
    q = torch.randn(2, sq, 8, d, device=dev, generator=g, dtype=torch.bfloat16)
    k, v = (torch.randn(2, sk, 8, d, device=dev, generator=g,
                        dtype=torch.bfloat16) for _ in range(2))
    out = tfa.flash_attention(q, k, v, route="copy").float()
    ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert out.shape == (2, sq, 8, d)
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
def test_each_route_counts_on_its_own_counter_on_card():
    """One launch per route moves that route's counter only ("packed" and
    "flat" share row 1's); a layer under the switches launches on the
    route the JAX package would take."""
    dev = _card()
    names = ("launches", "launches_long", "launches_bshd", "launches_copy")
    q = torch.randn(1, 1024, 2, 40, device=dev, dtype=torch.bfloat16)
    for route, counter in tfa.COUNTERS.items():
        before = {n: getattr(tfa, n) for n in names}
        tfa.flash_attention(q, q, q, route=route)
        torch.cuda.synchronize()
        after = {n: getattr(tfa, n) for n in names}
        assert {n: after[n] - before[n] for n in names} == {
            n: int(n == counter) for n in names}
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, route="nope")
    attn = tl.CrossAttention(80, 2, 40, quantized=False).to(dev,
                                                           torch.bfloat16)
    x = torch.randn(1, 1024, 80, device=dev, dtype=torch.bfloat16)
    saved = (tfa.BSHD_NATIVE, tfa.PACKED)
    try:
        for bshd, packed, counter in ((True, True, "launches"),
                                      (True, False, "launches_bshd"),
                                      (False, False, "launches")):
            tfa.BSHD_NATIVE, tfa.PACKED = bshd, packed
            before = getattr(tfa, counter)
            with torch.no_grad():
                attn(x)
            assert getattr(tfa, counter) == before + 1
    finally:
        tfa.BSHD_NATIVE, tfa.PACKED = saved


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 2560, 640), (2048, 5120, 1280),
                                   (100, 2560, 640)])
def test_geglu_kernel_matches_plain_on_card(m, k, n):
    """geglu_matmul's kernel vs its plain version (fp32 from the same bf16
    inputs) at SDXL's shapes; M = 100 checks the masked row tail.  Bound
    1e-2·max|ref| for the bf16 output and the bf16 rounding of h."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    hg = torch.randn(m, 2 * k, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(n, k, device=dev, generator=g) * k ** -0.5).to(
        torch.bfloat16)
    out = tgg.geglu_matmul(hg, w).float()
    ref = tgg.geglu_matmul_plain(hg.float(), w.float())
    assert out.shape == (m, n)
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8192, 1280, 320), (2048, 2560, 640),
                                   (512, 5120, 1280), (128, 5120, 1280)])
def test_geglu_kernel_at_the_gligen_fuser_shapes_on_card(m, k, n):
    """geglu_matmul at the four shapes of the GLIGEN fusers' FF in the
    SD1.5 UNet at 512 px (CFG batch 2; N = 320 is one cluster block), as
    planned, against its plain version: 1e-2·max|ref|."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(m + n)
    hg = torch.randn(m, 2 * k, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(n, k, device=dev, generator=g) * k ** -0.5).to(
        torch.bfloat16)
    before = tgg.geglu_launches
    out = tgg.geglu_matmul(hg, w).float()
    ref = tgg.geglu_matmul_plain(hg.float(), w.float())
    torch.cuda.synchronize()
    assert tgg.geglu_launches == before + 1
    assert out.shape == (m, n)
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [320, 960, 1920])
@pytest.mark.parametrize("splits", [None, 2])
def test_geglu_kernel_every_cluster_width_ragged_rows_on_card(monkeypatch, n,
                                                             splits):
    """Cluster sizes 2, 6 and 12 (N = 320, 960, 1920; 12 a non-portable
    cluster) at M = 100 (a masked row tail) with K = 1280 (a ragged last
    chunk past N = 960), planned and forced to 2 splits: within
    1e-2·max|ref| of the plain version, the split counters left zero."""
    dev = _card()
    m, k = 100, 1280
    g = torch.Generator(device=dev).manual_seed(n)
    hg = torch.randn(m, 2 * k, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(n, k, device=dev, generator=g) * k ** -0.5).to(
        torch.bfloat16)
    chunks = -(-k // tgg.geglu_chunk(n))
    if splits is not None:
        forced = splits if chunks % splits == 0 else chunks
        monkeypatch.setattr(tgg, "geglu_launch_plan",
                            lambda *a: (n // 160, 128, forced))
    out = tgg.geglu_matmul(hg, w).float()
    torch.cuda.synchronize()
    ref = tgg.geglu_matmul_plain(hg.float(), w.float())
    assert out.shape == (m, n)
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()
    counters = tgg._split_counters.get(hg.device)
    assert counters is None or not counters.any()


@pytest.mark.cuda
def test_plain_path_launches_nothing():
    """An SDXL-shaped transformer block in bf16 on the card launches flash,
    geglu_matmul and the cross-attention kernel once each, and inside
    plain_path() no kernel at all (counters unchanged)."""
    dev = _card()
    block = tl.BasicTransformerBlock(640, 10, 64, 2048).to(dev, torch.bfloat16)
    x = torch.randn(2, 4096, 640, device=dev, dtype=torch.bfloat16)
    ctx = torch.randn(2, 77, 2048, device=dev, dtype=torch.bfloat16)

    def counts():
        return (tfa.launches, tgg.ff_launches, tgg.geglu_launches,
                tat.launches_cross)

    before = counts()
    with torch.no_grad():
        fast = block(x, ctx)
        mid = counts()
        with tl.plain_path():
            plain = block(x, ctx)
    torch.cuda.synchronize()
    assert mid == (before[0] + 1, before[1], before[2] + 1, before[3] + 1)
    assert counts() == mid
    rel = (fast.float() - plain.float()).abs().max() / plain.float().abs().max()
    assert rel <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(8192, 320), (2048, 640), (512, 1280),
                                 (128, 1280), (100, 320)])
def test_ff_kernel_matches_plain_on_card(m, d):
    """Kernel vs plain (fp32 from the same bf16 inputs); the M=100 case
    checks the masked row tail.  Bound 1e-2·max|ref| for the bf16 output
    and the bf16 rounding of h."""
    dev = _card()
    k = 4 * d
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(
            torch.bfloat16)

    x, w1, b1, w2 = (rnd(m, d), rnd(2 * k, d, scale=d ** -0.5),
                     rnd(2 * k, scale=0.1), rnd(d, k, scale=k ** -0.5))
    out = tgg.ff_matmul(x, w1, b1, w2).float()
    ref = tgg.ff_matmul_plain(x.float(), w1.float(), b1.float(), w2.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


# the dialogue waves' batches (a turn's characters or final passes under
# CFG: batch 4, 6 or 8) at the SD1.5 IP UNet's levels, as chip_smoke.py's
# batch_shapes_phase checks them
WAVE_BATCH_FLASH = [(b, s, d) for b in (4, 6, 8)
                    for s, d in ((4096, 40), (1024, 80))]
WAVE_BATCH_FF = [(b * (64 >> level) ** 2, d)
                 for b in (4, 6, 8)
                 for level, d in enumerate((320, 640, 1280))
                 if tgg.ff_supported(b * (64 >> level) ** 2, d, 4 * d)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d", WAVE_BATCH_FLASH)
def test_flash_kernel_at_wave_batches_on_card(b, s, d):
    """Row 1 (the packed route) at the waves' batches, 8 heads; bound
    1e-2·max|ref| for the bf16 output, as at batch 2."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(b)
    q, k, v = (torch.randn(b, s, 8, d, device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    n0 = tfa.launches
    out = tfa.flash_attention(q, k, v, route="packed").float()
    torch.cuda.synchronize()
    assert tfa.launches == n0 + 1
    ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", WAVE_BATCH_FF)
def test_ff_kernel_at_wave_batches_on_card(m, d):
    """Row 6 at M = B·(64 >> level)², K = 4D, wherever ``ff_supported``
    admits the shape; bound 1e-2·max|ref| as at batch 2."""
    dev = _card()
    k = 4 * d
    g = torch.Generator(device=dev).manual_seed(m + d)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(
            torch.bfloat16)

    x, w1, b1, w2 = (rnd(m, d), rnd(2 * k, d, scale=d ** -0.5),
                     rnd(2 * k, scale=0.1), rnd(d, k, scale=k ** -0.5))
    n0 = tgg.ff_launches
    out = tgg.ff_matmul(x, w1, b1, w2).float()
    torch.cuda.synchronize()
    assert tgg.ff_launches == n0 + 1
    ref = tgg.ff_matmul_plain(x.float(), w1.float(), b1.float(), w2.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
def test_ff_split_reduce_is_deterministic_and_resets_its_counters():
    """At the mid block's shape (M = 128: one row block, its chunks split
    over ff_plan's splits) repeated calls give bit-identical outputs, and
    the per-CTA split counters are zero after each call, ready for the
    next."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    m, d, k = 128, 1280, 5120
    x = torch.randn(m, d, device=dev, generator=g).to(torch.bfloat16)
    w1 = (torch.randn(2 * k, d, device=dev, generator=g) * d ** -0.5).to(
        torch.bfloat16)
    b1 = torch.zeros(2 * k, device=dev, dtype=torch.bfloat16)
    w2 = (torch.randn(d, k, device=dev, generator=g) * k ** -0.5).to(
        torch.bfloat16)
    first = tgg.ff_matmul(x, w1, b1, w2)
    for _ in range(5):
        assert torch.equal(tgg.ff_matmul(x, w1, b1, w2), first)
        assert not tgg._split_counters[x.device].any()


def _ragged_multiwave_m(dev, d: int) -> int:
    """The smallest M (not a multiple of the 128-row block) whose planned
    launch at width D splits its chunks and needs more than one wave of
    the card's CTA slots."""
    slots = tgg._ff_slots(dev, d)
    for m in range(129, 1 << 15, 37):
        c, bm, splits = tgg.ff_plan(m, d, 4 * d, slots)
        if m % bm and splits > 1 and -(-m // bm) * c * splits > slots:
            return m
    raise AssertionError(f"no ragged multi-wave split plan at D={d}")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [320, 640, 1280])
def test_ff_ragged_multiwave_splits_on_card(d):
    """At every width, a ragged M whose plan splits the chunks over more
    than one wave: within 1e-2·max|ref| of the plain version, two calls
    bit-identical (split-order sums), the split counters left zero."""
    dev = _card()
    x_dev = torch.empty(0, device=dev).device
    m, k = _ragged_multiwave_m(x_dev, d), 4 * d
    g = torch.Generator(device=dev).manual_seed(m)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=g) * scale).to(
            torch.bfloat16)

    x, w1, b1, w2 = (rnd(m, d), rnd(2 * k, d, scale=d ** -0.5),
                     rnd(2 * k, scale=0.1), rnd(d, k, scale=k ** -0.5))
    first = tgg.ff_matmul(x, w1, b1, w2)
    second = tgg.ff_matmul(x, w1, b1, w2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert not tgg._split_counters[x_dev].any()
    ref = tgg.ff_matmul_plain(x.float(), w1.float(), b1.float(), w2.float())
    assert (first.float() - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_flash_kernel_every_head_dim_strided_ragged_sq_ne_sk(d):
    """Each head dim with strided q, k, v views (q from a [B, S, 3, H, d]
    projection, k and v from a [B, S, 2, H, d] one), Sq = 300 against
    Sk = 1000 (tails of both the 128-row q block and the K/V tile):
    kernel vs plain, 1e-2·max|ref|."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn(2, 300, 3, 4, d, device=dev, generator=g,
                    dtype=torch.bfloat16)[:, :, 1]
    k, v = torch.randn(2, 1000, 2, 4, d, device=dev, generator=g,
                       dtype=torch.bfloat16).unbind(2)
    assert not (q.is_contiguous() or k.is_contiguous())
    out = tfa.flash_attention(q, k, v, route="copy").float()
    ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert out.shape == (2, 300, 4, d)
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Both wrappers raise (and launch nothing) on a width, head dim, inner
    width, dtype, stride or alignment their kernels do not take."""
    dev = _card()
    bf = dict(device=dev, dtype=torch.bfloat16)
    n0 = (tgg.ff_launches, tfa.launches, tfa.launches_copy)
    x = torch.randn(64, 384, **bf)
    with pytest.raises(ValueError):  # no D = 384 instance
        tgg.ff_matmul(x, torch.randn(3072, 384, **bf),
                      torch.randn(3072, **bf), torch.randn(384, 1536, **bf))
    x = torch.randn(64, 320, **bf)
    with pytest.raises(ValueError):  # K not a multiple of the chunk
        tgg.ff_matmul(x, torch.randn(2000, 320, **bf),
                      torch.randn(2000, **bf), torch.randn(320, 1000, **bf))
    w1 = torch.randn(2560 * 320 + 1, **bf)[1:].view(2560, 320)
    with pytest.raises(ValueError):  # W1 not 16-byte aligned
        tgg.ff_matmul(x, w1, torch.randn(2560, **bf),
                      torch.randn(320, 1280, **bf))
    with pytest.raises(TypeError):  # fp32 activations
        tgg.ff_matmul(x.float(), torch.randn(2560, 320, **bf),
                      torch.randn(2560, **bf), torch.randn(320, 1280, **bf))
    q = torch.randn(1, 256, 2, 48, **bf)
    with pytest.raises(ValueError):  # no d = 48 instance
        tfa.flash_attention(q, q, q)
    qkv = torch.randn(1, 256, 2 * 40 + 4, **bf)
    q = qkv[..., 4:].view(1, 256, 2, 40)
    with pytest.raises(ValueError):  # base not 16-byte aligned
        tfa.flash_attention(q, q, q, route="copy")
    with pytest.raises(TypeError):
        q = torch.randn(1, 256, 2, 40, device=dev)
        tfa.flash_attention(q, q, q)
    assert (tgg.ff_launches, tfa.launches, tfa.launches_copy) == n0


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views_and_masks_the_tail():
    """q, k, v as strided views of one QKV tensor, S = 1000 (not a multiple
    of the 128-row q block or the 128-key tile): same bound as above."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn(1, 1000, 3, 4, 40, device=dev, generator=g,
                      dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)
    out = tfa.flash_attention(q, k, v).float()
    ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
def test_launch_counters_count_each_kernel_launch():
    dev = _card()
    fa0, ff0, gg0 = tfa.launches, tgg.ff_launches, tgg.geglu_launches
    q = torch.randn(1, 1024, 2, 40, device=dev, dtype=torch.bfloat16)
    tfa.flash_attention(q, q, q)
    tfa.flash_attention_plain(q, q, q)
    x = torch.randn(64, 320, device=dev, dtype=torch.bfloat16)
    w1 = torch.randn(2560, 320, device=dev, dtype=torch.bfloat16)
    b1 = torch.zeros(2560, device=dev, dtype=torch.bfloat16)
    w2 = torch.randn(320, 1280, device=dev, dtype=torch.bfloat16)
    tgg.ff_matmul(x, w1, b1, w2)
    tgg.ff_matmul_plain(x, w1, b1, w2)
    hg = torch.randn(64, 2560, device=dev, dtype=torch.bfloat16)
    w = torch.randn(640, 1280, device=dev, dtype=torch.bfloat16)
    tgg.geglu_matmul(hg, w)
    tgg.geglu_matmul_plain(hg, w)
    torch.cuda.synchronize()
    assert (tfa.launches - fa0, tgg.ff_launches - ff0,
            tgg.geglu_launches - gg0) == (1, 1, 1)


@pytest.mark.cuda
def test_layers_raise_in_the_domain_without_a_kernel_instance():
    """A bf16 self-attention in the flash domain with a head dim the kernel
    has no instance for (48), a fused bf16 FF of an uncompiled width, and
    an unfused bf16 FF whose width the geglu_matmul tile does not divide
    (192), each at 128 rows (inside the JAX FF gates), raise on the card
    instead of running the plain path."""
    dev = _card()
    attn = tl.CrossAttention(96, 2, 48).to(dev, torch.bfloat16)
    with pytest.raises(ValueError):
        attn(torch.randn(1, 1024, 96, device=dev, dtype=torch.bfloat16))
    ff = tl.FeedForward(32, fused_ff=True).to(dev, torch.bfloat16)
    with pytest.raises(ValueError):
        ff(torch.randn(1, 128, 32, device=dev, dtype=torch.bfloat16))
    ff = tl.FeedForward(192, fused_ff=False).to(dev, torch.bfloat16)
    with pytest.raises(ValueError):
        ff(torch.randn(1, 128, 192, device=dev, dtype=torch.bfloat16))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take():
    """No silent fallback or downcast on the card: fp32 and unsupported
    shapes raise."""
    dev = _card()
    q = torch.randn(1, 1024, 2, 40, device=dev)
    with pytest.raises(TypeError):
        tfa.flash_attention(q, q, q)
    with pytest.raises(TypeError):
        tgg.ff_matmul(q[0, :, 0], torch.randn(2560, 40, device=dev),
                      torch.zeros(2560, device=dev),
                      torch.randn(40, 1280, device=dev))
    qb = torch.randn(1, 1024, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention(qb, qb, qb)
    x = torch.randn(8, 32, device=dev, dtype=torch.bfloat16)
    w = torch.randn(256, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tgg.ff_matmul(x, w, torch.zeros(256, device=dev,
                                        dtype=torch.bfloat16),
                      torch.randn(32, 128, device=dev, dtype=torch.bfloat16))
    hg = torch.randn(8, 2560, device=dev)
    with pytest.raises(TypeError):
        tgg.geglu_matmul(hg, torch.randn(640, 1280, device=dev))
    hg = hg.to(torch.bfloat16)
    # N not a multiple of the tile, K % 32 != 0, hg width != 2K
    for width, n, k in ((2560, 192, 1280), (2576, 640, 1288),
                        (2560, 640, 1024)):
        with pytest.raises(ValueError):
            tgg.geglu_matmul(hg.new_zeros(8, width), hg.new_zeros(n, k))


def _group_norm_uncentred(x, w, b, act, groups=32, eps=1e-5):
    """GroupNorm with the variance taken as E[x²] - mean² in fp32: the
    shortcut the kernel must not take."""
    xf = x.float().reshape(x.shape[0], groups, -1)
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0)
    out = ((xf - mean) * torch.rsqrt(var + eps)).reshape(
        x.shape[0], x.shape[1], -1)
    out = out * w.float()[:, None] + b.float()[:, None]
    return (torch.nn.functional.silu(out) if act else out).reshape(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("cpg,hw", [(10, 4096), (30, 4096), (80, 64)])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("offset", [0.0, 1024.0])
def test_group_norm_kernel_matches_plain_on_card(cpg, hw, act, offset):
    """Kernel vs plain (fp32 from the same bf16 inputs) at C/G = 10, 30, 80
    (SD1.5's 320/960/2560 channels, 32 groups, CFG batch 2), with and
    without SiLU, and with a group mean of 1024 against a std of 1.5
    (rounded to bf16's step of 4 to 8 there: a few distinct values, mean/
    std ~ 700); bound 1e-2·max|ref| for the bf16 output.  At that mean the
    variance taken as E[x²] - mean² in fp32 misses the same bound, so the
    check holds the kernel to the centred variance."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(cpg)
    c = 32 * cpg
    side = int(hw ** 0.5)
    x = (torch.randn(2, c, side, side, device=dev, generator=g)
         * (1.5 if offset else 1.0) + offset).to(torch.bfloat16)
    w = (1.0 + 0.2 * torch.randn(c, device=dev, generator=g)).to(
        torch.bfloat16)
    b = (0.1 * torch.randn(c, device=dev, generator=g)).to(torch.bfloat16)
    out = tgn.fused_group_norm(x, w, b, act=act).float()
    ref = tgn.fused_group_norm_plain(x.float(), w.float(), b.float(), act=act)
    bound = 1e-2 * ref.abs().max()
    assert out.shape == x.shape
    assert (out - ref).abs().max() <= bound
    if offset:
        assert x.unique().numel() >= 3
        unc = _group_norm_uncentred(x, w, b, act)
        assert (unc - ref).abs().max() > bound


@pytest.mark.cuda
def test_group_norm_wrapper_refuses_what_the_kernel_does_not_take():
    """fp32 input, a non-contiguous view, fp32 weights and a shape outside
    the gate raise on the card; one launch is counted per kernel call and
    none for the plain version."""
    dev = _card()
    x = torch.randn(2, 320, 64, 64, device=dev)
    w = torch.ones(320, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tgn.fused_group_norm(x, w, w)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError):
        tgn.fused_group_norm(xb.transpose(2, 3), w, w)
    with pytest.raises(ValueError):
        tgn.fused_group_norm(xb, w.float(), w.float())
    with pytest.raises(ValueError):
        tgn.fused_group_norm(xb[:, :, :3, :3].contiguous(), w, w)
    n0 = tgn.launches
    tgn.fused_group_norm(xb, w, w, act="silu")
    tgn.fused_group_norm_plain(xb, w, w, act="silu")
    torch.cuda.synchronize()
    assert tgn.launches - n0 == 1


@pytest.mark.cuda
def test_plain_path_launches_no_group_norm(monkeypatch):
    """With the switch at "1" a bf16 ResnetBlock2D at SD1.5's 64² shape
    launches the GroupNorm kernel twice, and inside plain_path() not at
    all; the two agree within 2e-2 relative (the kernel rounds once,
    after the SiLU)."""
    dev = _card()
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    block = tl.ResnetBlock2D(320, 320, 1280, fast_norm=True).to(
        dev, torch.bfloat16)
    x = torch.randn(2, 320, 64, 64, device=dev, dtype=torch.bfloat16)
    temb = torch.randn(2, 1280, device=dev, dtype=torch.bfloat16)
    n0 = tgn.launches
    with torch.no_grad():
        fast = block(x, temb)
        mid = tgn.launches
        with tl.plain_path():
            plain = block(x, temb)
    torch.cuda.synchronize()
    assert (mid - n0, tgn.launches - mid) == (2, 0)
    rel = (fast.float() - plain.float()).abs().max() / plain.float().abs().max()
    assert rel <= 2e-2


def _gn_inputs(dev, b, c, h, w, seed, mean=0.0, std=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, c, h, w, device=dev, generator=g) * std
         + mean).to(torch.bfloat16)
    scale = (1.0 + 0.2 * torch.randn(c, device=dev, generator=g)).to(
        torch.bfloat16)
    bias = (0.1 * torch.randn(c, device=dev, generator=g)).to(torch.bfloat16)
    return x, scale, bias


def _gn_forced_plan(c, hw, cluster, threads=256, chunks=4):
    """A plan of the given cluster size and width; chunks = 0 keeps the
    shares in registers."""
    pieces = tgn.gn_pieces(c, hw, 32)
    share = -(-pieces // cluster)
    chunks = min(chunks, share)
    return tgn.GnPlan(cluster, threads, share, chunks,
                      tgn.gn_smem(share, c, hw, 32, chunks))


# (C, H, W): a small group (8²×2560, 10 KB), a 64²×320 one (80 KB), and an
# uneven one (27·152 = 4104 values a channel: 5130 pieces a slice, so 2,
# 4 and 8 CTAs get shares of 2565; 1283 and 1281; 642 and 636)
GN_FORCED = [(2560, 8, 8), (320, 64, 64), (320, 27, 152)]


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w", GN_FORCED)
@pytest.mark.parametrize("b", [1, 4])
def test_group_norm_forced_cluster_sizes_on_card(monkeypatch, c, h, w, b):
    """Every cluster size (1, 2, 4, 8), each at 128 and 256 threads, the
    shares in shared memory and, where they fit, in registers, with and
    without SiLU, at a mean of 0 and of 1024 (std 1.5): within
    1e-2·max|ref| of the plain version, so the CTAs of a slice combine
    their statistics into one centred variance, uneven shares included."""
    dev = _card()
    for mean, std in ((0.0, 1.0), (1024.0, 1.5)):
        x, scale, bias = _gn_inputs(dev, b, c, h, w, c + b, mean, std)
        for act in (None, "silu"):
            ref = tgn.fused_group_norm_plain(x.float(), scale.float(),
                                             bias.float(), act=act)
            bound = 1e-2 * ref.abs().max()
            plans = [_gn_forced_plan(c, h * w, cluster, threads, chunks)
                     for cluster in (1, 2, 4, 8) for threads in (128, 256)
                     for chunks in (4, 0)]
            for plan in plans:
                if (plan.chunks == 0
                        and plan.share > plan.threads * tgn.GN_REG_PIECES):
                    continue
                monkeypatch.setattr(tgn, "launch_plan",
                                    lambda *a, p=plan: p)
                out = tgn.fused_group_norm(x, scale, bias, act=act)
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max()
                assert err <= bound, (plan, mean, act, float(err))


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw", [(320, 16384), (1280, 64), (2560, 144),
                                  (640, 2304), (32, 8), (20480, 256)])
def test_group_norm_planned_launch_at_every_batch_on_card(c, hw):
    """The planner's launch at B = 1 to 8, from the largest slice the
    gate admits (10 channels × 16384, 320 KB) to a one-piece one: within
    1e-2·max|ref| of the plain version, and one launch a call."""
    dev = _card()
    side = int(hw ** 0.5)
    h, w = (side, hw // side) if side * side == hw else (1, hw)
    for b in range(1, 9):
        x, scale, bias = _gn_inputs(dev, b, c, h, w, b * 7 + c, 1024.0, 1.5)
        n0 = tgn.launches
        out = tgn.fused_group_norm(x, scale, bias, act="silu")
        torch.cuda.synchronize()
        assert tgn.launches - n0 == 1
        ref = tgn.fused_group_norm_plain(x.float(), scale.float(),
                                         bias.float(), act="silu")
        err = (out.float() - ref).abs().max()
        assert err <= 1e-2 * ref.abs().max(), (b, tgn.launch_plan(
            b, c, hw, 32), float(err))


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [8, 16])
def test_group_norm_other_group_counts_on_card(groups):
    """8 and 16 groups (slices of 4 and 2 times the size, up to 1.28 MB
    at 64²×1280 with 8 groups: eight CTAs of 160 KB) at mean 1024, std
    1.5: within 1e-2·max|ref| of the plain version."""
    dev = _card()
    for c, h in ((1280, 8), (320, 64), (1280, 64)):
        x, scale, bias = _gn_inputs(dev, 2, c, h, h, c + h, 1024.0, 1.5)
        out = tgn.fused_group_norm(x, scale, bias, num_groups=groups,
                                   act="silu")
        ref = tgn.fused_group_norm_plain(x.float(), scale.float(),
                                         bias.float(), num_groups=groups,
                                         act="silu")
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max()
        assert err <= 1e-2 * ref.abs().max(), (c, h, groups, float(err))


@pytest.mark.cuda
def test_group_norm_wrapper_raises_on_a_plan_the_kernel_cannot_take(
        monkeypatch):
    """A cluster size that is not 1, 2, 4 or 8; a cluster that leaves a
    CTA without a piece; shares that do not cover the slice; too little
    shared memory; 1024 threads; five chunks; a share in registers over
    GN_REG_PIECES a thread: each raises, and no launch is counted."""
    dev = _card()
    x, scale, bias = _gn_inputs(dev, 2, 320, 64, 64, 0)
    good = _gn_forced_plan(320, 4096, 2)
    pieces = tgn.gn_pieces(320, 4096, 32)
    bad = [good._replace(cluster=3), good._replace(cluster=16),
           tgn.GnPlan(8, 256, pieces // 6, 4, 16 * pieces),
           good._replace(share=good.share - 1),
           good._replace(smem=16 * good.share),
           good._replace(threads=1024), good._replace(threads=100),
           good._replace(chunks=5),
           good._replace(chunks=0, threads=64)]
    n0 = tgn.launches
    for plan in bad:
        monkeypatch.setattr(tgn, "launch_plan", lambda *a, p=plan: p)
        with pytest.raises(RuntimeError):
            tgn.fused_group_norm(x, scale, bias)
    assert tgn.launches == n0
    monkeypatch.setattr(tgn, "launch_plan", lambda *a: good)
    tgn.fused_group_norm(x, scale, bias)
    torch.cuda.synchronize()
    assert tgn.launches == n0 + 1


# (M, K, N) of the SD1.5 W8A8 UNet's quant_matmul calls (CFG batch 2)
QMM_PATH_SHAPES = [
    (8192, 320, 320), (154, 768, 320), (8192, 320, 2560), (8192, 1280, 320),
    (2048, 640, 640), (154, 768, 640), (2048, 640, 5120), (2048, 2560, 640),
    (512, 1280, 1280), (154, 768, 1280), (512, 1280, 10240),
    (512, 5120, 1280), (128, 1280, 1280), (128, 1280, 10240),
    (128, 5120, 1280), (2, 320, 1280), (2, 1280, 1280), (2, 1280, 640),
    (2, 1280, 320)]


def _qmm_inputs(dev, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    w = torch.randn(n, k, device=dev, generator=g) * k ** -0.5
    wq, ws = tq.quantize_linear_weight(w)
    bias = (0.1 * torch.randn(n, device=dev, generator=g)).to(torch.bfloat16)
    return x, wq, ws, bias


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QMM_PATH_SHAPES + [(40, 128, 130),
                                                    (100, 320, 2560)])
def test_quant_matmul_kernel_matches_plain_on_card(m, k, n):
    """The kernel vs its plain version from the same bf16 inputs, at every
    shape of the path and two ragged ones (M = 40 and 100, N = 130), with
    and without bias.  Each step is the same IEEE fp32 operation in the
    same order and the int32 sum is exact, so the outputs are equal bit
    for bit (the chip_smoke.py gate, 1e-2·max|ref|, is far looser)."""
    dev = _card()
    x, wq, ws, bias = _qmm_inputs(dev, m, k, n, m + n)
    for b in (bias, None):
        out = tqm.quant_matmul(x, wq, ws, b)
        ref = tqm.quant_matmul_plain(x, wq, ws, b)
        torch.cuda.synchronize()
        assert out.shape == (m, n) and out.dtype == torch.bfloat16
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


# (M, K, N) of the W8A8 SDXL UNet's quant_matmul calls at 1024 px (CFG
# batch 2): 8 shapes SD1.5 does not have and its four M = 2 ones
QMM_XL_SHAPES = [
    (8192, 640, 640), (154, 2048, 640), (8192, 640, 5120), (8192, 2560, 640),
    (2048, 1280, 1280), (154, 2048, 1280), (2048, 1280, 10240),
    (2048, 5120, 1280), (2, 320, 1280), (2, 1280, 1280), (2, 1280, 640),
    (2, 1280, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QMM_XL_SHAPES)
def test_quant_matmul_kernel_at_the_sdxl_shapes_on_card(m, k, n):
    """The kernel at every shape of the W8A8 SDXL UNet (N up to 10240, K
    2048 and 5120), with and without bias, equal to its plain version bit
    for bit, as at SD1.5's shapes."""
    dev = _card()
    x, wq, ws, bias = _qmm_inputs(dev, m, k, n, m + n + k)
    for b in (bias, None):
        out = tqm.quant_matmul(x, wq, ws, b)
        ref = tqm.quant_matmul_plain(x, wq, ws, b)
        torch.cuda.synchronize()
        assert out.shape == (m, n) and out.dtype == torch.bfloat16
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


# the row-parallel calls of one tp = 2 rank of the W8A8 UNet (to_out.0 and
# ff.net.2 with half their K) and a ragged one
QMM_ROW_AMAX_SHAPES = [(8192, 160, 320), (8192, 640, 320), (2048, 320, 640),
                       (512, 2560, 1280), (128, 640, 1280), (40, 128, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", QMM_ROW_AMAX_SHAPES)
def test_quant_matmul_row_amax_matches_plain_on_card(monkeypatch, m, k, n):
    """With ``row_amax`` (each row's max|x| over the whole K, at least its
    own; all-reduced by a row-parallel layer) the kernel scales each row
    by it, bit for bit as the plain version does, at the planned launch
    and at one CTA unsplit; it differs from the call that takes the
    row's own max."""
    dev = _card()
    x, wq, ws, _ = _qmm_inputs(dev, m, k, n, 5 * m + n)
    g = torch.Generator(device=dev).manual_seed(m)
    amax = torch.maximum(x.abs().amax(-1), 4 * torch.rand(
        m, device=dev, generator=g).to(torch.bfloat16)).float()
    ref = tqm.quant_matmul_plain(x, wq, ws, None, amax)
    out = tqm.quant_matmul(x, wq, ws, None, amax)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), int((out != ref).sum())
    assert not torch.equal(out, tqm.quant_matmul(x, wq, ws))
    monkeypatch.setattr(tqm, "launch_plan", lambda *a: (1, 128, 160, 1))
    out = tqm.quant_matmul(x, wq, ws, None, amax)
    torch.cuda.synchronize()
    assert torch.equal(out, ref), int((out != ref).sum())
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, wq, ws, None, amax[:-1])


def _forced_qmm_plans(m, k, n):
    """Split counts 1, 2 and the largest at the planned cluster size, and
    a cluster of 1 unsplit and at the largest split count."""
    _, nt, steps = tqm.qmm_tiles(m, n, k)
    c = next(c for c in tqm.QMM_CLUSTERS if nt % c == 0)
    splits = sorted({1, steps} | ({2} if steps % 2 == 0 else set()))
    return ([(c, 128, 160, s) for s in splits]
            + [(1, 128, 160, 1), (1, 128, 160, steps)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(512, 1280, 1280), (154, 768, 640),
                                   (2, 1280, 320), (100, 320, 2560),
                                   (40, 128, 130)])
def test_quant_matmul_forced_plans_bit_equal_on_card(monkeypatch, m, k, n):
    """Whatever the launch (split counts 1, 2 and the largest, the
    cluster shrunk to one CTA), the kernel equals its plain version bit
    for bit: the int32 split sums are exact in any order and every CTA of
    a cluster quantises with the same row scales; the split counters are
    left zero."""
    dev = _card()
    x, wq, ws, bias = _qmm_inputs(dev, m, k, n, 3 * m + n)
    ref = tqm.quant_matmul_plain(x, wq, ws, bias)
    for plan in _forced_qmm_plans(m, k, n):
        monkeypatch.setattr(tqm, "launch_plan", lambda *a, p=plan: p)
        out = tqm.quant_matmul(x, wq, ws, bias)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (plan, int((out != ref).sum()))
        counters = tqm._split_counters.get(x.device)
        assert counters is None or not counters.any()


@pytest.mark.cuda
def test_quant_matmul_wrapper_refuses_what_the_kernel_does_not_take():
    """K % 32 != 0, a weight that is not int8 or not contiguous, fp32
    scales in the wrong shape and fp32 activations raise on the card; one
    launch is counted per kernel call and none for the plain version."""
    dev = _card()
    x, wq, ws, bias = _qmm_inputs(dev, 64, 320, 256, 0)
    with pytest.raises(ValueError):
        tqm.quant_matmul(x[:, :304], wq[:, :304].contiguous(), ws)
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, wq.float(), ws)
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, wq.t().contiguous().t(), ws)
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, wq, ws[:128])
    with pytest.raises(TypeError):
        tqm.quant_matmul(x.float(), wq, ws)
    n0 = tqm.launches
    tqm.quant_matmul(x, wq, ws, bias)
    tqm.quant_matmul_plain(x, wq, ws, bias)
    torch.cuda.synchronize()
    assert tqm.launches - n0 == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(2, 1280, 320), (154, 768, 640),
                                   (8192, 320, 2560), (512, 5120, 1280)])
def test_per_tensor_int8_product_exact_on_card(m, k, n):
    """The "0" route's int8 product (torch._int_mm, zero rows padding
    M <= 16) equals the float64 product of the same int8 values exactly."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(m)
    xq = torch.randint(-127, 128, (m, k), device=dev, generator=g,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                       dtype=torch.int8)
    got = tq.int8_matmul(xq, wq)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.double(), xq.double() @ wq.double().t())


@pytest.mark.cuda
def test_quantized_block_launches_quant_matmul_and_plain_path_none(
        monkeypatch):
    """A quantized SD1.5 transformer block (64², 320 channels, CFG batch
    2) in bf16 at "1" launches quant_matmul 10 times and flash once, and
    inside plain_path() neither; at "0" no quant_matmul.  Kernels vs plain
    within 2e-2 relative (bf16 activations between the layers)."""
    dev = _card()
    monkeypatch.setattr(tq, "FUSED_MODE", "1")
    block = tl.BasicTransformerBlock(320, 8, 40, 768, quantized=True).to(
        dev, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(5)
    for mod in block.modules():
        if isinstance(mod, tl.QuantLinear):
            mod.set_float_weight(torch.randn(
                mod.weight.shape, device=dev, generator=g)
                * mod.in_features ** -0.5)
    x = torch.randn(2, 4096, 320, device=dev, dtype=torch.bfloat16)
    ctx = torch.randn(2, 77, 768, device=dev, dtype=torch.bfloat16)

    def counts():
        return tqm.launches, tfa.launches

    n0 = counts()
    with torch.no_grad():
        fast = block(x, ctx)
        mid = counts()
        with tl.plain_path():
            plain = block(x, ctx)
        assert counts() == mid
        monkeypatch.setattr(tq, "FUSED_MODE", "0")
        block(x, ctx)
    torch.cuda.synchronize()
    assert (mid[0] - n0[0], mid[1] - n0[1]) == (10, 1)
    assert counts()[0] == mid[0]
    rel = (fast.float() - plain.float()).abs().max() / plain.float().abs().max()
    assert rel <= 2e-2


@pytest.mark.cuda
def test_division_by_127_is_ieee_on_card():
    """div127 rounds t / 127 correctly on the card (as the kernel's
    __fdiv_rn and jnp do): equal to the float64 quotient rounded to fp32."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(9)
    x = torch.rand(1 << 20, device=dev, generator=g) * 100.0
    assert torch.equal(tqm.div127(x), (x.double() / 127.0).float())


# ---------------------------------------------------------------------------
# batch 1 (the CFG cutoff's tail, LCM) and DeepCache's shallow evaluation
# ---------------------------------------------------------------------------

def _chip_smoke():
    """chip_smoke.py as a module, for its launch derivation."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(4096, 40), (1024, 80)])
def test_flash_kernel_batch_one_on_card(s, d):
    """SD1.5's flash shapes at batch 1 (8 heads); bound 1e-2·max|ref|."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(21)
    q, k, v = (torch.randn(1, s, 8, d, device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    out = tfa.flash_attention(q, k, v).float()
    ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(4096, 320), (1024, 640), (256, 1280)])
def test_ff_kernel_batch_one_on_card(m, d):
    """SD1.5's FF rows at batch 1 (levels 0-2; the mid block's 64 rows
    take no kernel); bound 1e-2·max|ref|."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(22)
    k = 4 * d
    x = torch.randn(m, d, device=dev, generator=g).bfloat16()
    w1 = (torch.randn(2 * k, d, device=dev, generator=g) * d ** -0.5).bfloat16()
    b1 = (torch.randn(2 * k, device=dev, generator=g) * 0.1).bfloat16()
    w2 = (torch.randn(d, k, device=dev, generator=g) * k ** -0.5).bfloat16()
    assert tgg.ff_supported(m, d, k) and not tgg.ff_supported(64, 1280, 5120)
    out = tgg.ff_matmul(x, w1, b1, w2).float()
    ref = tgg.ff_matmul_plain(x.float(), w1.float(), b1.float(), w2.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 2560, 640), (1024, 5120, 1280)])
def test_geglu_kernel_batch_one_on_card(m, k, n):
    """SDXL's geglu_matmul rows at batch 1 (LCM); bound 1e-2·max|ref|."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(23)
    hg = torch.randn(m, 2 * k, device=dev, generator=g).bfloat16()
    w = (torch.randn(n, k, device=dev, generator=g) * k ** -0.5).bfloat16()
    out = tgg.geglu_matmul(hg, w).float()
    ref = tgg.geglu_matmul_plain(hg.float(), w.float())
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw", [(320, 4096), (960, 4096), (640, 1024),
                                  (1920, 1024), (1280, 256), (2560, 64)])
def test_group_norm_batch_one_sites_on_card(c, hw):
    """SD1.5 GroupNorm sites at batch 1 (32 slices), SiLU on; bound
    1e-2·max|ref|."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(24)
    s = int(hw ** 0.5)
    x = torch.randn(1, c, s, s, device=dev, generator=g).bfloat16()
    w = (1 + 0.2 * torch.randn(c, device=dev, generator=g)).bfloat16()
    b = (0.1 * torch.randn(c, device=dev, generator=g)).bfloat16()
    out = tgn.fused_group_norm(x, w, b, act="silu").float()
    ref = tgn.fused_group_norm_plain(x.float(), w.float(), b.float(),
                                     act="silu")
    assert (out - ref).abs().max() <= 1e-2 * ref.abs().max()


@pytest.fixture(scope="module")
def sd15_bundle():
    _card()
    from theatergen_tpu_torch.config import sd15_config
    from theatergen_tpu_torch.pipelines.bundle import init_bundle
    return init_bundle(sd15_config(), 0, with_ip=True)


@pytest.mark.cuda
def test_shallow_ip_unet_evaluation_against_plain_path_on_card(sd15_bundle):
    """The full-size IP UNet's shallow evaluation (DeepCache, the cache of
    a full evaluation at the same inputs) with the kernels against itself
    under plain_path(), 5e-2·max|ref| (bf16 through its blocks, as the
    full evaluation's check in chip_smoke.py), and its launches those
    chip_smoke.eval_launches derives."""
    dev = _card()
    cs = _chip_smoke()
    unet = sd15_bundle.unet_ip
    g = torch.Generator(device=dev).manual_seed(25)
    x = torch.randn(2, 4, 64, 64, device=dev, generator=g)
    t = torch.full((2,), 501, device=dev, dtype=torch.long)
    ctx = torch.randn(2, 81, 768, device=dev, generator=g)
    kw = dict(ip_scale=torch.tensor(0.4, device=dev))
    with torch.no_grad():
        _, cache = unet(x, t, ctx, return_deep_cache=True, **kw)
        cs.reset_counts()
        fast = unet(x, t, ctx, deep_cache=cache, **kw).float()
        torch.cuda.synchronize()
        got = cs.read_counts()
        with tl.plain_path():
            plain = unet(x, t, ctx, deep_cache=cache, **kw).float()
    assert got == cs.counts(**cs.eval_launches(unet.cfg, 64, 2, shallow=True))
    assert (fast - plain).abs().max() <= 5e-2 * plain.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("knob", ["lcm", "deepcache"])
def test_text2img_knob_request_launches_on_card(sd15_bundle, knob):
    """One 4-step LCM request and one 6-step DDIM request with DeepCache
    every 3rd step: an image in [0, 1], and every kernel's launches those
    chip_smoke.request_want derives from the step plan."""
    import dataclasses

    from theatergen_tpu_torch.pipelines import sd as tsd
    cs = _chip_smoke()
    b = sd15_bundle
    if knob == "lcm":
        pipe, plan = tsd.Text2Img(b, 4, sampler="lcm"), cs.step_plan(4, "lcm")
    else:
        b = dataclasses.replace(b, cfg=dataclasses.replace(
            b.cfg, pipeline=dataclasses.replace(b.cfg.pipeline,
                                                deepcache_interval=3)))
        pipe, plan = tsd.Text2Img(b, 6), cs.step_plan(6, deepcache=3)
    cs.reset_counts()
    img = pipe(torch.Generator(device="cuda").manual_seed(1), "a knight")
    torch.cuda.synchronize()
    assert cs.read_counts() == cs.request_want(b.cfg.unet, 64, plan)
    assert torch.isfinite(img).all() and 0 <= img.min() and img.max() <= 1


# ---------------------------------------------------------------------------
# gradients through the kernels (latent guidance): each wrapper's autograd
# Function launches its kernel in the forward and recomputes the plain
# version in the backward, so its input gradients are the plain version's
# bit for bit
# ---------------------------------------------------------------------------


def _grad_gate(wrapper, plain, inputs, needs, counter, **kw):
    """Forward: one launch, within 1e-2·max|ref| of the plain version on
    fp32 copies; backward under one upstream gradient: no launch, the
    gradients equal to those of the plain version on the same bf16
    inputs."""
    leaves = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
    n0 = counter()
    out = wrapper(*leaves, **kw)
    torch.cuda.synchronize()
    assert counter() == n0 + 1 and out.grad_fn is not None
    ref32 = plain(*[x.float() for x in inputs], **kw)
    assert (out.float() - ref32).abs().max() <= 1e-2 * ref32.abs().max()
    g = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(device=out.device).manual_seed(
                        31)).to(out.dtype)
    got = torch.autograd.grad(out, [x for x, n in zip(leaves, needs) if n], g)
    torch.cuda.synchronize()
    assert counter() == n0 + 1
    ref_leaves = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
    want = torch.autograd.grad(plain(*ref_leaves, **kw),
                               [x for x, n in zip(ref_leaves, needs) if n], g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert a.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,d,all_inputs", [
    (4096, 8, 40, False), (1024, 8, 80, False), (4096, 10, 64, False),
    (1024, 8, 80, True)])
def test_flash_gradient_is_the_plain_version_on_card(s, h, d, all_inputs):
    """The guided UNet's batch-1 self-attention (SD1.5 levels 0-1, SDXL
    level 1): the gradient of q (and of k, v) bit for bit."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(32)
    qkv = [torch.randn(1, s, h, d, device=dev, generator=g,
                       dtype=torch.bfloat16) for _ in range(3)]
    _grad_gate(tfa.flash_attention, tfa.flash_attention_plain, qkv,
               [True, all_inputs, all_inputs], lambda: tfa.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,all_inputs", [
    (4096, 320, False), (1024, 640, False), (256, 1280, False),
    (1024, 640, True)])
def test_ff_gradient_is_the_plain_version_on_card(m, d, all_inputs):
    """ff_matmul at the guided SD1.5 UNet's batch-1 rows: the gradient of
    x (and of the weights) bit for bit."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(33)
    k = 4 * d
    ins = [torch.randn(m, d, device=dev, generator=g).bfloat16(),
           (torch.randn(2 * k, d, device=dev, generator=g)
            * d ** -0.5).bfloat16(),
           (torch.randn(2 * k, device=dev, generator=g) * 0.1).bfloat16(),
           (torch.randn(d, k, device=dev, generator=g) * k ** -0.5).bfloat16()]
    _grad_gate(tgg.ff_matmul, tgg.ff_matmul_plain, ins,
               [True] + [all_inputs] * 3, lambda: tgg.ff_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,all_inputs", [
    (4096, 2560, 640, False), (1024, 5120, 1280, False),
    (1024, 5120, 1280, True)])
def test_geglu_gradient_is_the_plain_version_on_card(m, k, n, all_inputs):
    """geglu_matmul at the guided SDXL UNet's batch-1 rows: the gradient
    of hg (and of w) bit for bit."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(34)
    ins = [torch.randn(m, 2 * k, device=dev, generator=g).bfloat16(),
           (torch.randn(n, k, device=dev, generator=g) * k ** -0.5).bfloat16()]
    _grad_gate(tgg.geglu_matmul, tgg.geglu_matmul_plain, ins,
               [True, all_inputs], lambda: tgg.geglu_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw,act,all_inputs", [
    (320, 4096, "silu", False), (1280, 256, None, False),
    (640, 1024, "silu", True)])
def test_group_norm_gradient_is_the_plain_version_on_card(c, hw, act,
                                                          all_inputs):
    """fused_group_norm at guided SD1.5 batch-1 sites, with and without
    SiLU: the gradient of x (and of scale and bias) bit for bit."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(35)
    s = int(hw ** 0.5)
    ins = [torch.randn(1, c, s, s, device=dev, generator=g).bfloat16(),
           (1 + 0.2 * torch.randn(c, device=dev, generator=g)).bfloat16(),
           (0.1 * torch.randn(c, device=dev, generator=g)).bfloat16()]
    _grad_gate(tgn.fused_group_norm, tgn.fused_group_norm_plain, ins,
               [True, all_inputs, all_inputs], lambda: tgn.launches,
               act=act)


@pytest.mark.cuda
def test_quant_matmul_refuses_a_gradient_on_card():
    """quant_matmul has no gradient: a CUDA input that requires grad
    raises before any launch; under no_grad the same call launches."""
    dev = _card()
    x = torch.randn(128, 320, device=dev).bfloat16().requires_grad_(True)
    w_q = torch.randint(-127, 128, (320, 320), dtype=torch.int8, device=dev)
    scale = torch.rand(320, device=dev) + 0.5
    n0 = tqm.launches
    with pytest.raises(RuntimeError, match="no gradient"):
        tqm.quant_matmul(x, w_q, scale)
    assert tqm.launches == n0
    with torch.no_grad():
        out = tqm.quant_matmul(x, w_q, scale)
    torch.cuda.synchronize()
    assert tqm.launches == n0 + 1 and out.grad_fn is None


# the training step's batch-4 shapes (chip_smoke.py::train_path: the SD1.5
# IP UNet at 512 px, no CFG): every input needs a gradient there, the
# weights, scales and biases included
TRAIN_FLASH = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
TRAIN_FF = [(4 * 4096, 320), (4 * 1024, 640), (4 * 256, 1280), (4 * 64, 1280)]
TRAIN_GN = [(c, hw, "silu") for c, hw in (
    (320, 4096), (640, 4096), (960, 4096), (320, 1024), (640, 1024),
    (960, 1024), (1280, 1024), (1920, 1024), (640, 256), (1280, 256),
    (1920, 256), (2560, 256), (1280, 64), (2560, 64))] + [
    (320, 4096, None), (1280, 64, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", TRAIN_FLASH)
def test_flash_gradient_at_the_training_batch_on_card(b, s, h, d):
    """flash_attention at the training step's batch-4 self-attention: the
    gradients of q, k and v bit for bit."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(36)
    qkv = [torch.randn(b, s, h, d, device=dev, generator=g,
                       dtype=torch.bfloat16) for _ in range(3)]
    _grad_gate(tfa.flash_attention, tfa.flash_attention_plain, qkv,
               [True] * 3, lambda: tfa.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", TRAIN_FF)
def test_ff_weight_gradients_at_the_training_batch_on_card(m, d):
    """ff_matmul at the training step's batch-4 rows (the mid block's 256
    too): the gradients of x, both weights and the bias bit for bit."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(37)
    k = 4 * d
    ins = [torch.randn(m, d, device=dev, generator=g).bfloat16(),
           (torch.randn(2 * k, d, device=dev, generator=g)
            * d ** -0.5).bfloat16(),
           (torch.randn(2 * k, device=dev, generator=g) * 0.1).bfloat16(),
           (torch.randn(d, k, device=dev, generator=g) * k ** -0.5).bfloat16()]
    _grad_gate(tgg.ff_matmul, tgg.ff_matmul_plain, ins, [True] * 4,
               lambda: tgg.ff_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw,act", TRAIN_GN)
def test_group_norm_scale_and_bias_gradients_at_the_training_batch_on_card(
        c, hw, act):
    """fused_group_norm at every SD1.5 site at batch 4 (the resnets' with
    SiLU; two of the transformers' without): the gradients of x, scale
    and bias bit for bit."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(38)
    s = int(hw ** 0.5)
    ins = [torch.randn(4, c, s, s, device=dev, generator=g).bfloat16(),
           (1 + 0.2 * torch.randn(c, device=dev, generator=g)).bfloat16(),
           (0.1 * torch.randn(c, device=dev, generator=g)).bfloat16()]
    _grad_gate(tgn.fused_group_norm, tgn.fused_group_norm_plain, ins,
               [True] * 3, lambda: tgn.launches, act=act)


# ---------------------------------------------------------------------------
# the cross-attention kernel (csrc/cross_attention.cu, row 9)
# ---------------------------------------------------------------------------

# the cells' cross-attention calls, (B, Sq, H, d, IP keys): SD1.5's IP UNet
# at batch 24 (12 characters under CFG) at its three levels, SDXL's at
# batch 12, with IP keys (the XL IP UNet) and without (its base UNet)
CROSS_SHAPES = [(24, 4096, 8, 40, 4), (24, 1024, 8, 80, 4),
                (24, 256, 8, 160, 4), (12, 4096, 10, 64, 4),
                (12, 1024, 20, 64, 4), (12, 4096, 10, 64, 0),
                (12, 1024, 20, 64, 0)]
# The kernel against the plain version on the card (both bf16 out, from the
# same bf16 inputs) is held to chip_smoke.py's row-9 gate, cross_gate
# (CROSS_*_BOUND there, with their reasons and readings).


def _cross_inputs(b, sq, h, d, si, seed):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, device=dev, generator=g,
                           dtype=torch.bfloat16)

    q, k, v = r(b, sq, h, d), r(b, 77, h, d), r(b, 77, h, d)
    k_ip, v_ip = (r(b, si, h, d), r(b, si, h, d)) if si else (None, None)
    scale = torch.tensor([0.4, 0.0] * (b // 2), device=dev)
    return q, k, v, k_ip, v_ip, scale


def _cross_within(out, ref):
    """(max and mean |out - ref|, within chip_smoke.cross_gate's bounds,
    the bit-equal share)."""
    g = _chip_smoke().cross_gate(out, ref)
    return g["err"], g["mean"], g["ok"], g["same"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,h,d,si", CROSS_SHAPES)
def test_cross_kernel_matches_plain_at_the_cells_shapes(b, sq, h, d, si):
    """One launch at each of the cells' shapes, 77 text keys and 4 IP keys
    with a [B] scale mixing 0.4 and 0 (DB hits and misses), within the
    bounds above of the plain chain; the output is [B, Sq, H, d]
    contiguous, so the reshape before to_out is a view."""
    q, k, v, k_ip, v_ip, scale = _cross_inputs(b, sq, h, d, si, sq + d + si)
    n0 = tat.launches_cross
    out = tat.cross_attention(q, k, v, k_ip, v_ip, scale)
    torch.cuda.synchronize()
    assert tat.launches_cross == n0 + 1
    assert out.shape == (b, sq, h, d) and out.is_contiguous()
    ref = tat.cross_attention_plain(q, k, v, k_ip, v_ip, scale)
    mx, mean, ok, same = _cross_within(out, ref)
    assert ok, (mx, mean, same)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["ip_dropped", "scale_swapped",
                                   "key78_unmasked", "p_one_bf16"])
def test_cross_bound_catches_planted_faults(fault):
    """What the bound above must refuse, at SD1.5's level 1 (B24 Sq1024
    d80): the IP branch dropped (the text-only launch), one row's scale
    swapped with its neighbour's, key 78 left in the softmax (78 keys,
    the last a zero key and value, as the padded key arrives), and P as
    one bf16 term (the plain version so rounded: the precision the hi + lo
    split keeps)."""
    q, k, v, k_ip, v_ip, scale = _cross_inputs(24, 1024, 8, 80, 4, 7)
    ref = tat.cross_attention_plain(q, k, v, k_ip, v_ip, scale)
    if fault == "ip_dropped":
        out = tat.cross_attention(q, k, v)
    elif fault == "scale_swapped":
        swapped = scale.clone()
        swapped[[0, 1]] = scale[[1, 0]]
        out = tat.cross_attention(q, k, v, k_ip, v_ip, swapped)
    elif fault == "key78_unmasked":
        pad = torch.zeros_like(k[:, :1])
        out = tat.cross_attention(q, torch.cat([k, pad], 1),
                                  torch.cat([v, pad], 1), k_ip, v_ip, scale)
    else:
        out = _chip_smoke().cross_plain_p_bf16(q, k, v, k_ip, v_ip, scale)
    assert not _cross_within(out, ref)[2]


@pytest.mark.cuda
@pytest.mark.parametrize("scale", ["float", "zero_dim_cuda", "zero_dim_cpu",
                                   "one_element", "per_row"])
def test_cross_kernel_takes_every_scale_form(scale):
    """A float, a 0-dim CUDA or CPU tensor, a [1] and a [B] tensor as the
    IP scale, each within the bounds of the plain version."""
    q, k, v, k_ip, v_ip, per_row = _cross_inputs(4, 1024, 8, 40, 4, 11)
    s = {"float": 0.4, "zero_dim_cuda": torch.tensor(0.4, device="cuda"),
         "zero_dim_cpu": torch.tensor(0.4),
         "one_element": torch.tensor([0.4], device="cuda"),
         "per_row": per_row}[scale]
    out = tat.cross_attention(q, k, v, k_ip, v_ip, s)
    ref = tat.cross_attention_plain(q, k, v, k_ip, v_ip, s)
    mx, mean, ok, same = _cross_within(out, ref)
    assert ok, (mx, mean, same)


@pytest.mark.cuda
@pytest.mark.parametrize("sk,si,sq", [(80, 16, 100), (128, 1, 256),
                                      (1, 0, 130)])
def test_cross_kernel_key_counts_and_a_ragged_q_tail(sk, si, sq):
    """The padded-key edges (80 and 128 text keys, 16 and 1 IP keys, a
    single text key) and a q tail the 128-row tile does not divide."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(sk + si)

    def r(*shape):
        return torch.randn(*shape, device=dev, generator=g,
                           dtype=torch.bfloat16)

    q, k, v = r(2, sq, 8, 64), r(2, sk, 8, 64), r(2, sk, 8, 64)
    k_ip, v_ip = (r(2, si, 8, 64), r(2, si, 8, 64)) if si else (None, None)
    out = tat.cross_attention(q, k, v, k_ip, v_ip, 0.4)
    ref = tat.cross_attention_plain(q, k, v, k_ip, v_ip, 0.4)
    mx, mean, ok, same = _cross_within(out, ref)
    assert ok, (mx, mean, same)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,si", [(144, 4), (576, 0), (64, 4)])
def test_cross_kernel_ragged_q_tail_at_d160(sq, si):
    """The d = 160 instance with a q tail the 128-row tile does not
    divide: SD1.5 at 768 px (levels 2 and 3, 576 and 144 queries) and at
    512 px (the mid block's 64), with and without IP keys."""
    q, k, v, k_ip, v_ip, scale = _cross_inputs(2, sq, 8, 160, si, sq + si)
    out = tat.cross_attention(q, k, v, k_ip, v_ip, scale)
    ref = tat.cross_attention_plain(q, k, v, k_ip, v_ip, scale)
    mx, mean, ok, same = _cross_within(out, ref)
    assert ok, (mx, mean, same)


@pytest.mark.cuda
def test_cross_attention_layer_routes_on_card():
    """A bf16 CrossAttention with IP tokens on the card: a call with a
    context launches the kernel once, one that asks for the probabilities
    (a captured layer) and a self-attention call launch none of it, and
    plain_path() none either; the routed output within the bounds of the
    plain route's."""
    dev = _card()
    attn = tl.CrossAttention(320, 8, 40, context_dim=768,
                             ip_tokens=4).to(dev, torch.bfloat16)
    x = torch.randn(2, 4096, 320, device=dev, dtype=torch.bfloat16)
    ctx = torch.randn(2, 81, 768, device=dev, dtype=torch.bfloat16)
    scale = torch.tensor(0.4, device=dev)
    n0 = tat.launches_cross
    with torch.no_grad():
        fast = attn(x, ctx, ip_scale=scale)
        assert tat.launches_cross == n0 + 1
        attn(x, ctx, ip_scale=scale, return_probs=True)
        tl.CrossAttention(320, 8, 40).to(dev, torch.bfloat16)(x)
        with tl.plain_path():
            plain = attn(x, ctx, ip_scale=scale)
    torch.cuda.synchronize()
    assert tat.launches_cross == n0 + 1
    rel = (fast.float() - plain.float()).abs().max() / plain.float().abs().max()
    assert rel <= 2e-2


@pytest.mark.cuda
def test_cross_wrapper_refuses_what_the_kernel_does_not_take():
    """Too many text or IP keys, a head dim without an instance, fp32 or
    a scale of the wrong shape raise; CPU tensors run the plain version."""
    dev = _card()
    q = torch.randn(2, 256, 8, 40, device=dev, dtype=torch.bfloat16)
    k = torch.randn(2, 77, 8, 40, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tat.cross_attention(q, torch.cat([k, k], 1)[:, :129],
                            torch.cat([k, k], 1)[:, :129])
    with pytest.raises(ValueError):
        tat.cross_attention(q, k, k, torch.cat([k] * 2, 1)[:, :17],
                            torch.cat([k] * 2, 1)[:, :17], 0.4)
    with pytest.raises(ValueError):
        tat.cross_attention(q[..., :32], k[..., :32], k[..., :32])
    with pytest.raises(TypeError):
        tat.cross_attention(q.float(), k.float(), k.float())
    with pytest.raises(ValueError):
        tat.cross_attention(q, k, k, k[:, :4], k[:, :4],
                            torch.ones(3, device=dev))
    n0 = tat.launches_cross
    out = tat.cross_attention(q.cpu(), k.cpu(), k.cpu(), k[:, :4].cpu(),
                              k[:, :4].cpu(), 0.4)
    assert tat.launches_cross == n0 and out.device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("s,d,ip", [(4096, 40, True), (1024, 80, True),
                                    (1024, 64, False)])
def test_cross_gradient_is_the_plain_version_on_card(s, d, ip):
    """The guided UNet's batch-1 cross-attention under autograd: one
    launch forward, none backward, the gradients of q, k, v (and k_ip,
    v_ip) bit for bit the plain version's."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(39)
    ins = [torch.randn(1, s, 8, d, device=dev, generator=g,
                       dtype=torch.bfloat16)]
    ins += [torch.randn(1, n, 8, d, device=dev, generator=g,
                        dtype=torch.bfloat16)
            for n in ((77, 77, 4, 4) if ip else (77, 77))]
    _grad_gate(tat.cross_attention, tat.cross_attention_plain, ins,
               [True] * len(ins), lambda: tat.launches_cross,
               **(dict(ip_scale=0.4) if ip else {}))
