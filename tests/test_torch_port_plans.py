"""The launch planners and domain checks of the port's quant_matmul,
geglu_matmul and group_norm kernels, the quantiser's quotient rule, and
group_norm's statistics, on the CPU.

The kernels themselves run only on a card (tests/test_torch_port_cuda.py);
what decides their launch is plain Python and is held here: the split
planners at every shape of the W8A8 UNet and of SDXL's FF tail, the
shapes the geglu kernel takes against the first design's domain, the
group_norm planner over its domain, and a transcription of group_norm's
per-CTA statistics and cluster combine.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theatergen_tpu_torch.ops import geglu_matmul as tgg
from theatergen_tpu_torch.ops import groupnorm as tgn
from theatergen_tpu_torch.ops import quant_matmul as tqm

# (M, K, N) of the SD1.5 W8A8 UNet's quant_matmul calls (CFG batch 2),
# as tests/test_torch_port_cuda.py lists them, and the two ragged shapes
QMM_PATH_SHAPES = [
    (8192, 320, 320), (154, 768, 320), (8192, 320, 2560), (8192, 1280, 320),
    (2048, 640, 640), (154, 768, 640), (2048, 640, 5120), (2048, 2560, 640),
    (512, 1280, 1280), (154, 768, 1280), (512, 1280, 10240),
    (512, 5120, 1280), (128, 1280, 1280), (128, 1280, 10240),
    (128, 5120, 1280), (2, 320, 1280), (2, 1280, 1280), (2, 1280, 640),
    (2, 1280, 320)]
QMM_RAGGED = [(40, 128, 130), (100, 320, 2560)]
H100_SMS = 132


@pytest.mark.parametrize("m,k,n", QMM_PATH_SHAPES + QMM_RAGGED)
def test_qmm_plan_is_a_valid_launch(m, k, n):
    """Splits divide the K steps; the cluster is a built size and divides
    the column tiles (so no CTA of a cluster is left without columns); the
    tiles are the kernel's."""
    c, bm, bn, splits = tqm.qmm_plan(m, n, k, H100_SMS)
    rb, nt, steps = tqm.qmm_tiles(m, n, k)
    assert (bm, bn) == (tqm.QMM_BM, tqm.QMM_BN) == (128, 160)
    assert c in tqm.QMM_CLUSTERS and nt % c == 0
    assert steps == -(-k // 128) and steps % splits == 0
    # the widest cluster that divides the tiles: A is quantised nt / c
    # times a call
    assert c == max(x for x in tqm.QMM_CLUSTERS if nt % x == 0)


@pytest.mark.parametrize("m,k,n", [s for s in QMM_PATH_SHAPES + QMM_RAGGED
                                   if s[0] <= 512])
def test_qmm_plan_splits_k_where_the_tiles_leave_sms_idle(m, k, n):
    """At M <= 512, where the tiles alone fill under half the H100's 132
    SMs and K has 6 or more steps, the plan splits K; and it never leaves
    a split fewer than 2 steps (a sweep of every split count on the card
    found 1-step splits slower: each split repeats the row-scale pass and
    adds a partial to the reduction)."""
    c, _, _, splits = tqm.qmm_plan(m, n, k, H100_SMS)
    rb, nt, steps = tqm.qmm_tiles(m, n, k)
    if rb * nt < H100_SMS // 2 and steps >= 6:
        assert splits > 1
    assert steps == 1 or steps // splits >= 2


def test_qmm_plan_quantises_a_at_most_eight_times():
    """The widest path shape (N = 10240) quantises A ceil(N / (C·160)) = 8
    times a call (the first design: N / 128 = 80); N <= 1280 once."""
    for m, k, n in QMM_PATH_SHAPES:
        c, _, bn, _ = tqm.qmm_plan(m, n, k, H100_SMS)
        times = -(-n // (c * bn))
        assert times == (8 if n == 10240 else 4 if n == 5120
                         else 2 if n == 2560 else 1)


def test_qmm_plan_takes_no_split_where_the_tiles_fill_the_card():
    """The big-M calls, whose tiles alone fill the card, take no split."""
    for m, k, n in QMM_PATH_SHAPES:
        _, _, _, splits = tqm.qmm_plan(m, n, k, H100_SMS)
        rb, nt, _ = tqm.qmm_tiles(m, n, k)
        if rb * nt >= H100_SMS:
            assert splits == 1


def _quant_kernel_rule(x: np.ndarray, s: np.ndarray) -> np.ndarray:
    """The kernel's quantiser, step by step in fp32: y = x · fl(1/s);
    within 1e-4 of a half-integer take the IEEE quotient instead; rint,
    clamp."""
    x = torch.from_numpy(x)
    s = torch.from_numpy(s)
    inv = 1.0 / s                                   # fl(1/s), fp32
    y = x * inv
    near = (y - torch.round(y)).abs() > 0.4999
    y = torch.where(near, x / s, y)
    return torch.clamp(torch.round(y), -127, 127).numpy()


def test_quantiser_rule_equals_the_ieee_quotient():
    """The kernel quantises with a multiply and falls back to the IEEE
    division only near a rounding boundary; the int8 values equal
    rint(x / s) (the plain version's and the TPU kernel's) on random rows
    and on values placed at and a few ulps around every half-integer
    quotient."""
    rng = np.random.RandomState(0)
    x = (rng.randn(512, 1024) * rng.lognormal(0, 2, (512, 1))).astype(
        np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    s = np.maximum(np.abs(x).max(-1, keepdims=True) / np.float32(127),
                   np.float32(1e-8)).astype(np.float32)
    want = np.clip(np.round(x / s), -127, 127)
    np.testing.assert_array_equal(_quant_kernel_rule(x, s), want)
    # quotients at k + 0.5 and their fp32 neighbours, for many scales
    s = rng.uniform(1e-3, 10, (256, 1)).astype(np.float32)
    half = (np.arange(-127, 127, dtype=np.float32) + np.float32(0.5))[None]
    base = (half * s).astype(np.float32)
    cands = [base]
    for steps in (1, 2, 3):
        cands.append(np.nextafter(cands[-1], np.float32(np.inf)))
    lo = [base]
    for steps in (1, 2, 3):
        lo.append(np.nextafter(lo[-1], np.float32(-np.inf)))
    x = np.concatenate(cands + lo[1:], axis=1).astype(np.float32)
    s = np.broadcast_to(s, (256, 1)).astype(np.float32)
    want = np.clip(np.round(x / s), -127, 127)
    np.testing.assert_array_equal(_quant_kernel_rule(x, s), want)


SDXL_GEGLU = [(8192, 2560, 640), (2048, 5120, 1280)]


@pytest.mark.parametrize("m,k,n", SDXL_GEGLU + [
    (m, 4 * n, n) for n in (320, 640, 960, 1280, 1600, 1920)
    for m in (100, 2048, 8192)])
def test_geglu_plan_is_a_valid_launch(m, k, n):
    """One CTA per 160 output columns in a cluster of N / 160 over 128
    rows; splits divide the chunks of 64·C inner columns (a ragged last
    chunk counts whole)."""
    c, bm, splits = tgg.geglu_plan(m, n, k, H100_SMS)
    assert c == n // 160 and bm == 128
    assert tgg.geglu_chunk(n) == 64 * c
    chunks = -(-k // tgg.geglu_chunk(n))
    assert chunks % splits == 0


def test_geglu_plan_at_sdxl_shapes():
    """SDXL's two levels take one wave or more without splits: M8192 at
    N = 640 is 64 row blocks x 4 = 256 CTAs, M2048 at N = 1280 16 x 8 =
    128, about one wave."""
    assert tgg.geglu_plan(8192, 640, 2560, H100_SMS) == (4, 128, 1)
    assert tgg.geglu_plan(2048, 1280, 5120, H100_SMS) == (8, 128, 1)


def test_geglu_kernel_domain_equals_the_first_designs_under_the_gate():
    """Over N <= 2048 (what the JAX gate routes) the kernel takes exactly
    the widths the first design took, the multiples of 320; K a multiple
    of 32, as before."""
    took = {n for n in range(1, 2049) if n % 320 == 0}
    assert {n for n in range(1, 2049) if tgg.geglu_kernel_takes(n, 2560)} \
        == took
    assert all(tgg.geglu_kernel_takes(640, k) == (k % 32 == 0)
               for k in range(1, 6000))
    assert not tgg.geglu_kernel_takes(192, 1280)


# ---- group_norm ----

def _gn_domain(b: int) -> list:
    """(c, hw) shapes in supported()'s domain at 32 groups: a grid of
    channel counts and spatial sizes, the largest H·W each channel count
    admits (the size limit), and 400 random ones (seeded)."""
    cs = (32, 64, 96, 160, 320, 640, 960, 1280, 1920, 2560, 5120, 10240,
          20480)
    hws = (8, 16, 24, 40, 64, 72, 144, 256, 576, 1000, 1024, 2304, 4096,
           4104, 9216, 16384, 65536, 163840)
    out = [(c, hw) for c in cs for hw in hws]
    out += [(c, (tgn._VMEM_BUDGET // (16 * c)) // 8 * 8) for c in cs]
    rng = np.random.RandomState(b)
    for _ in range(400):
        c = 32 * int(rng.randint(1, 641))
        hw = 8 * int(rng.randint(1, tgn._VMEM_BUDGET // (16 * c) // 8 + 1))
        out.append((c, hw))
    return [(c, hw) for c, hw in out
            if tgn.supported((b, c, hw), torch.bfloat16)]


@pytest.mark.parametrize("b", [1, 2, 4, 8])
def test_gn_plan_is_a_valid_launch_over_the_domain(b):
    """At every shape of the domain (32 groups): a portable cluster size,
    a built CTA width, shares of whole 16-byte pieces that cover the slice
    exactly with no CTA empty, either in registers (at most GN_REG_PIECES
    a thread) or in shared memory loaded in 4 chunks of at least one
    piece, and the shared memory the kernel needs, within what an H100
    CTA can take."""
    for c, hw in _gn_domain(b):
        plan = tgn.gn_plan(b, c, hw, 32)
        pieces = tgn.gn_pieces(c, hw, 32)
        assert pieces * 8 == c // 32 * hw
        assert plan.cluster in (1, 2, 4, 8)
        assert plan.threads in tgn.GN_THREADS
        owned = [min(plan.share, pieces - r * plan.share)
                 for r in range(plan.cluster)]
        assert sum(owned) == pieces and min(owned) >= 1, (c, hw, plan)
        if plan.chunks == 0:
            assert plan.share <= plan.threads * tgn.GN_REG_PIECES
        else:
            assert plan.chunks == 4 <= plan.share
        assert plan.smem == tgn.gn_smem(plan.share, c, hw, 32, plan.chunks)
        assert plan.smem >= (16 * plan.share if plan.chunks else 0)
        assert plan.smem <= tgn.GN_SMEM_LIMIT


@pytest.mark.parametrize("groups", [8, 16])
def test_gn_plan_at_other_group_counts(groups):
    """With fewer groups a slice grows: the plan is a valid launch where
    a share fits in eight CTAs' shared memory, and raises ValueError
    (never a launch the kernel would refuse) where it does not."""
    for c in (320, 640, 1280, 2560):
        for hw in (64, 256, 1024, 4096, 9216, 16384):
            if not tgn.supported((2, c, hw), torch.bfloat16, groups):
                continue
            pieces = tgn.gn_pieces(c, hw, groups)
            fits = tgn.gn_smem(-(-pieces // 8), c, hw, groups,
                               4) <= tgn.GN_SMEM_LIMIT
            if not fits:
                with pytest.raises(ValueError):
                    tgn.gn_plan(2, c, hw, groups)
                continue
            plan = tgn.gn_plan(2, c, hw, groups)
            owned = [min(plan.share, pieces - r * plan.share)
                     for r in range(plan.cluster)]
            assert sum(owned) == pieces and min(owned) >= 1
            assert plan.smem == tgn.gn_smem(plan.share, c, hw, groups,
                                            plan.chunks)
            assert plan.smem <= tgn.GN_SMEM_LIMIT


def test_gn_plan_fills_the_card_at_sd15_64_sites():
    """SD1.5's 64² norms (320, 640 and 960 channels) at CFG batch 2 launch
    at least 128 CTAs: B·G = 64 slices, so clusters of 2 or more."""
    for c in (320, 640, 960):
        plan = tgn.gn_plan(2, c, 4096, 32)
        assert 2 * 32 * plan.cluster >= 128 and plan.cluster >= 2


def test_gn_plan_at_cfg_batch_follows_the_sweep():
    """At CFG's B = 2: a slice of up to 8 KB (SD1.5's 8²×1280) takes one
    CTA, no exchange; larger ones two CTAs, their shares in registers up
    to 8 pieces a thread (to 64 KB) and in shared memory beyond (SDXL's
    64²×640, 160 KB a slice)."""
    plan = tgn.gn_plan(2, 1280, 64, 32)
    assert (plan.cluster, plan.chunks) == (1, 0)
    for c, hw in ((2560, 64), (1280, 256), (640, 1024), (320, 4096),
                  (1920, 1024)):
        plan = tgn.gn_plan(2, c, hw, 32)
        assert (plan.cluster, plan.chunks) == (2, 0), (c, hw, plan)
    for c, hw in ((640, 4096), (320, 16384), (320, 9216)):
        plan = tgn.gn_plan(2, c, hw, 32)
        assert (plan.cluster, plan.chunks) == (2, 4), (c, hw, plan)


def test_gn_plan_follows_the_sweep_at_other_batches():
    """Where the slices alone fill the card (B >= 4) a slice of up to
    96 KB takes one CTA; at B = 1, and for 320 KB slices past B = 2, the
    cluster is 8 (the widest spread measured fastest there)."""
    assert tgn.gn_plan(4, 320, 4096, 32).cluster == 1
    assert tgn.gn_plan(8, 320, 4096, 32).cluster == 1
    for b in (1, 4, 8):
        assert tgn.gn_plan(b, 320, 16384, 32).cluster == 8
    assert tgn.gn_plan(1, 320, 4096, 32).cluster == 8


def test_gn_launch_plan_is_memoised(monkeypatch):
    """The wrapper's plan is searched once per shape."""
    calls = []
    real = tgn.gn_plan
    monkeypatch.setattr(tgn, "_plans", {})
    monkeypatch.setattr(tgn, "gn_plan",
                        lambda *a: calls.append(a) or real(*a))
    first = tgn.launch_plan(2, 320, 4096, 32)
    for _ in range(3):
        assert tgn.launch_plan(2, 320, 4096, 32) is first
    assert calls == [(2, 320, 4096, 32)]


def test_gn_plan_refuses_a_slice_no_cluster_holds():
    """A slice over eight CTAs' shared memory (one group over a 1280 x
    1024 map, 2.5 MB) raises instead of launching."""
    with pytest.raises(ValueError):
        tgn.gn_plan(1, 1280, 1024, 1)


def _sum8(f):
    """The kernel's tree over a piece's eight values (fp32)."""
    return ((f[..., 0] + f[..., 1]) + (f[..., 2] + f[..., 3])) + (
        (f[..., 4] + f[..., 5]) + (f[..., 6] + f[..., 7]))


def _block_sum(v: np.ndarray) -> np.float32:
    """The kernel's block sum of one fp32 value per thread: an xor
    butterfly inside each warp, then the same butterfly over the warps'
    sums (zeros past the last warp)."""
    v = v.astype(np.float32).reshape(-1, 32)
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    w = np.zeros(32, np.float32)
    w[:v.shape[0]] = v[:, 0]
    for o in (16, 8, 4, 2, 1):
        w = w + w[lanes ^ o]
    return w[0]


def _by_thread(pieces: np.ndarray, threads: int, fn) -> tuple:
    """Per thread, fn's fp32 value of each of its pieces (piece i goes to
    thread i % threads) added in order, and the thread's piece count."""
    n = pieces.shape[0]
    rows = -(-n // threads)
    vals = np.zeros(rows * threads, np.float32)
    vals[:n] = fn(pieces, np.arange(n) % threads)
    acc = np.zeros(threads, np.float32)
    for row in vals.reshape(rows, threads):
        acc = acc + row      # adding 0 where a thread has no piece is exact
    return acc, np.bincount(np.arange(n) % threads, minlength=threads)


def _gn_kernel_stats(xs: np.ndarray, cluster: int, threads: int,
                     chunks: int) -> tuple:
    """The kernel's statistics of one slice (fp32, flat, a multiple of 8
    values), step by step: CTA r's share of ceil(P / C) pieces (the last
    shorter), loaded in ``chunks`` chunks (0: one, the register route);
    per chunk each thread's sum, mean and centred M2 over its pieces,
    merged into the thread's running triple (Chan); the CTA's
    counts-weighted mean and M2 = sum M2_t + n_t (mean_t - mean)^2 by two
    block sums; then the rank-ordered Chan combine every CTA runs.
    Returns (mean, var)."""
    f32 = np.float32
    pieces = xs.reshape(-1, 8)
    p = pieces.shape[0]
    share = -(-p // cluster)
    triples = []
    for r in range(cluster):
        mine = pieces[r * share:min(p, (r + 1) * share)]
        np_ = mine.shape[0]
        nchunk = min(chunks, np_) if chunks else 1
        cpc = -(-np_ // nchunk)
        n_t = np.zeros(threads, f32)
        mean_t = np.zeros(threads, f32)
        m2_t = np.zeros(threads, f32)
        for k in range(0, np_, cpc):
            chunk = mine[k:k + cpc]
            s, count = _by_thread(chunk, threads, lambda f, t: _sum8(f))
            nb = (count * 8).astype(f32)
            has = count > 0
            mean_k = np.where(has, s / np.where(has, nb, f32(1)), f32(0))
            m, _ = _by_thread(chunk, threads, lambda f, t: _sum8(
                (f - mean_k[t][:, None]) * (f - mean_k[t][:, None])))
            n = n_t + nb
            safe = np.where(has, n, f32(1))
            d = mean_k - mean_t
            mean_t = np.where(has, mean_t + d * (nb / safe), mean_t)
            m2_t = np.where(has, m2_t + (m + d * d * (n_t * nb / safe)), m2_t)
            n_t = n
        n_loc = f32(np_ * 8)
        mean_loc = f32(_block_sum(n_t * mean_t) / n_loc)
        d = mean_t - mean_loc
        triples.append((n_loc, mean_loc, _block_sum(m2_t + n_t * d * d)))
    if cluster == 1:
        n, mean, m2 = triples[0]
        return mean, f32(m2 / n)
    n = acc = f32(0)
    for tn, tmean, _ in triples:
        n = f32(n + tn)
        acc = f32(acc + tn * tmean)
    mean = f32(acc / n)
    m2 = f32(0)
    for tn, tmean, tm2 in triples:
        d = f32(tmean - mean)
        m2 = f32(m2 + f32(tm2 + tn * d * d))
    return mean, f32(m2 / n)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("threads", [128, 256])
def test_gn_kernel_statistics_equal_the_centred_variance(cluster, threads):
    """The kernel's per-thread, per-CTA and rank-ordered cluster
    statistics, transcribed in fp32, on both load routes (4 chunks in
    shared memory; registers, where a share fits), at a mean of 1024
    against a std of 1.5 (rounded to bf16, whose step there is 4 to 8)
    and with uneven shares (a 10·4104-value group: 5130 pieces, so C = 4
    gives 1283, 1283, 1283 and 1281): the mean and variance equal the
    float64 centred ones within 1e-6 and 1e-5 relative, where
    E[x²] - mean² in fp32 misses the second bound a hundredfold; the
    output then matches fused_group_norm_plain within 1e-2·max|ref|."""
    rng = np.random.RandomState(cluster * 7 + threads)
    c, hw = 320, 4104
    x = (rng.randn(1, c, hw) * 1.5 + 1024).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16)
    xs = x.float().numpy().reshape(32, -1)[5]
    assert len(np.unique(xs)) >= 3
    x64 = xs.astype(np.float64)
    want_mean, want_var = x64.mean(), ((x64 - x64.mean()) ** 2).mean()
    share = -(-xs.size // 8 // cluster)
    for chunks in (4, 0) if share <= threads * tgn.GN_REG_PIECES else (4,):
        mean, var = _gn_kernel_stats(xs, cluster, threads, chunks)
        assert abs(mean - want_mean) <= 1e-6 * abs(want_mean), chunks
        assert abs(var - want_var) <= 1e-5 * want_var, chunks
    x32 = xs.astype(np.float32)
    shortcut = np.float32(np.mean(x32 * x32) - np.float32(x32.mean()) ** 2)
    assert abs(shortcut - want_var) > 1e-3 * want_var
    # normalise the whole tensor with the transcribed statistics
    g = x.float().numpy().reshape(32, -1)
    stats = [_gn_kernel_stats(row, cluster, threads, 4) for row in g]
    w = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)
    out = np.stack([(row - m) * (1 / np.sqrt(v + np.float32(1e-5)))
                    for row, (m, v) in zip(g, stats)]).reshape(c, hw)
    out = out * w[:, None] + bias[:, None]
    ref = tgn.fused_group_norm_plain(
        x.float().reshape(1, c, 27, 152), torch.from_numpy(w),
        torch.from_numpy(bias)).reshape(c, hw).numpy()
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
