"""The launch planners and domain checks of the port's quant_matmul and
geglu_matmul kernels, and the quantiser's quotient rule, on the CPU.

The kernels themselves run only on a card (tests/test_torch_port_cuda.py);
what decides their launch is plain Python and is held here: the split
planners at every shape of the W8A8 UNet and of SDXL's FF tail, and the
shapes the geglu kernel takes against the first design's domain.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from theatergen_tpu_torch.ops import geglu_matmul as tgg
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
