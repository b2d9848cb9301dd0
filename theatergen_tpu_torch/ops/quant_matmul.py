"""Fused W8A8 matmul: the Hopper counterpart of
``theatergen_tpu/ops/quant_matmul.py::quant_matmul``.

:func:`quant_matmul` takes activations ``x [..., K]``, an int8 weight
``w_q [N, K]`` (the layer's ``[out, in]``), its fp32 per-output scales and
an optional bias, and computes what the TPU kernel computes, plus the
bias the JAX package's ``QuantDense`` adds after it: per-row dynamic
scales ``s = max(max|x| / 127, 1e-8)`` in fp32, ``rint(x / s)`` clamped to
±127, the int8 product with an exact int32 sum, then
``acc · (s · w_scale) + bias`` in fp32 and one rounding to x's dtype.  On
a CUDA tensor it launches the hand-written kernel of
``csrc/quant_matmul.cu`` (a thread-block cluster along N quantises each
row block once per column group, s8 ``wgmma`` fed by a TMA ring, split-K
where the tiles leave SMs idle; see the note there; :func:`qmm_plan`
picks the launch) or raises; it has no gradient, and raises on CUDA
inputs that need one.  On a CPU tensor it runs
:func:`quant_matmul_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from . import recompute

# K must be a multiple of this (16-byte rows for TMA and the row-scale
# loads)
BLOCK_K = 32
# the kernel's tiles (csrc/quant_matmul.cu): rows per cluster, output
# columns per CTA, int8 columns per K step; cluster sizes it is built for
QMM_BM, QMM_BN, QMM_STEP_K = 128, 160, 128
QMM_CLUSTERS = (8, 4, 2, 1)
# the split planner's model of one CTA, fitted to a sweep of every cluster
# size and split count at the 19 W8A8 shapes on an H100 (PERF.md §6): its
# int8 tensor-core rate (about 2/3 of the H100's 1979 TOP/s over 132
# SMs), its share of the L2 -> SM rate for the tiles and the row-scale
# pass, the quantisers' elements per second, a K step's latency floor (TMA,
# quantisation and the cluster's stored/freed handshake), a CTA's fixed
# cost (the row-scale exchange, the ring's fill, the epilogue), and what
# each split adds to the last one's reduction
_CTA_OPS = 10e12
_CTA_BYTES_PER_S = 50e9
_QUANT_PER_S = 2e10
_STEP_FLOOR_S = 1.5e-6
_CTA_FIXED_S = 8e-6
_SPLIT_S = 1.5e-6


# kernel launches made by quant_matmul (reset and read by callers)
launches = 0

# per device: the divisor 127 as a 0-dim tensor (see div127)
_c127: dict = {}


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division on every device, as ``jnp`` and the
    kernel take it.  PyTorch's CUDA kernel turns a division by a Python
    scalar into a product with its reciprocal, one ulp off in places; a
    0-dim tensor on the same device keeps the division."""
    if t.device not in _c127:
        _c127[t.device] = torch.tensor(127.0, device=t.device)
    return t / _c127[t.device]


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Same function in plain PyTorch, each step one fp32 operation in the
    kernel's order.  The int8 product is summed exactly in float64 (K ·
    127² < 2⁵³) and rounded once to fp32, as the int32 sum's conversion
    is."""
    n, k = w_q.shape
    xf = x.reshape(-1, k).float()
    s = torch.clamp_min(div127(xf.abs().amax(-1, keepdim=True)), 1e-8)
    xq = torch.clamp(torch.round(xf / s), -127, 127)
    acc = (xq.double() @ w_q.double().t()).float()
    y = acc * (s * w_scale.float())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*x.shape[:-1], n)


def qmm_tiles(m: int, n: int, k: int) -> tuple:
    """(row blocks, column tiles, K steps) of a call."""
    return -(-m // QMM_BM), -(-n // QMM_BN), -(-k // QMM_STEP_K)


def qmm_plan(m: int, n: int, k: int, slots: int) -> tuple:
    """The kernel's launch for ``[M, K] x [N, K]^T`` on a card that holds
    ``slots`` CTAs at once: (cluster size C, rows per cluster BM, columns
    per CTA BN, K splits).  C is the largest built size that divides the
    column tiles, so A is quantised ceil(N / (C·BN)) times.  Splits divide
    the K steps; the plan minimises the modelled time, waves x (a CTA's
    fixed cost + its row-scale pass + K steps per split x a step) + what
    each split adds to the reduction, taking fewer splits on a tie."""
    rb, nt, steps = qmm_tiles(m, n, k)
    c = next(c for c in QMM_CLUSTERS if nt % c == 0)
    rows = min(m, QMM_BM)
    step_s = max(_STEP_FLOOR_S,
                 2.0 * QMM_BM * QMM_BN * QMM_STEP_K / _CTA_OPS,
                 (QMM_BN * QMM_STEP_K + 2.0 * QMM_STEP_K * rows / c)
                 / _CTA_BYTES_PER_S,
                 QMM_STEP_K * rows / c / _QUANT_PER_S)
    scales_s = 2.0 * rows * k / c / _CTA_BYTES_PER_S

    def cost(s):
        waves = -(-rb * nt * s // slots)
        return (waves * (_CTA_FIXED_S + scales_s + steps // s * step_s)
                + (0.0 if s == 1 else s * _SPLIT_S))

    splits = min((s for s in range(1, steps + 1) if steps % s == 0),
                 key=lambda s: (cost(s), s))
    return c, QMM_BM, QMM_BN, splits


def qmm_counter_slots(m: int, n: int) -> int:
    """Split counters a call needs: one per output tile."""
    rb, nt, _ = qmm_tiles(m, n, QMM_STEP_K)
    return rb * nt


# per device: int32 split counters (the kernel leaves them zero, so calls
# on one stream share them); per (device, C): CTAs the card holds at once;
# per (device, M, N, K): the launch plan
_split_counters: dict = {}
_slots: dict = {}
_plans: dict = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    have = _split_counters.get(device)
    if have is None or have.numel() < n:
        _split_counters[device] = torch.zeros(n, dtype=torch.int32,
                                              device=device)
    return _split_counters[device]


def qmm_slots(device: torch.device, cluster: int) -> int:
    """CTAs of the cluster-size-C instance the card holds at once."""
    if (device, cluster) not in _slots:
        fn = _build.library("quant_matmul").tg_quant_matmul_slots
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
        with torch.cuda.device(device):
            got = fn(cluster)
        if got <= 0:
            raise RuntimeError(f"quant_matmul: no cluster of {cluster} CTAs "
                               f"fits on {device} (CUDA error {-got})")
        _slots[(device, cluster)] = got
    return _slots[(device, cluster)]


def launch_plan(device: torch.device, m: int, n: int, k: int) -> tuple:
    """:func:`qmm_plan` with the card's slots for the cluster size the
    shape takes, computed once per shape (the search costs host time on
    every one of a request's 9200 calls otherwise)."""
    key = (device, m, n, k)
    if key not in _plans:
        _, nt, _ = qmm_tiles(m, n, k)
        c = next(c for c in QMM_CLUSTERS if nt % c == 0)
        _plans[key] = qmm_plan(m, n, k, qmm_slots(device, c))
    return _plans[key]


def _lib():
    fn = _build.library("quant_matmul").tg_quant_matmul_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
    return fn


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[..., K]`` × ``w_q [N, K]`` → ``[..., N]`` in x's dtype; leading
    dims of ``x`` flatten into M; :func:`launch_plan` picks the launch.
    It has no gradient, as the JAX package's W8A8 path has none (its
    Pallas ``quant_matmul`` has no ``custom_vjp``, ``ops/quant.py`` casts
    to int8): on CUDA inputs that need one it raises."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w_q, w_scale, bias)
    if recompute.needs_grad(x, w_scale, bias):
        raise RuntimeError(
            "quant_matmul has no gradient (the W8A8 path is inference "
            "only, as in the JAX package); call it under torch.no_grad() "
            "or on inputs that do not require grad")
    n, k = w_q.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"quant_matmul: x must be bfloat16, got {x.dtype}")
    if x.shape[-1] != k or k % BLOCK_K:
        raise ValueError(f"quant_matmul: x width {x.shape[-1]} and w_q "
                         f"[N, K] = {tuple(w_q.shape)}: K must match and be "
                         f"a multiple of {BLOCK_K}")
    if (w_q.dtype != torch.int8 or not w_q.is_contiguous()
            or w_q.device != x.device or w_q.data_ptr() % 16):
        raise ValueError(f"quant_matmul: w_q must be a contiguous, 16-byte "
                         f"aligned int8 tensor on {x.device}, got "
                         f"{w_q.dtype} on {w_q.device}")
    expect = {"w_scale": (w_scale, torch.float32)}
    if bias is not None:
        expect["bias"] = (bias, torch.bfloat16)
    for name, (t, dtype) in expect.items():
        if (t.dtype != dtype or tuple(t.shape) != (n,)
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"quant_matmul: {name} must be a contiguous "
                             f"{dtype} ({n},) tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("quant_matmul: x must be contiguous and 16-byte "
                         "aligned")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    c, _, _, splits = launch_plan(x.device, m, n, k)
    work = counters = None
    if splits > 1:
        # int32 partial sums of the splits
        work = torch.empty((splits, m, n), dtype=torch.int32,
                           device=x.device)
        counters = _counters(x.device, qmm_counter_slots(m, n))
    _build.check(_lib()(
        x2.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(), m, n, k, c,
        splits, torch.cuda.current_stream(x.device).cuda_stream,
    ), "quant_matmul")
    global launches
    launches += 1
    return out.reshape(*x.shape[:-1], n)


def flops(m: int, k: int, n: int) -> float:
    """Operations of one call: the int8 product, 2·M·K·N."""
    return 2.0 * m * k * n


def min_bytes(m: int, k: int, n: int) -> float:
    """Bytes of one call: bf16 x and int8 w_q read once, the bf16 output
    written once, the fp32 scales and bf16 bias read once."""
    return 2.0 * m * k + 1.0 * k * n + 2.0 * m * n + 6.0 * n
