"""Transformer feed-forward kernels: the Hopper counterparts of
``theatergen_tpu/ops/geglu_matmul.py::ff_matmul`` and ``::geglu_matmul``.

``ff_matmul(x, w1, b1, w2) = geglu(x @ w1.T + b1) @ w2.T`` is the whole FF
(``UNetConfig.fused_ff``, SD1.5); ``geglu_matmul(hg, w) = geglu(hg) @ w.T``
is its tail, over an up-projection ``hg = [value ‖ gate]`` already in
device memory (``fused_ff=False``, SDXL).  In both the value half comes
first and the gate half takes exact-erf gelu, as in the TPU package's
``_ff_reference`` / ``_reference``.  Weights are the modules' own
``[out, in]`` tensors (``w1 [2K, D]``, ``b1 [2K]``, ``w2``/``w [N, K]``),
read in place.  The net.2 bias is added by the caller.

On a CUDA tensor each wrapper launches its kernel (``csrc/ff_geglu.cu``:
a thread-block cluster of D/160 CTAs per 128 rows shares each chunk of h
through distributed shared memory, so the ``[M, 2K]`` intermediate never
reaches device memory; :func:`ff_plan` picks its launch;
``csrc/geglu_matmul.cu``: the same cluster design without the
up-projection, each CTA gating its own 64 inner columns of a chunk once
and sharing the bf16 piece; :func:`geglu_plan` picks its launch; see the
notes there) or raises.  On a CPU tensor it runs its plain
version (:func:`ff_matmul_plain`, :func:`geglu_matmul_plain`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

# model widths D with a compiled kernel instance (csrc/ff_geglu.cu)
KERNEL_WIDTHS = (320, 640, 1280)
# the kernel's cluster: one CTA per FF_CTA_COLS output columns, FF_BM rows
# per cluster; each CTA adds FF_H_COLS inner columns to a chunk, so a chunk
# holds FF_H_COLS * D / FF_CTA_COLS columns
FF_CTA_COLS = 160
FF_BM = 128
FF_H_COLS = 64
# stages of the kernel's TMA ring (32 KB each)
FF_STAGES = 5
# the split planner's model of one CTA: its bf16 tensor-core rate (about
# 60 % of the H100's 989 TFLOP/s over 132 SMs) and the rate at which the
# partials of a split travel to device memory and back
_CTA_FLOPS = 4.5e12
_PARTIAL_BYTES_PER_S = 3.0e12

# geglu_matmul's kernel (csrc/geglu_matmul.cu): a cluster of N / 160 CTAs
# (FF_CTA_COLS columns each) per FF_BM rows, built for the even cluster
# sizes 2..12, so N a multiple of GEGLU_BLOCK_N up to GEGLU_MAX_N (every
# N the JAX gate routes, N <= 2048, that the first design's 320-column
# tiles took); K a multiple of GEGLU_BLOCK_K, M any
GEGLU_BLOCK_N = 2 * FF_CTA_COLS
GEGLU_MAX_N = 1920
GEGLU_BLOCK_K = 32
# stages of its TMA ring (20 KB each)
GEGLU_STAGES = 8

# kernel launches made by ff_matmul and geglu_matmul (reset and read by
# callers)
ff_launches = 0
geglu_launches = 0

# the TPU gates' VMEM budgets (the full-FF kernel's default 48 MiB limit,
# five sixths of it usable; the geglu kernel's 80 MiB), kept so that the
# block searches below, copies of the JAX package's, take the same shapes
_FF_BUDGET = 48 * 1024 * 1024 * 5 // 6
_GEGLU_BUDGET = 80 * 1024 * 1024


def ff_supported(m: int, d: int, k: int) -> bool:
    """Whether the JAX package's ``ff_supported`` takes an FF of M rows,
    width D and inner width K: a row block of 128..4096 dividing M and a
    K chunk dividing K within its budget (``_plan_full``)."""
    for bm in (4096, 2048, 1024, 512, 256, 128):
        if bm > m or m % bm:
            continue
        for bk in (2048, 1280, 1024, 640, 512, 256, 128):
            if bk > k or k % bk:
                continue
            vmem = (bm * d * 2 + 2 * (d * bk * 2) * 2 + (bk * d * 2) * 2
                    + 2 * 2 * (bm * bk * 4) + bm * bk * 2 + bm * d * 4
                    + bm * d * 2 * 2)
            if vmem <= _FF_BUDGET:
                return True
    return False


def supported(m: int, k: int, n: int) -> bool:
    """Whether the JAX package's ``geglu_matmul`` gate takes ``[M, 2K] x
    [K, N]``: N ≤ 2048 and a row block of 128..8192 dividing M and a K
    chunk of 128..1024 dividing K within its budget (the blocks its
    planners may pick, ``_plan``)."""
    if n > 2048:
        return False
    for bm in (8192, 4096, 2048, 1024, 512, 256, 128):
        if bm > m or m % bm:
            continue
        for bk in (1024, 512, 256, 128):
            if bk > k or k % bk:
                continue
            if (2 * (bm * bk * 2) * 2 + (bk * n * 2) * 2 + bm * n * 4
                    + bm * n * 2 * 2) <= _GEGLU_BUDGET:
                return True
    return False


def ff_matmul_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """Same function in plain PyTorch: up-projection and gate in fp32, the
    gated product rounded to x's dtype before the down-projection."""
    hg = (x @ w1.t()).float() + b1.float()
    k = w2.shape[1]
    h = (hg[..., :k] * F.gelu(hg[..., k:])).to(x.dtype)
    return h @ w2.t()


def ff_chunk(d: int) -> int:
    """Inner columns of one kernel chunk at width D (K must be a multiple)."""
    return FF_H_COLS * d // FF_CTA_COLS


def ff_plan(m: int, d: int, k: int, slots: int) -> tuple:
    """The kernel's launch for an FF of M rows, width D and inner width K
    on a card that holds ``slots`` CTAs of this width at once (the SM count,
    less what whole clusters leave over): (cluster size
    C, rows per cluster BM, inner splits).  Splits hold whole chunks; the
    plan minimises the modelled time, waves x chunks per split x a chunk's
    time, plus the partials' round trip, taking fewer splits on a tie."""
    c = d // FF_CTA_COLS
    ctas = -(-m // FF_BM) * c
    chunks = k // ff_chunk(d)
    chunk_s = ff_flops(FF_BM, d, ff_chunk(d)) / c / _CTA_FLOPS

    def cost(s):
        waves = -(-ctas * s // slots)
        reduce_s = 0.0 if s == 1 else 2 * s * m * d * 4 / _PARTIAL_BYTES_PER_S
        return waves * (chunks // s) * chunk_s + reduce_s

    splits = min((s for s in range(1, chunks + 1) if chunks % s == 0),
                 key=lambda s: (cost(s), s))
    return c, FF_BM, splits


def ff_counter_slots(m: int, d: int) -> int:
    """Split counters a call needs: one per CTA of a split (row blocks x
    cluster size)."""
    return -(-m // FF_BM) * (d // FF_CTA_COLS)


# per device: int32 counters, one per CTA of a split, for the splits of a
# call; the kernel leaves them zero, so calls on one stream share them
_split_counters: dict = {}
# per (device, D): CTAs of the kernel the card holds at once; per shape:
# geglu_matmul's launch plan
_slots: dict = {}
_plans: dict = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    have = _split_counters.get(device)
    if have is None or have.numel() < n:
        _split_counters[device] = torch.zeros(n, dtype=torch.int32,
                                              device=device)
    return _split_counters[device]


def _ff_slots(device: torch.device, d: int) -> int:
    if (device, d) not in _slots:
        lib = _build.library("ff_geglu")
        fn = lib.tg_ff_geglu_slots
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
        with torch.cuda.device(device):
            n = fn(d)
        if n <= 0:
            raise RuntimeError(f"ff_matmul: no CTA of the D={d} kernel fits "
                               f"on {device} (CUDA error {-n})")
        _slots[(device, d)] = n
    return _slots[(device, d)]


def _ff_lib():
    fn = _build.library("ff_geglu").tg_ff_geglu_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    return fn


def ff_matmul(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """``[..., D]`` → ``[..., D]``; leading dims of ``x`` flatten into M."""
    if not x.is_cuda:
        return ff_matmul_plain(x, w1, b1, w2)
    d = x.shape[-1]
    k = w2.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"ff_matmul: x must be bfloat16, got {x.dtype}")
    if d not in KERNEL_WIDTHS or k % ff_chunk(d):
        raise ValueError(f"ff_matmul: no kernel instance for D={d}, K={k} "
                         f"(widths {KERNEL_WIDTHS}, K a multiple of "
                         f"{FF_H_COLS} * D / {FF_CTA_COLS})")
    expect = {"w1": (w1, (2 * k, d)), "b1": (b1, (2 * k,)), "w2": (w2, (d, k))}
    for name, (t, shape) in expect.items():
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != x.device
                or t.data_ptr() % 16):
            raise ValueError(f"ff_matmul: {name} must be a contiguous, "
                             f"16-byte aligned bf16 {shape} tensor on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("ff_matmul: x must be contiguous and 16-byte aligned")
    m = x2.shape[0]
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    _, _, splits = ff_plan(m, d, k, _ff_slots(x.device, d))
    work = counters = None
    if splits > 1:
        # fp32 partial outputs of the splits (never the [M, 2K] intermediate)
        work = torch.empty((splits, m, d), dtype=torch.float32,
                           device=x.device)
        counters = _counters(x.device, ff_counter_slots(m, d))
    fn = _ff_lib()
    _build.check(fn(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(), m, d, k, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    ), "ff_matmul")
    global ff_launches
    ff_launches += 1
    return out.reshape(x.shape)


def ff_flops(m: int, d: int, k: int) -> float:
    """Operations of one ff_matmul call: up-projection 2·M·D·2K, down
    2·M·K·D."""
    return 6.0 * m * d * k


def ff_min_bytes(m: int, d: int, k: int, itemsize: int = 2) -> float:
    """Bytes of one ff_matmul call: x, w1, b1, w2 read once, the output
    written once."""
    return itemsize * (2.0 * m * d + 3.0 * d * k + 2.0 * k)


def geglu_matmul_plain(hg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Same function in plain PyTorch: ``value·gelu(gate)`` in fp32,
    rounded to hg's dtype before the product, as the TPU kernel and its
    ``_reference`` round it."""
    k = w.shape[1]
    h = (hg[..., :k].float() * F.gelu(hg[..., k:].float())).to(hg.dtype)
    return h @ w.t()


def geglu_kernel_takes(n: int, k: int) -> bool:
    """Whether geglu_matmul's kernel has an instance for ``w [N, K]``."""
    return (0 < n <= GEGLU_MAX_N and n % GEGLU_BLOCK_N == 0 and k > 0
            and k % GEGLU_BLOCK_K == 0)


def geglu_chunk(n: int) -> int:
    """Inner columns of one kernel chunk at output width N."""
    return FF_H_COLS * n // FF_CTA_COLS


def geglu_plan(m: int, n: int, k: int, slots: int) -> tuple:
    """The kernel's launch for ``[M, 2K] x [N, K]^T`` on a card that holds
    ``slots`` CTAs of this width at once: (cluster size C, rows per
    cluster BM, inner splits), as :func:`ff_plan` models it (each chunk's
    time its down-product; a ragged last chunk counts whole)."""
    c = n // FF_CTA_COLS
    ctas = -(-m // FF_BM) * c
    chunks = -(-k // geglu_chunk(n))
    chunk_s = geglu_flops(FF_BM, geglu_chunk(n), n) / c / _CTA_FLOPS

    def cost(s):
        waves = -(-ctas * s // slots)
        reduce_s = 0.0 if s == 1 else 2 * s * m * n * 4 / _PARTIAL_BYTES_PER_S
        return waves * (chunks // s) * chunk_s + reduce_s

    splits = min((s for s in range(1, chunks + 1) if chunks % s == 0),
                 key=lambda s: (cost(s), s))
    return c, FF_BM, splits


def _geglu_slots(device: torch.device, n: int) -> int:
    if ("geglu", device, n) not in _slots:
        fn = _build.library("geglu_matmul").tg_geglu_matmul_slots
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int]
        with torch.cuda.device(device):
            got = fn(n)
        if got <= 0:
            raise RuntimeError(f"geglu_matmul: no CTA of the N={n} kernel "
                               f"fits on {device} (CUDA error {-got})")
        _slots[("geglu", device, n)] = got
    return _slots[("geglu", device, n)]


def geglu_launch_plan(device: torch.device, m: int, n: int, k: int) -> tuple:
    """:func:`geglu_plan` with the card's slots for width N, computed once
    per shape."""
    key = ("geglu", device, m, n, k)
    if key not in _plans:
        _plans[key] = geglu_plan(m, n, k, _geglu_slots(device, n))
    return _plans[key]


def _geglu_lib():
    fn = _build.library("geglu_matmul").tg_geglu_matmul_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    return fn


def geglu_matmul(hg: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[..., 2K]`` × ``w [N, K]`` → ``[..., N]``; leading dims of ``hg``
    flatten into M; :func:`geglu_launch_plan` picks the launch."""
    if not hg.is_cuda:
        return geglu_matmul_plain(hg, w)
    n, k = w.shape
    if hg.dtype != torch.bfloat16:
        raise TypeError(f"geglu_matmul: hg must be bfloat16, got {hg.dtype}")
    if hg.shape[-1] != 2 * k:
        raise ValueError(f"geglu_matmul: hg width {hg.shape[-1]} != 2 * "
                         f"{k} (w is [N, K] = {tuple(w.shape)})")
    if not geglu_kernel_takes(n, k):
        raise ValueError(f"geglu_matmul: no kernel instance for N={n}, "
                         f"K={k} (N % {GEGLU_BLOCK_N} == 0, N <= "
                         f"{GEGLU_MAX_N}, K % {GEGLU_BLOCK_K} == 0)")
    if (w.dtype != torch.bfloat16 or not w.is_contiguous()
            or w.device != hg.device or w.data_ptr() % 16):
        raise ValueError(f"geglu_matmul: w must be a contiguous, 16-byte "
                         f"aligned bf16 tensor on {hg.device}, got "
                         f"{w.dtype} on {w.device}")
    hg2 = hg.reshape(-1, 2 * k)
    # TMA boxes of both halves: the gate half starts K columns in
    if (not hg2.is_contiguous() or hg2.data_ptr() % 16
            or (k * hg.element_size()) % 16):
        raise ValueError("geglu_matmul: hg must be contiguous with 16-byte "
                         "aligned rows and gate half")
    m = hg2.shape[0]
    out = torch.empty((m, n), dtype=hg.dtype, device=hg.device)
    if m == 0:
        return out.reshape(*hg.shape[:-1], n)
    _, _, splits = geglu_launch_plan(hg.device, m, n, k)
    work = counters = None
    if splits > 1:
        work = torch.empty((splits, m, n), dtype=torch.float32,
                           device=hg.device)
        counters = _counters(hg.device, ff_counter_slots(m, n))
    _build.check(_geglu_lib()(
        hg2.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(), m, n, k, splits,
        torch.cuda.current_stream(hg.device).cuda_stream,
    ), "geglu_matmul")
    global geglu_launches
    geglu_launches += 1
    return out.reshape(*hg.shape[:-1], n)


def geglu_flops(m: int, k: int, n: int) -> float:
    """Operations of one geglu_matmul call: the product, 2·M·K·N."""
    return 2.0 * m * k * n


def geglu_min_bytes(m: int, k: int, n: int, itemsize: int = 2) -> float:
    """Bytes of one geglu_matmul call: hg [M, 2K] and w [N, K] read once,
    the output [M, N] written once."""
    return itemsize * (2.0 * m * k + 1.0 * n * k + 1.0 * m * n)
