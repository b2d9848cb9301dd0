"""Fused transformer feed-forward: the Hopper counterpart of
``theatergen_tpu/ops/geglu_matmul.py::ff_matmul``.

``ff_matmul(x, w1, b1, w2) = geglu(x @ w1.T + b1) @ w2.T`` with the value
half first (``[:K]``) and exact-erf gelu on the gate half, as in the TPU
package's ``_ff_reference``.  Weights are the modules' own ``[out, in]``
tensors (``w1 [2K, D]``, ``b1 [2K]``, ``w2 [D, K]``), read in place.  The
net.2 bias is added by the caller.

On a CUDA tensor :func:`ff_matmul` launches the kernel of
``csrc/ff_geglu.cu`` (the ``[M, 2K]`` intermediate never reaches device
memory; see the note there) or raises.  On a CPU tensor it runs
:func:`ff_matmul_plain`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

# model widths D with a compiled kernel instance (csrc/ff_geglu.cu)
KERNEL_WIDTHS = (320, 640, 1280)
# the kernel streams the inner dimension in chunks of this many columns
K_CHUNK = 64
# rows x width a kernel block owns (BM = 64, 32, 16 at D = 320, 640, 1280)
BLOCK_ELEMS = 20480

# kernel launches made by ff_matmul (reset and read by callers)
launches = 0


def ff_matmul_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """Same function in plain PyTorch: up-projection and gate in fp32, the
    gated product rounded to x's dtype before the down-projection."""
    hg = (x @ w1.t()).float() + b1.float()
    k = w2.shape[1]
    h = (hg[..., :k] * F.gelu(hg[..., k:])).to(x.dtype)
    return h @ w2.t()


def inner_splits(m: int, d: int, k: int, sms: int) -> int:
    """Splits of the inner dimension that bring the kernel's grid of
    ceil(M/BM) row blocks closest to one block per SM without passing
    it; each split must hold whole 64-column chunks."""
    blocks = -(-m // (BLOCK_ELEMS // d))
    chunks = k // K_CHUNK
    return max(s for s in range(1, chunks + 1)
               if chunks % s == 0 and (s == 1 or blocks * s <= sms))


# per device: one int32 counter per row block for the splits of a call;
# the kernel leaves them zero, so calls on one stream share them
_split_counters: dict = {}


def _counters(device: torch.device, sms: int) -> torch.Tensor:
    # splits > 1 only where row blocks x splits <= SMs
    if device not in _split_counters:
        _split_counters[device] = torch.zeros(sms, dtype=torch.int32,
                                              device=device)
    return _split_counters[device]


def _lib():
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
    if d not in KERNEL_WIDTHS or k % K_CHUNK:
        raise ValueError(f"ff_matmul: no kernel instance for D={d}, K={k} "
                         f"(widths {KERNEL_WIDTHS}, K % {K_CHUNK} == 0)")
    expect = {"w1": (w1, (2 * k, d)), "b1": (b1, (2 * k,)), "w2": (w2, (d, k))}
    for name, (t, shape) in expect.items():
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"ff_matmul: {name} must be a contiguous bf16 "
                             f"{shape} tensor on {x.device}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    x2 = x.reshape(-1, d)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        raise ValueError("ff_matmul: x must be contiguous and 16-byte aligned")
    m = x2.shape[0]
    out = torch.empty((m, d), dtype=x.dtype, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = inner_splits(m, d, k, sms)
    work = counters = None
    if splits > 1:
        # fp32 partial outputs of the splits (never the [M, 2K] intermediate)
        work = torch.empty((splits, m, d), dtype=torch.float32,
                           device=x.device)
        counters = _counters(x.device, sms)
    fn = _lib()
    _build.check(fn(
        x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(),
        None if counters is None else counters.data_ptr(), m, d, k, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    ), "ff_matmul")
    global launches
    launches += 1
    return out.reshape(x.shape)


def flops(m: int, d: int, k: int) -> float:
    """Operations of one call: up-projection 2·M·D·2K, down 2·M·K·D."""
    return 6.0 * m * d * k


def min_bytes(m: int, d: int, k: int, itemsize: int = 2) -> float:
    """Bytes of one call: x, w1, b1, w2 read once, the output written once."""
    return itemsize * (2.0 * m * d + 3.0 * d * k + 2.0 * k)
