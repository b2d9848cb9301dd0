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
``csrc/quant_matmul.cu`` (64x128 output tiles, int8 ``mma.sync``; see the
note there) or raises.  On a CPU tensor it runs
:func:`quant_matmul_plain`, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build

# the kernel walks K in steps of this many columns
BLOCK_K = 32

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


def _lib():
    fn = _build.library("quant_matmul").tg_quant_matmul_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
    return fn


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[..., K]`` × ``w_q [N, K]`` → ``[..., N]`` in x's dtype; leading
    dims of ``x`` flatten into M."""
    if not x.is_cuda:
        return quant_matmul_plain(x, w_q, w_scale, bias)
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
    _build.check(_lib()(
        x2.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), m, n, k,
        torch.cuda.current_stream(x.device).cuda_stream,
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
