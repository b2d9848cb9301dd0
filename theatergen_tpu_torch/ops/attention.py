"""Attention outside the flash kernel's domain: cross-attention (Sk = 77,
or 77 + the IP tokens), self-attention at 256 and 64 tokens, the VAE mid
block and the CLIP towers.  Counterpart of
``theatergen_tpu/ops/attention.py::{attention_probs, multi_head_attention,
decoupled_attention}``, which left these shapes to XLA; here they are a
plain fp32 matmul + softmax.  Library attention stays out of the port.

The denoisers' cross-attention, where :func:`cross_routes` takes the call
(``models/layers.CrossAttention``), goes to :func:`cross_attention`: on a
CUDA tensor the hand-written kernel of ``csrc/cross_attention.cu`` (the
text branch, the optional IP branch and their weighted sum in one pass;
see the note there), else :func:`cross_attention_plain`, which is
:func:`multi_head_attention` or :func:`decoupled_attention`.  XLA fused
these shapes on the TPU, so the kernel replaces no Pallas kernel; eager
PyTorch runs the plain chain as some two dozen kernels with fp32 copies
of q and of the logits.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import _build
from . import recompute

# head dims with a compiled instance of the cross-attention kernel, and
# the most text and IP keys it holds (csrc/cross_attention.cu)
CROSS_HEAD_DIMS = (40, 64, 80, 160)
CROSS_MAX_KEYS = 128
CROSS_MAX_IP_KEYS = 16
# the kernel's q rows per tile, and the CTAs an SM holds at once
CROSS_Q_BLOCK = 128
SMS = 132
LOG2E = 1.4426950408889634

launches_cross = 0


def attention_probs(q: torch.Tensor, k: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax probabilities ``[B, H, Sq, Sk]`` in fp32 of BSHD q and k.

    ``mask`` (broadcastable to ``[B, H, Sq, Sk]``, True = attend) drops
    logits where it is False."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * d ** -0.5, k.float())
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, mask: Optional[torch.Tensor] = None,
                         return_probs: bool = False):
    """BSHD attention ``[B, Sq, H, D] x [B, Sk, H, D] → [B, Sq, H, D]``.

    Logits and probabilities are fp32; the output takes q's dtype.  With
    ``return_probs`` returns ``(out, probs [B, H, Sq, Sk])``."""
    p = attention_probs(q, k, mask)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
    return (out, p) if return_probs else out


def decoupled_attention(q: torch.Tensor, k_text: torch.Tensor,
                        v_text: torch.Tensor, k_ip: torch.Tensor,
                        v_ip: torch.Tensor, ip_scale, *,
                        return_probs: bool = False):
    """IP-Adapter decoupled cross-attention:
    ``Attn(q, k_text, v_text) + ip_scale · Attn(q, k_ip, v_ip)``, the image
    branch an explicit fp32 softmax over the few IP keys.  ``ip_scale`` is
    a float or a 0-dim tensor (one tensor serves a DB hit and a miss with
    no host round trip), or a ``[B]`` tensor, one scale per batch row,
    broadcast over tokens and heads (a batch of characters, DB hits and
    misses together).  With ``return_probs`` returns ``(out, probs)``,
    the probabilities of the text branch only."""
    res = multi_head_attention(q, k_text, v_text, return_probs=return_probs)
    out_text, probs = res if return_probs else (res, None)
    out_ip = multi_head_attention(q, k_ip, v_ip)
    if torch.is_tensor(ip_scale) and ip_scale.ndim == 1:
        ip_scale = ip_scale.view(-1, 1, 1, 1).to(out_ip.dtype)
    out = out_text + ip_scale * out_ip
    return (out, probs) if return_probs else out


def cross_routes(q: torch.Tensor, k: torch.Tensor,
                 k_ip: Optional[torch.Tensor] = None, ip_scale=None, *,
                 return_probs: bool = False) -> bool:
    """Whether a cross-attention call takes :func:`cross_attention`: bf16
    q and keys, no probabilities asked for, at most
    ``CROSS_MAX_KEYS`` text and ``CROSS_MAX_IP_KEYS`` IP keys, a head dim
    with a kernel instance, and an IP scale that records no gradient.
    Where the call's tensors lie is the wrapper's to decide: it launches
    the kernel on the card and runs the plain version elsewhere."""
    keys = [k] if k_ip is None else [k, k_ip]
    return (not return_probs
            and all(t.dtype == torch.bfloat16 for t in [q] + keys)
            and q.shape[-1] in CROSS_HEAD_DIMS
            and 0 < k.shape[1] <= CROSS_MAX_KEYS
            and (k_ip is None or 0 < k_ip.shape[1] <= CROSS_MAX_IP_KEYS)
            and not (torch.is_tensor(ip_scale) and ip_scale.requires_grad))


def cross_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_ip: Optional[torch.Tensor] = None,
                          v_ip: Optional[torch.Tensor] = None,
                          ip_scale=1.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch: :func:`multi_head_attention`
    without IP keys, else :func:`decoupled_attention`."""
    if k_ip is None:
        return multi_head_attention(q, k, v)
    return decoupled_attention(q, k, v, k_ip, v_ip, ip_scale)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_ip: Optional[torch.Tensor] = None,
                    v_ip: Optional[torch.Tensor] = None,
                    ip_scale=1.0) -> torch.Tensor:
    """Cross-attention ``q [B, Sq, H, D]`` against text keys ``k, v [B,
    Sk, H, D]`` and, with ``k_ip``/``v_ip [B, Si, H, D]``, the IP branch
    weighted by ``ip_scale`` (a float, a 0-dim tensor or ``[B]``, as
    :func:`decoupled_attention` takes it) → ``[B, Sq, H, D]`` contiguous.
    On a CUDA tensor one launch of the kernel (counted on
    ``launches_cross``), through :class:`CrossAttentionFn` under autograd;
    elsewhere :func:`cross_attention_plain`."""
    if not q.is_cuda:
        return cross_attention_plain(q, k, v, k_ip, v_ip, ip_scale)
    if recompute.needs_grad(q, k, v, k_ip, v_ip):
        return CrossAttentionFn.apply(q, k, v, k_ip, v_ip, ip_scale)
    return _launch_cross(q, k, v, k_ip, v_ip, ip_scale)


class CrossAttentionFn(torch.autograd.Function):
    """The kernel's forward, and the gradient of
    :func:`cross_attention_plain` recomputed from the saved inputs
    (``ip_scale`` a constant)."""

    @staticmethod
    def forward(ctx, q, k, v, k_ip, v_ip, ip_scale):
        ctx.save_for_backward(q, k, v, k_ip, v_ip)
        ctx.ip_scale = ip_scale
        return _launch_cross(q, k, v, k_ip, v_ip, ip_scale)

    @staticmethod
    def backward(ctx, grad_out):
        return recompute.plain_vjp(
            cross_attention_plain, ctx.saved_tensors,
            ctx.needs_input_grad[:5], grad_out,
            ip_scale=ctx.ip_scale) + (None,)


def cross_plan(b: int, sq: int, h: int, d: int) -> dict:
    """The kernel's launch for q ``[B, Sq, H, D]``: q tiles of 128 rows;
    each CTA streams a run of ``tiles_per_cta`` of one (batch, head) past
    its K and V, the longest power-of-two run that divides the head's
    tiles and still leaves about four CTAs for each one the card holds at
    once (two an SM at d <= 64, one above)."""
    ntiles = -(-sq // CROSS_Q_BLOCK)
    resident = SMS * (2 if d <= 64 else 1)
    want = max(1, ntiles * b * h // (4 * resident))
    run = 1
    while run * 2 <= want and ntiles % (run * 2) == 0:
        run *= 2
    return dict(q_block=CROSS_Q_BLOCK, tiles_per_cta=run,
                ctas=b * h * -(-ntiles // run))


def _lib():
    lib = _build.library("cross_attention")
    fn = lib.tg_cross_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 15
                       + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_void_p])
    return fn


def _check_operand(name: str, x: torch.Tensor, shape) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"cross_attention: {name} must be bfloat16, "
                        f"got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"cross_attention: {name} shape {tuple(x.shape)} "
                         f"!= {tuple(shape)}")
    if (not x.is_cuda or x.stride(3) != 1
            or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16):
        raise ValueError(f"cross_attention: {name} needs a CUDA tensor with "
                         f"unit stride on D, other strides a multiple of 8 "
                         f"and a 16-byte aligned base (strides {x.stride()})")


def _scale_args(ip_scale, b: int, device) -> tuple:
    """(the scales as a device fp32 tensor or None, its stride, the value,
    round to bf16): a CUDA tensor is read on the device and rounded to
    bf16, as the plain version's product rounds it; a number or a 0-dim
    CPU tensor is passed by value, unrounded, as a CPU scalar enters that
    product."""
    if torch.is_tensor(ip_scale) and (ip_scale.ndim or ip_scale.is_cuda):
        s = ip_scale.to(device=device, dtype=torch.float32)
        if s.ndim and tuple(s.shape) not in ((b,), (1,)):
            raise ValueError(f"cross_attention: ip_scale shape "
                             f"{tuple(s.shape)}, want (), (1,) or ({b},)")
        return s, s.stride(0) if s.numel() > 1 else 0, 0.0, 1
    return None, 0, float(ip_scale), 0


def _launch_cross(q, k, v, k_ip, v_ip, ip_scale) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    si = 0 if k_ip is None else k_ip.shape[1]
    if d not in CROSS_HEAD_DIMS:
        raise ValueError(f"cross_attention: head dim {d} has no kernel "
                         f"instance (have {CROSS_HEAD_DIMS})")
    if not 0 < sk <= CROSS_MAX_KEYS:
        raise ValueError(f"cross_attention: {sk} text keys (1.."
                         f"{CROSS_MAX_KEYS})")
    if k_ip is not None and not 0 < si <= CROSS_MAX_IP_KEYS:
        raise ValueError(f"cross_attention: {si} IP keys (1.."
                         f"{CROSS_MAX_IP_KEYS})")
    _check_operand("q", q, (b, sq, h, d))
    for name, x in (("k", k), ("v", v)):
        _check_operand(name, x, (b, sk, h, d))
    if k_ip is not None:
        for name, x in (("k_ip", k_ip), ("v_ip", v_ip)):
            _check_operand(name, x, (b, si, h, d))
    # the scales' tensor stays referenced until the launch is queued
    scale, stride, value, rnd = _scale_args(ip_scale, b, q.device) \
        if k_ip is not None else (None, 0, 0.0, 0)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    ki, vi = (k, v) if k_ip is None else (k_ip, v_ip)
    plan = cross_plan(b, sq, h, d)
    _build.check(_lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ki.data_ptr(),
        vi.data_ptr(), out.data_ptr(), b, sq, sk, si, h, d,
        80 if sk <= 80 else 128, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], *ki.stride()[:3], *vi.stride()[:3],
        plan["tiles_per_cta"], d ** -0.5 * LOG2E,
        None if scale is None else scale.data_ptr(), stride, value, rnd,
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "cross_attention")
    global launches_cross
    launches_cross += 1
    return out


def cross_flops(b: int, sq: int, h: int, d: int, sk: int,
                si: int = 0) -> float:
    """Operations of one call: QKᵀ and PV over the text and IP keys,
    2·Sq·(Sk + Si)·d multiply-adds each (the lo term of P not counted)."""
    return 4.0 * b * h * sq * (sk + si) * d


def cross_min_bytes(b: int, sq: int, h: int, d: int, sk: int, si: int = 0,
                    itemsize: int = 2) -> float:
    """Bytes of one call: q read and the output written once, K and V
    (text and IP) read once."""
    return itemsize * b * h * d * (2.0 * sq + 2.0 * (sk + si))
