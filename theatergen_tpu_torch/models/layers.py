"""Building blocks of the SD1.5 and SDXL UNets, VAE and text towers
(PyTorch).

Port of the txt2img paths of ``theatergen_tpu/models/layers.py``.  Modules
are NCHW inside and use diffusers' parameter names (``to_q``,
``to_out.0``, ``ff.net.0.proj``, ``time_emb_proj`` …), so
``models/weights.py`` maps the JAX package's trees onto them by name.
Normalisation epsilons follow the JAX package (GroupNorm 1e-5, the
transformer LayerNorms flax's default 1e-6).

Four layers reach a kernel: :class:`FeedForward` (``ops/geglu_matmul``:
``ff_matmul`` when the model's ``fused_ff`` is on and it runs in bf16,
``geglu_matmul`` when it is off, each where the JAX gate takes the
shape), :class:`CrossAttention` (``ops/flash_attention`` for
self-attention where the JAX package reaches a Pallas flash kernel),
:class:`GroupNorm` (``ops/groupnorm`` where ``THEATERGEN_FUSED_GN`` routes
the shape) and, in a model configured ``quantized``, the
:class:`QuantLinear` that :func:`make_linear` builds at the JAX package's
quantized sites (``ops/quant_matmul`` where
``THEATERGEN_FUSED_INT8`` is ``"1"``).  GLIGEN's :class:`GatedSelfAttention`
holds a float FeedForward of its own, so it reaches ``geglu_matmul`` even
in a quantized model.  Everything else is plain PyTorch.
Inside :func:`plain_path` all four take their plain PyTorch route whatever
the model's config and the switches say.

Under a tp mesh (``parallel/mesh.shard_module``) the matched linears
become :class:`ColumnParallelLinear` / :class:`RowParallelLinear` (and
their W8A8 twins :class:`QuantColumnParallel` /
:class:`QuantRowParallel`), each holding its rank's shard under the
unsharded names; an attention holds its rank's heads and gathers the
probabilities it returns, and the FF runs its kernel at inner width K/tp
between the two collectives.  The collectives are
``parallel/collectives.copy_to`` (identity forward, all-reduce backward)
and ``reduce_from`` (all-reduce forward, identity backward), so guidance and
training differentiate through a tp UNet.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention as attn_ops
from ..ops import flash_attention as fa_ops
from ..ops import geglu_matmul as gg_ops
from ..ops import groupnorm as gn_ops
from ..ops import quant as q_ops
from ..ops import quant_matmul as qm_ops
from ..parallel import collectives

# flax nn.LayerNorm's default epsilon, which the JAX package's transformer
# blocks use
LAYER_NORM_EPS = 1e-6

# False inside plain_path(): the layers reach no kernel
_use_kernels = True


@contextlib.contextmanager
def plain_path() -> Iterator[None]:
    """Within the block every layer takes its plain PyTorch route (no
    kernel is launched), whatever ``fused_ff``/``flash_attention``,
    ``THEATERGEN_FUSED_GN`` and ``THEATERGEN_FUSED_INT8`` say — the
    reference a model's kernel path is held against.  A ``QuantLinear``
    keeps its route: at ``"1"`` the kernel's plain version, at ``"0"`` the
    per-tensor route, which reaches no kernel of the repo anyway."""
    global _use_kernels
    prev, _use_kernels = _use_kernels, False
    try:
        yield
    finally:
        _use_kernels = prev


class QuantLinear(nn.Module):
    """W8A8 linear, the JAX package's ``QuantDense``: an int8 ``weight
    [out, in]`` and an fp32 ``scale [out]`` (buffers), a bias in the model
    dtype.  ``.to(dtype)`` and the like cast the bias but never the scale,
    which stays fp32 as in the JAX package.  ``THEATERGEN_FUSED_INT8``
    (``ops.quant.FUSED_MODE``) picks the route: ``"1"``
    ``ops.quant_matmul.quant_matmul`` (per-row scales), ``"0"``
    ``ops.quant.per_tensor_linear``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.zeros(
            out_features, in_features, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def _apply(self, fn, recurse=True):
        scale = self.scale
        super()._apply(fn, recurse)
        if self.scale.dtype != torch.float32:
            # a floating cast reached the scale: keep its fp32 values
            self.scale = scale.to(device=self.scale.device)
        return self

    @torch.no_grad()
    def set_float_weight(self, weight: torch.Tensor) -> None:
        """Quantize a float ``[out, in]`` weight into this layer."""
        q, s = q_ops.quantize_linear_weight(weight)
        self.weight.copy_(q)
        self.scale.copy_(s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if q_ops.FUSED_MODE == "1":
            fn = qm_ops.quant_matmul if _use_kernels else \
                qm_ops.quant_matmul_plain
            return fn(x, self.weight, self.scale, self.bias)
        return q_ops.per_tensor_linear(x, self.weight, self.scale, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


def make_linear(quantized: bool, in_features: int, out_features: int, *,
                bias: bool = True) -> nn.Module:
    """``nn.Linear`` or its W8A8 twin :class:`QuantLinear` (the JAX
    package's ``make_dense``): same name in the state dict, so a model's
    quantized sites are its ``quantized=True`` call sites."""
    if quantized:
        return QuantLinear(in_features, out_features, bias=bias)
    return nn.Linear(in_features, out_features, bias=bias)


class ColumnParallelLinear(nn.Linear):
    """A linear's output rows ``rows`` of ``[out, in]`` (and their bias) on
    this rank; the input is replicated over tp (``copy_to``: its gradient
    is all-reduced)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 mesh, **kw):
        super().__init__(in_features, out_features, bias=bias, **kw)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(collectives.copy_to(x, self.mesh), self.weight,
                        self.bias)


class RowParallelLinear(nn.Linear):
    """A linear's input columns of ``[out, in]`` on this rank: the partial
    products are all-reduced over tp (``reduce_from``), then the whole
    bias is added once."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 mesh, **kw):
        super().__init__(in_features, out_features, bias=bias, **kw)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = collectives.reduce_from(F.linear(x, self.weight), self.mesh)
        return y if self.bias is None else y + self.bias


class QuantColumnParallel(QuantLinear):
    """:class:`QuantLinear` holding output rows: int8 weight, scale and bias
    rows of this rank.  Its input is whole, so both routes' activation
    scales are the unsharded layer's."""


class QuantRowParallel(QuantLinear):
    """:class:`QuantLinear` holding input columns: its int8 weight's columns
    of this rank, the whole per-output scale and bias.  The activation
    scale is the unsharded layer's: the amax (per tensor on the ``"0"``
    route, per row on ``"1"``, where the kernel takes it as
    ``row_amax``) is all-reduced (max) over tp before quantizing.  The
    partial outputs are all-reduced, then the bias is added once."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 mesh):
        super().__init__(in_features, out_features, bias=bias)
        self.mesh = mesh

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.reshape(-1, self.in_features)
        if q_ops.FUSED_MODE == "1":
            # a max of bf16 values is one of them: reduced in bf16, exact
            amax = collectives.all_reduce(self.mesh, xf.abs().amax(-1),
                                          op="max").float()
            fn = qm_ops.quant_matmul if _use_kernels else \
                qm_ops.quant_matmul_plain
            y = fn(x, self.weight, self.scale, None, row_amax=amax)
        else:
            amax = collectives.all_reduce(self.mesh, xf.float().abs().amax(),
                                          op="max")
            y = q_ops.per_tensor_linear(x, self.weight, self.scale, None,
                                        amax=amax)
        y = collectives.reduce_from(y, self.mesh)
        return y if self.bias is None else y + self.bias.to(y.dtype)


@torch.no_grad()
def parallel_linear(old: nn.Module, kind: str, mesh,
                    idx: torch.Tensor) -> nn.Module:
    """``old`` (an ``nn.Linear`` or :class:`QuantLinear`) as a ``kind``
    ("column", "geglu" or "row") tp layer holding the rows (column kinds)
    or input columns ("row") ``idx`` of its ``[out, in]`` weight, on
    ``old``'s device and in its dtypes."""
    w, b = old.weight, old.bias
    quant = isinstance(old, QuantLinear)
    idx = idx.to(w.device)
    if kind == "row":
        w = w.index_select(1, idx).contiguous()
        if quant:
            new = QuantRowParallel(len(idx), old.out_features, b is not None,
                                   mesh)
            new.scale = old.scale.clone()
        else:
            new = RowParallelLinear(len(idx), old.out_features,
                                    b is not None, mesh, device="meta")
    else:
        w = w.index_select(0, idx).contiguous()
        b = None if b is None else b.index_select(0, idx)
        if quant:
            new = QuantColumnParallel(old.in_features, len(idx),
                                      b is not None)
            new.scale = old.scale.index_select(0, idx).contiguous()
        else:
            new = ColumnParallelLinear(old.in_features, len(idx),
                                       b is not None, mesh, device="meta")
    if quant:
        new.weight = w
    else:
        new.weight = nn.Parameter(w, requires_grad=old.weight.requires_grad)
    if b is not None:
        new.bias = nn.Parameter(b.clone(), requires_grad=b.requires_grad)
    return new


def get_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal timestep embedding ``[B] → [B, dim]`` (fp32), diffusers
    convention."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """MLP on the sinusoidal embedding: linear_1 → silu → linear_2."""

    def __init__(self, in_dim: int, dim: int, quantized: bool = False):
        super().__init__()
        self.linear_1 = make_linear(quantized, in_dim, dim)
        self.linear_2 = make_linear(quantized, dim, dim)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(emb)))


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NCHW with an optional fused SiLU.

    ``fp32=True`` normalises an fp32 copy and casts back (the JAX package's
    ``dtype=None``); otherwise the norm runs in the input's dtype, as the
    JAX package's ``fast_norm`` does.  In the model dtype, where the
    ``THEATERGEN_FUSED_GN`` switch routes the shape
    (``ops.groupnorm.routes``: the JAX gate of ``layers.py:116-122``), the
    norm and its SiLU are one ``ops.groupnorm.fused_group_norm`` call,
    which rounds once, after the SiLU."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-5,
                 act: Optional[str] = None, fp32: bool = True):
        super().__init__(num_groups, channels, eps=eps)
        if act not in (None, "silu"):
            raise ValueError(
                f"unsupported act {act!r}; expected None or 'silu'")
        self.act = act
        self.fp32 = fp32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (_use_kernels and not self.fp32 and x.dtype == self.weight.dtype
                and gn_ops.routes(x.shape, x.dtype, self.num_groups)):
            return gn_ops.fused_group_norm(
                x, self.weight, self.bias, num_groups=self.num_groups,
                eps=self.eps, act=self.act)
        if self.fp32:
            out = F.group_norm(x.float(), self.num_groups,
                               self.weight.float(), self.bias.float(),
                               self.eps).to(x.dtype)
        else:
            out = F.group_norm(x, self.num_groups, self.weight.to(x.dtype),
                               self.bias.to(x.dtype), self.eps)
        return F.silu(out) if self.act == "silu" else out


class ResnetBlock2D(nn.Module):
    """GN → silu → conv → (+temb) → GN → silu → conv, with a 1×1 shortcut
    on a channel change."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, groups: int = 32,
                 fast_norm: bool = False, quantized: bool = False):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, act="silu",
                               fp32=not fast_norm)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (
            make_linear(quantized, temb_channels, out_channels)
            if temb_channels is not None else None)
        self.norm2 = GroupNorm(groups, out_channels, act="silu",
                               fp32=not fast_norm)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class GEGLU(nn.Module):
    """``proj`` to ``[value ‖ gate]``, then ``value · gelu(gate)`` (erf)."""

    def __init__(self, dim_in: int, dim_out: int, quantized: bool = False):
        super().__init__()
        self.proj = make_linear(quantized, dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU → down projection (``net.0`` / ``net.2``).

    With bf16 activations, as the JAX package's ``layers.py:235-254`` gates
    it: with ``fused_ff`` and a shape ``ops.geglu_matmul.ff_supported``
    takes, the whole FF is one ``ff_matmul`` call; otherwise, where
    ``ops.geglu_matmul.supported`` takes it, the up-projection is a plain
    linear and the gate and down-projection one ``geglu_matmul`` call
    (the gates are the JAX package's block searches, so both packages
    route the same sites: SD1.5's mid block at 768 px, 288 rows, takes
    neither).  On the card a width without a kernel instance raises there
    rather than running the plain path.  fp32 and :func:`plain_path` take
    the plain path.  A ``quantized`` FF is never fused (JAX
    ``layers.py:235-258``): ``net.2(GEGLU(x))`` with both layers
    ``QuantLinear``."""

    def __init__(self, dim: int, mult: int = 4, fused_ff: bool = False,
                 quantized: bool = False):
        super().__init__()
        self.fused_ff, self.quantized = fused_ff, quantized
        self.net = nn.ModuleList(
            [GEGLU(dim, dim * mult, quantized), nn.Identity(),
             make_linear(quantized, dim * mult, dim)])

    # the tp mesh of a sharded FF (parallel/mesh.shard_module), else None
    tp_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        geglu, down = self.net[0], self.net[2]
        if (self.quantized or not _use_kernels
                or x.dtype != torch.bfloat16):
            return down(geglu(x))
        d, k = x.shape[-1], down.in_features
        m = x.numel() // d
        if self.fused_ff and gg_ops.ff_supported(m, d, k):
            if self.tp_mesh is not None:
                x = collectives.copy_to(x, self.tp_mesh)
            out = gg_ops.ff_matmul(x, geglu.proj.weight, geglu.proj.bias,
                                   down.weight)
        elif gg_ops.supported(m, k, d):
            out = gg_ops.geglu_matmul(geglu.proj(x), down.weight)
        else:
            return down(geglu(x))
        if self.tp_mesh is not None:
            # the partial sums of this rank's K/tp inner columns
            out = collectives.reduce_from(out, self.tp_mesh)
        return out + down.bias


class CrossAttention(nn.Module):
    """Attention with diffusers' projections (no-bias q/k/v, biased out).

    Self-attention (``context is None``) in bf16 where the JAX package
    reaches a Pallas flash kernel (``ops.flash_attention.route``: 1024..
    32768 tokens in steps of 512, within the TPU blocks' budget, under the
    JAX package's flash switches; a quantized layer skips the packed
    route, as there) takes ``ops.flash_attention`` on that route, which
    raises on the card for a head dim it has no kernel instance for;
    every other self-attention, and every call inside :func:`plain_path`,
    takes ``ops.attention.multi_head_attention``.

    With ``ip_tokens > 0`` the last ``ip_tokens`` rows of a context are
    image tokens with their own ``to_k_ip``/``to_v_ip`` projections, and
    the call is ``ops.attention.decoupled_attention`` scaled by
    ``ip_scale`` (the JAX package's ``layers.py:346-362``).  A call with a
    context that ``ops.attention.cross_routes`` takes (bf16, no
    probabilities, the kernel's key counts and head dims) goes to
    ``ops.attention.cross_attention`` instead, the text and IP branches in
    one kernel launch on the card.  With ``return_probs`` the call returns
    ``(out, probs [B, H, Lq, Lk])``, the probabilities of the (text)
    context, and takes neither kernel."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 context_dim: Optional[int] = None, use_flash: bool = True,
                 ip_tokens: int = 0, quantized: bool = False):
        super().__init__()
        inner = heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.heads, self.head_dim, self.use_flash = heads, head_dim, use_flash
        self.ip_tokens, self.quantized = ip_tokens, quantized

        def proj(din, dout):
            return make_linear(quantized, din, dout, bias=False)

        self.to_q = proj(query_dim, inner)
        self.to_k = proj(context_dim, inner)
        self.to_v = proj(context_dim, inner)
        if ip_tokens:
            self.to_k_ip = proj(context_dim, inner)
            self.to_v_ip = proj(context_dim, inner)
        self.to_out = nn.ModuleList([make_linear(quantized, inner, query_dim),
                                     nn.Identity()])

    # the tp mesh of a sharded attention (parallel/mesh.shard_module: it
    # holds heads / tp heads), else None
    tp_mesh = None

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None, *,
                ip_scale=1.0, return_probs: bool = False):
        b, lq, _ = x.shape
        ctx = x if context is None else context
        shape = (b, -1, self.heads, self.head_dim)
        q = self.to_q(x).view(shape)
        k_ip = v_ip = None
        if self.ip_tokens and context is not None:
            text_len = ctx.shape[1] - self.ip_tokens
            text, image = ctx[:, :text_len], ctx[:, text_len:]
            k, v = self.to_k(text).view(shape), self.to_v(text).view(shape)
            k_ip = self.to_k_ip(image).view(shape)
            v_ip = self.to_v_ip(image).view(shape)
        else:
            k = self.to_k(ctx).view(shape)
            v = self.to_v(ctx).view(shape)
        if (context is not None and _use_kernels and attn_ops.cross_routes(
                q, k, k_ip, ip_scale, return_probs=return_probs)):
            res = attn_ops.cross_attention(q, k, v, k_ip, v_ip, ip_scale)
        elif k_ip is not None:
            res = attn_ops.decoupled_attention(q, k, v, k_ip, v_ip, ip_scale,
                                               return_probs=return_probs)
        else:
            route = None
            if (context is None and self.use_flash and _use_kernels
                    and not return_probs and x.dtype == torch.bfloat16):
                route = fa_ops.route(lq, lq, self.heads, self.head_dim,
                                     x.element_size(), self.quantized)
            if route is not None:
                res = fa_ops.flash_attention(q, k, v, route=route)
            else:
                res = attn_ops.multi_head_attention(
                    q, k, v, return_probs=return_probs)
        out, probs = res if return_probs else (res, None)
        if probs is not None and self.tp_mesh is not None:
            # every head's probabilities, as the unsharded layer returns
            probs = collectives.gather_from(probs, self.tp_mesh, dim=1)
        out = self.to_out[0](out.reshape(b, lq, -1))
        return (out, probs) if return_probs else out


class GatedSelfAttention(nn.Module):
    """GLIGEN's gated self-attention fuser, the JAX package's
    ``GatedSelfAttention`` under diffusers' ``GatedSelfAttentionDense``
    names (``linear``, ``attn``, ``ff``, ``norm1``, ``norm2``,
    ``alpha_attn``, ``alpha_dense``).  ``objs [B, N, context_dim]``
    (``models/ip_adapter.PositionNet``'s tokens) are projected to the
    visual width, the visual tokens self-attend jointly with them (the
    plain attention, ``use_flash=False``, as in the JAX package), and a
    FeedForward follows; each branch is added through ``tanh(alpha)``,
    zero at init, so the fuser is an exact identity until GLIGEN weights
    load.  Both gates are applied in x's dtype.  The fuser is never
    quantized, and its FF is the default one (no ``fused_ff``), so in bf16
    it reaches ``geglu_matmul`` where ``ops.geglu_matmul.supported`` takes
    the shape, as JAX ``layers.py:246-254`` does."""

    # seeded init (pipelines/bundle._seeded_init) leaves the gates at zero
    init_std = 0.0

    def __init__(self, dim: int, heads: int, head_dim: int,
                 context_dim: int):
        super().__init__()
        self.linear = nn.Linear(context_dim, dim)
        self.attn = CrossAttention(dim, heads, head_dim, use_flash=False)
        self.ff = FeedForward(dim)
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.alpha_attn = nn.Parameter(torch.zeros(()))
        self.alpha_dense = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor, objs: torch.Tensor) -> torch.Tensor:
        n_visual = x.shape[1]
        objs = self.linear(objs.to(x.dtype))
        h = self.attn(self.norm1(torch.cat([x, objs], dim=1)))
        x = x + torch.tanh(self.alpha_attn).to(x.dtype) * h[:, :n_visual]
        h = self.ff(self.norm2(x))
        return x + torch.tanh(self.alpha_dense).to(x.dtype) * h


class BasicTransformerBlock(nn.Module):
    """self-attn → cross-attn → FF, each behind a pre-LayerNorm.  With
    ``capture_probs`` returns ``(x, probs)``, the cross-attention's
    probabilities (the JAX package's sown ``cross_attn_probs``).  Built
    with ``gligen``, it holds a :class:`GatedSelfAttention` ``fuser``,
    which runs between the self- and the cross-attention where ``objs``
    are given (JAX ``layers.py:465-467``)."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 use_flash: bool = True, fused_ff: bool = False,
                 ip_tokens: int = 0, quantized: bool = False,
                 gligen: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn1 = CrossAttention(dim, heads, head_dim, use_flash=use_flash,
                                    quantized=quantized)
        if gligen:
            self.fuser = GatedSelfAttention(dim, heads, head_dim, context_dim)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn2 = CrossAttention(dim, heads, head_dim, context_dim,
                                    use_flash=use_flash, ip_tokens=ip_tokens,
                                    quantized=quantized)
        self.norm3 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.ff = FeedForward(dim, fused_ff=fused_ff, quantized=quantized)

    def forward(self, x: torch.Tensor, context: torch.Tensor, *,
                ip_scale=1.0, capture_probs: bool = False,
                objs: Optional[torch.Tensor] = None):
        x = x + self.attn1(self.norm1(x))
        if objs is not None:
            x = self.fuser(x, objs)
        h = self.attn2(self.norm2(x), context, ip_scale=ip_scale,
                       return_probs=capture_probs)
        h, probs = h if capture_probs else (h, None)
        x = x + h
        x = x + self.ff(self.norm3(x))
        return (x, probs) if capture_probs else x


class Transformer2D(nn.Module):
    """GN → 1×1 proj_in → transformer blocks over flattened space →
    1×1 proj_out, plus the residual.  With ``capture_layers`` (block
    indices) returns ``(out, {index: probs [B, heads, HW, Lk]})``; the
    other blocks' probabilities are never kept.  ``objs`` (GLIGEN's
    grounding tokens) reach every block's fuser."""

    def __init__(self, channels: int, heads: int, head_dim: int,
                 context_dim: int, depth: int = 1, groups: int = 32,
                 fast_norm: bool = False, use_flash: bool = True,
                 fused_ff: bool = False, ip_tokens: int = 0,
                 quantized: bool = False, gligen: bool = False):
        super().__init__()
        self.norm = GroupNorm(groups, channels, fp32=not fast_norm)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, heads, head_dim, context_dim,
                                  use_flash=use_flash, fused_ff=fused_ff,
                                  ip_tokens=ip_tokens, quantized=quantized,
                                  gligen=gligen)
            for _ in range(depth)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor, *,
                ip_scale=1.0, capture_layers: Tuple[int, ...] = (),
                objs: Optional[torch.Tensor] = None):
        b, c, h, w = x.shape
        y = self.proj_in(self.norm(x))
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        captured = {}
        for i, block in enumerate(self.transformer_blocks):
            if i in capture_layers:
                y, captured[i] = block(y, context, ip_scale=ip_scale,
                                       capture_probs=True, objs=objs)
            else:
                y = block(y, context, ip_scale=ip_scale, objs=objs)
        y = y.reshape(b, h, w, c).permute(0, 3, 1, 2)
        out = self.proj_out(y) + x
        return (out, captured) if capture_layers else out
