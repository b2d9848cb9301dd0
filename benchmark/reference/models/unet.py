"""SD-style conditional UNet (PyTorch, NCHW), the port of
``theatergen_tpu/models/unet.py::UNet2DCondition`` on the SD1.5 and SDXL
txt2img paths and the IP-Adapter character pass.

Parameter names are diffusers' (``down_blocks.0.attentions.1.
transformer_blocks.0.attn1.to_q.weight`` …).  The forward takes
``(sample [B, C, H, W], timesteps [B] or scalar, context [B, L, C_ctx])``,
plus SDXL's ``pooled_text [B, P]`` and ``time_ids [B, 6]`` where the config
has ``addition_embed_type="text_time"``, and returns the eps prediction
``[B, out_channels, H, W]`` in the model dtype.

With ``cfg.ip_num_tokens > 0`` every cross-attention splits the last
``ip_num_tokens`` context rows off as IP-Adapter image tokens, weighted by
``ip_scale`` (a float, a 0-dim tensor, or a ``[B]`` tensor of one scale
per row).  ``capture_keys`` names
cross-attention layers in the JAX package's 4-tuple form
``(place, block_index, attention_index, layer)``; with any given the
forward returns ``(eps, {key: probs [B, heads, HW, Lk]})`` and keeps no
other layer's probabilities.  With ``cfg.quantized`` the linears the JAX
package quantizes (attention projections, the FF, ``time_emb_proj`` and
``time_embedding``; not SDXL's ``add_embedding``) are W8A8
``layers.QuantLinear``s.  ``down_residuals`` (one per skip) and
``mid_residual``, a ControlNet's outputs, are added to the skips and to
the mid block's output.  DeepCache's cached and shallow forwards are
``forward``'s ``return_deep_cache``/``deep_cache``.  ``level_residuals``
(one per level, a T2I-Adapter's features) are added to the hidden state
at the end of each encoder level, after its last skip and before its
downsampler.

GLIGEN: ``UNet2DCondition(cfg, gligen=True)`` gives every transformer
block a gated self-attention ``fuser`` (``layers.GatedSelfAttention``,
float even in a quantized UNet, as in the JAX package), and ``forward``'s
``objs [B, N, cross_attention_dim]`` (``ip_adapter.PositionNet``'s
grounding tokens) reach each of them, in the encoder, the mid block and
the up blocks, in the full and the DeepCache shallow forward alike.  The
JAX package creates the fusers where ``init`` sees ``objs``; a module
here needs its parameters up front, so they come from the constructor
(no config field: the JAX config has none).  Without ``objs`` a GLIGEN
UNet is the plain one.  ``objs`` given to a UNet built without fusers,
and a state dict holding fusers loaded into one, raise ``ValueError``.

:class:`UNetEncoder` holds ``conv_in``, the time embedding, the down
blocks and the mid block, and runs them; the UNet and
``models/controlnet.py::ControlNet`` both build on it, as the JAX
package's ``UNetEncoder``/``UNetMid`` are shared.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..config import UNetConfig
from .layers import (
    Downsample2D, GroupNorm, ResnetBlock2D, TimestepEmbedding, Transformer2D,
    Upsample2D, timestep_embedding,
)

AttnKey = Tuple[str, int, int, int]


def _captures(capture_keys: Sequence[AttnKey], place: str, block: int,
              attn_idx: int) -> Tuple[int, ...]:
    """Transformer-block layer indices to capture at this attention module
    (the keys' 4th field)."""
    return tuple(k[3] for k in capture_keys
                 if k[0] == place and k[1] == block and k[2] == attn_idx)


class UNetBlock(nn.Module):
    """One level: resnets, optional attentions, optional down/upsampler."""

    def __init__(self):
        super().__init__()
        self.resnets = nn.ModuleList()
        self.attentions = nn.ModuleList()


class UNetEncoder(nn.Module):
    """``conv_in``, ``time_embedding``, the down blocks and the mid block
    under diffusers' names.  The UNet (``unet=True``) quantizes the time
    embedding where ``cfg.quantized`` and adds SDXL's ``add_embedding``
    where the config asks for it; the JAX ControlNet has neither."""

    def __init__(self, cfg: UNetConfig, unet: bool = True,
                 gligen: bool = False):
        super().__init__()
        self.cfg = cfg
        self.gligen = gligen
        boc = cfg.block_out_channels
        n = len(boc)
        self.time_dim = boc[0] * cfg.time_embed_mult
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(
            boc[0], self.time_dim, quantized=cfg.quantized and unet)
        if unet and cfg.addition_embed_type == "text_time":
            # SDXL micro-conditioning over [pooled ++ sinusoids(time_ids)]
            # (never quantized, as in the JAX package)
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, self.time_dim)
        # channels of each skip the down path leaves for the up path
        self.skip_channels = [boc[0]]
        h_ch = boc[0]
        self.down_blocks = nn.ModuleList()
        for i, ch in enumerate(boc):
            blk = UNetBlock()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(self._resnet(h_ch, ch))
                h_ch = ch
                if cfg.attention_levels[i]:
                    blk.attentions.append(self._transformer(i, ch))
                self.skip_channels.append(ch)
            if i < n - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(ch)])
                self.skip_channels.append(ch)
            self.down_blocks.append(blk)
        self.mid_block = UNetBlock()
        self.mid_block.resnets.extend([self._resnet(boc[-1], boc[-1]),
                                       self._resnet(boc[-1], boc[-1])])
        self.mid_block.attentions.append(self._transformer(n - 1, boc[-1]))

    def _resnet(self, cin: int, cout: int) -> ResnetBlock2D:
        cfg = self.cfg
        return ResnetBlock2D(cin, cout, self.time_dim,
                             groups=cfg.norm_num_groups,
                             fast_norm=cfg.fast_norm, quantized=cfg.quantized)

    def _transformer(self, level: int, ch: int) -> Transformer2D:
        cfg = self.cfg
        heads = cfg.heads_at(level)
        return Transformer2D(
            ch, heads, ch // heads, cfg.cross_attention_dim,
            depth=cfg.depth_at(level), groups=cfg.norm_num_groups,
            fast_norm=cfg.fast_norm, use_flash=cfg.flash_attention,
            fused_ff=cfg.fused_ff, ip_tokens=cfg.ip_num_tokens,
            quantized=cfg.quantized, gligen=self.gligen)

    @property
    def dtype(self) -> torch.dtype:
        return self.conv_in.weight.dtype

    def embed_time(self, timesteps: torch.Tensor, batch: int) -> torch.Tensor:
        """``[B]`` or scalar timesteps → ``[batch, time_dim]`` embedding."""
        if timesteps.ndim == 0:
            timesteps = timesteps[None]
        temb = timestep_embedding(timesteps, self.cfg.block_out_channels[0])
        temb = self.time_embedding(temb.to(self.dtype))
        return temb.expand(batch, -1) if temb.shape[0] != batch else temb

    def encode(self, h: torch.Tensor, temb: torch.Tensor, attend,
               cond_hint: Optional[torch.Tensor] = None,
               max_level: Optional[int] = None,
               level_residuals: Optional[Sequence[torch.Tensor]] = None):
        """conv_in (plus a ControlNet's ``cond_hint`` right after it) and
        the down blocks; ``attend(module, h, place, block, index)`` runs
        each transformer.  ``max_level`` stops after that many levels,
        without their last downsampler (a DeepCache shallow forward).
        ``level_residuals[i]`` is added to ``h`` at the end of level ``i``
        (after its skips, so they stay without it; before its
        downsampler), for each level that runs.  Returns ``(h, skips)``."""
        h = self.conv_in(h)
        if cond_hint is not None:
            h = h + cond_hint.to(h.dtype)
        skips = [h]
        blocks = self.down_blocks[:max_level]
        for i, blk in enumerate(blocks):
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = attend(blk.attentions[j], h, "down", i, j)
                skips.append(h)
            if level_residuals is not None and i < len(level_residuals):
                h = h + level_residuals[i].to(h.dtype)
            if hasattr(blk, "downsamplers") and i < len(blocks) - 1:
                h = blk.downsamplers[0](h)
                skips.append(h)
        return h, skips

    def middle(self, h: torch.Tensor, temb: torch.Tensor,
               attend) -> torch.Tensor:
        h = self.mid_block.resnets[0](h, temb)
        h = attend(self.mid_block.attentions[0], h, "mid", 0, 0)
        return self.mid_block.resnets[1](h, temb)


def attender(context: torch.Tensor, ip_scale=1.0,
             capture_keys: Sequence[AttnKey] = (),
             captured: Optional[Dict[AttnKey, torch.Tensor]] = None,
             objs: Optional[torch.Tensor] = None):
    """The ``attend`` of :meth:`UNetEncoder.encode`: runs a transformer on
    ``context`` (and GLIGEN's ``objs``), keeping the probabilities of the
    ``capture_keys`` layers in ``captured``."""
    def attend(module, h, place, block, idx):
        layers = _captures(capture_keys, place, block, idx)
        if not layers:
            return module(h, context, ip_scale=ip_scale, objs=objs)
        h, probs = module(h, context, ip_scale=ip_scale,
                          capture_layers=layers, objs=objs)
        for key in capture_keys:
            if tuple(key[:3]) == (place, block, idx):
                captured[tuple(key)] = probs[key[3]]
        return h
    return attend


class UNet2DCondition(UNetEncoder):
    def __init__(self, cfg: UNetConfig, gligen: bool = False):
        if cfg.addition_embed_type not in (None, "text_time"):
            raise ValueError(f"unknown addition_embed_type "
                             f"{cfg.addition_embed_type!r}")
        super().__init__(cfg, gligen=gligen)
        boc = cfg.block_out_channels
        n = len(boc)
        skip_channels = list(self.skip_channels)
        h_ch = boc[-1]
        self.up_blocks = nn.ModuleList()
        for idx in range(n):
            i = n - 1 - idx
            ch = boc[i]
            blk = UNetBlock()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(self._resnet(h_ch + skip_channels.pop(),
                                                ch))
                h_ch = ch
                if cfg.attention_levels[i]:
                    blk.attentions.append(self._transformer(i, ch))
            if idx < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[0],
                                       act="silu", fp32=not cfg.fast_norm)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def load_state_dict(self, state_dict, strict: bool = True, **kw):
        fusers = [k for k in state_dict if ".fuser." in k]
        if fusers and not self.gligen:
            raise ValueError(
                f"state dict holds GLIGEN fuser weights ({fusers[0]}, "
                f"{len(fusers)} in all), but this UNet was built "
                f"without fusers: build it with gligen=True")
        quantized = [k for k in fusers if k.endswith(".scale")]
        if quantized:
            # ops.quant.quantize_state_dict matches the fusers' attention
            # and FF by name, as the JAX package's quantize_params does;
            # both packages build the fusers float, so neither runs such
            # a tree
            raise ValueError(
                f"state dict quantizes GLIGEN fuser linears "
                f"({quantized[0]}, {len(quantized)} in all), but the "
                f"fusers are float in every UNet")
        return super().load_state_dict(state_dict, strict=strict, **kw)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, *, ip_scale=1.0,
                capture_keys: Sequence[AttnKey] = (),
                pooled_text: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None,
                down_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_residual: Optional[torch.Tensor] = None,
                level_residuals: Optional[Sequence[torch.Tensor]] = None,
                deep_cache: Optional[torch.Tensor] = None,
                return_deep_cache: bool = False, cache_level: int = 1,
                objs: Optional[torch.Tensor] = None):
        """DeepCache (arXiv 2312.00858), as the JAX package's UNet:

        - ``return_deep_cache=True``: the full forward, returning ``(eps,
          cache)`` (before the captured maps, where any are asked for);
          ``cache`` is the feature entering up block ``n_levels −
          cache_level``, right after the Upsample2D that ends the block
          before it.
        - ``deep_cache=cache``: the shallow forward.  The encoder runs its
          first ``cache_level`` levels (fresh skips, ``down_residuals``
          added to that prefix; the deeper ones and ``mid_residual`` go
          unused; ``level_residuals`` added at the levels that run),
          ``cache`` takes the place of the mid block and every
          deeper block, and the last ``cache_level`` up blocks run.  From
          the cache of the same ``(sample, t, context)`` this is the full
          forward; from an earlier step's cache it is DeepCache's
          approximation."""
        cfg = self.cfg
        if objs is not None and not self.gligen:
            raise ValueError("objs given to a UNet built without GLIGEN "
                             "fusers: build it with gligen=True")
        dtype = self.dtype
        # NCHW-contiguous from here on, whatever the caller's layout: a
        # permuted NHWC latent would carry channels-last strides through
        # the convolutions, and the GroupNorm kernel takes contiguous NCHW
        h = sample.to(dtype).contiguous()
        context = context.to(dtype)
        temb = self.embed_time(timesteps, h.shape[0])
        if cfg.addition_embed_type == "text_time":
            if pooled_text is None or time_ids is None:
                raise ValueError("text_time conditioning needs pooled_text "
                                 "and time_ids")
            b = time_ids.shape[0]
            tid = timestep_embedding(time_ids.reshape(-1),
                                     cfg.addition_time_embed_dim).reshape(b, -1)
            add = self.add_embedding(
                torch.cat([pooled_text.to(dtype), tid.to(dtype)], dim=-1))
            temb = temb + add.expand_as(temb)

        n = len(self.up_blocks)
        if not 1 <= cache_level <= n:
            raise ValueError(f"cache_level {cache_level} outside 1..{n}")
        resume = n - cache_level
        captured: Dict[AttnKey, torch.Tensor] = {}
        attend = attender(context, ip_scale, capture_keys, captured, objs)
        cache = None
        if deep_cache is None:
            h, skips = self.encode(h, temb, attend,
                                   level_residuals=level_residuals)
            if down_residuals is not None:
                if len(down_residuals) != len(skips):
                    raise ValueError(f"{len(down_residuals)} down residuals "
                                     f"for {len(skips)} skips")
                skips = [s + r.to(s.dtype)
                         for s, r in zip(skips, down_residuals)]
            h = self.middle(h, temb, attend)
            if mid_residual is not None:
                h = h + mid_residual.to(h.dtype)
            first = 0
        else:
            h, skips = self.encode(h, temb, attend, max_level=cache_level,
                                   level_residuals=level_residuals)
            if down_residuals is not None:
                # the shallow skips are a prefix of the full stack
                skips = [s + r.to(s.dtype)
                         for s, r in zip(skips, down_residuals)]
            h, first = deep_cache.to(dtype), resume

        for idx in range(first, n):
            if idx == resume:
                cache = h
            blk = self.up_blocks[idx]
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = attend(blk.attentions[j], h, "up", idx, j)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        eps = self.conv_out(self.conv_norm_out(h))
        out = (eps, cache) if return_deep_cache else eps
        if capture_keys:
            missing = [k for k in capture_keys if tuple(k) not in captured]
            if missing:
                raise ValueError(f"capture_keys name no cross-attention "
                                 f"layer of this {'shallow ' if first else ''}"
                                 f"forward: {missing}")
            return out, captured
        return out
