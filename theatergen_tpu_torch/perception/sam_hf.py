"""Checkpoint-faithful SAM (Segment Anything), the port of
``theatergen_tpu/perception/sam_hf.py``.

The reference segments each character with HF ``SamModel`` box prompts
(``models/sam.py:15-56``).  The modules here carry transformers'
``SamModel`` parameter names (``vision_encoder.layers.0.attn.qkv``,
``prompt_encoder.point_embed.2``, ``mask_decoder.transformer.layers.0
.cross_attn_token_to_image.q_proj`` …), so a ``sam.safetensors`` exported
from ``facebook/sam-vit-base`` loads through ``models/weights.py::port_sam``
almost as it is; the prompt encoder's mask tower (``mask_embed``), which
the box-prompted path never runs, is left out.  Activations are NHWC at
the module boundaries, as in the JAX package; attention is a plain fp32
matmul and softmax (the decomposed relative-position bias is added to its
logits), and the GELUs are exact.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import geometry as G


@dataclasses.dataclass(frozen=True)
class SamHFConfig:
    """transformers' SamConfig (vision encoder, prompt encoder, mask
    decoder); the defaults are facebook/sam-vit-base."""

    # vision encoder
    image_size: int = 1024
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    output_channels: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    use_rel_pos: bool = True
    use_abs_pos: bool = True
    qkv_bias: bool = True
    layer_norm_eps: float = 1e-6
    # prompt encoder
    prompt_hidden_size: int = 256
    mask_input_channels: int = 16
    num_pos_feats: int = 128
    # mask decoder
    decoder_hidden_size: int = 256
    decoder_num_layers: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size


def tiny_sam_hf_config() -> SamHFConfig:
    """The tiny instance of the CPU tests (the JAX package's)."""
    return SamHFConfig(
        image_size=64, patch_size=8, hidden_size=32, num_layers=3,
        num_heads=2, output_channels=16, window_size=4,
        global_attn_indexes=(1,), prompt_hidden_size=16, num_pos_feats=8,
        decoder_hidden_size=16, decoder_num_heads=2, decoder_mlp_dim=32,
        iou_head_hidden_dim=16, mask_input_channels=8,
    )


# ------------------------------------------------------ decomposed rel-pos

def rel_pos_indices(q_size: int, k_size: int) -> np.ndarray:
    """Gather indices ``[q_size, k_size]`` into a ``(2·max(q, k) − 1)``-row
    relative-position table (transformers' ``get_rel_pos``)."""
    q = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    return ((q - k) + (k_size - 1) * max(q_size / k_size, 1.0)).astype(
        np.int64)


def resize_rel_pos(rel_pos: torch.Tensor, target_len: int) -> torch.Tensor:
    """A table of another length resized linearly along its rows to
    ``target_len`` (``jax.image.resize(..., "linear")``)."""
    if rel_pos.shape[0] == target_len:
        return rel_pos
    return G.resize_bilinear(rel_pos.t(), rel_pos.shape[1],
                             target_len).t().to(rel_pos.dtype)


def decomposed_rel_pos_bias(query: torch.Tensor, rel_pos_h: torch.Tensor,
                            rel_pos_w: torch.Tensor, size: int
                            ) -> torch.Tensor:
    """MViTv2's decomposed relative-position bias over a square
    ``size × size`` grid: ``query [B, size², C]`` (unscaled) →
    ``[B, size², size²]`` to add to the logits."""
    idx = torch.as_tensor(rel_pos_indices(size, size), device=query.device)
    rh = resize_rel_pos(rel_pos_h, 2 * size - 1)[idx]        # [s, s, C]
    rw = resize_rel_pos(rel_pos_w, 2 * size - 1)[idx]
    b = query.shape[0]
    q = query.reshape(b, size, size, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", q, rh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", q, rw)
    bias = bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]
    return bias.reshape(b, size * size, size * size)


# ---------------------------------------------------------- vision encoder

class SamVisionAttention(nn.Module):
    """Fused-QKV multi-head attention over a square grid of side ``size``
    (a window, or the whole grid in a global layer), with the decomposed
    relative-position bias."""

    def __init__(self, cfg: SamHFConfig, size: int):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_heads
        self.qkv = nn.Linear(c, 3 * c, bias=cfg.qkv_bias)
        self.proj = nn.Linear(c, c)
        self.use_rel_pos = cfg.use_rel_pos
        if cfg.use_rel_pos:
            hd = c // cfg.num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # [B, s, s, C]
        b, s, _, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(b, s * s, 3, self.heads, hd)
        qkv = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * self.heads, s * s,
                                                 hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2)
        if self.use_rel_pos:
            logits = logits + decomposed_rel_pos_bias(
                q, self.rel_pos_h, self.rel_pos_w, s)
        probs = torch.softmax(logits.float(), dim=-1)
        out = probs.to(v.dtype) @ v
        out = out.reshape(b, self.heads, s, s, hd).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(b, s, s, c))


def window_partition(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, int]:
    """``[B, H, W, C]`` → ``([B·nw, ws, ws, C], padded side)``, zero-padded
    at the bottom and right to a multiple of ``ws``."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    ph, pw = h + pad_h, w + pad_w
    x = x.reshape(b, ph // ws, ws, pw // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), ph


def window_unpartition(win: torch.Tensor, ws: int, padded: int, orig: int
                       ) -> torch.Tensor:
    """The inverse of :func:`window_partition`, the padding cropped."""
    nw, c = padded // ws, win.shape[-1]
    x = win.reshape(-1, nw, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, padded, padded, c)[:, :orig, :orig]


class SamMLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(self.act(self.lin1(x)))


class SamVisionLayer(nn.Module):
    def __init__(self, cfg: SamHFConfig, window: int):
        super().__init__()
        self.window = window          # 0: global attention
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.attn = SamVisionAttention(cfg, window or cfg.grid_size)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = SamMLPBlock(d, int(d * cfg.mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm1(x)
        if self.window > 0:
            orig = h.shape[1]
            h, padded = window_partition(h, self.window)
            h = window_unpartition(self.attn(h), self.window, padded, orig)
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(self.layer_norm2(x))


class SamPatchEmbed(nn.Module):
    def __init__(self, cfg: SamHFConfig):
        super().__init__()
        self.projection = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                    stride=cfg.patch_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.projection(pixels.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)


class SamNeck(nn.Module):
    """1×1 conv → channel LayerNorm → 3×3 conv → channel LayerNorm."""

    def __init__(self, cfg: SamHFConfig):
        super().__init__()
        d, o = cfg.hidden_size, cfg.output_channels
        self.conv1 = nn.Conv2d(d, o, 1, bias=False)
        self.layer_norm1 = nn.LayerNorm(o, eps=1e-6)
        self.conv2 = nn.Conv2d(o, o, 3, padding=1, bias=False)
        self.layer_norm2 = nn.LayerNorm(o, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # NHWC
        x = self.layer_norm1(_conv_nhwc(self.conv1, x))
        return self.layer_norm2(_conv_nhwc(self.conv2, x))


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SamVisionEncoder(nn.Module):
    """Patchify → windowed and global ViT layers → neck:
    ``[B, S, S, 3]`` normalised pixels → ``[B, g, g, output_channels]``."""

    def __init__(self, cfg: SamHFConfig):
        super().__init__()
        g = cfg.grid_size
        self.patch_embed = SamPatchEmbed(cfg)
        self.use_abs_pos = cfg.use_abs_pos
        if cfg.use_abs_pos:
            self.pos_embed = nn.Parameter(torch.zeros(1, g, g,
                                                      cfg.hidden_size))
        self.layers = nn.ModuleList(
            SamVisionLayer(cfg, 0 if i in cfg.global_attn_indexes
                           else cfg.window_size)
            for i in range(cfg.num_layers))
        self.neck = SamNeck(cfg)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(pixels)
        if self.use_abs_pos:
            x = x + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        return self.neck(x)


# ---------------------------------------------------------- prompt encoder

class SamPositionalEmbedding(nn.Module):
    """Random-Fourier encoding of points in [0, 1]², shared by the prompt
    encoder and the decoder's image-wide grid."""

    def __init__(self, cfg: SamHFConfig):
        super().__init__()
        self.init_std = float(cfg.prompt_hidden_size // 2)
        self.positional_embedding = nn.Parameter(
            torch.zeros(2, cfg.num_pos_feats))

    def forward(self, coords: torch.Tensor) -> torch.Tensor:
        pe = self.positional_embedding
        c = (2 * coords - 1).to(pe.dtype) @ pe * (2 * math.pi)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


class SamPromptEncoder(nn.Module):
    """Box prompts in pixel coordinates of ``image_size`` (a half-pixel
    shift, then normalised) → sparse corner embeddings; the dense prompt
    is the no-mask embedding everywhere.  The shared positional embedding
    is the caller's (the top module owns it, as ``SamModel`` does)."""

    def __init__(self, cfg: SamHFConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.prompt_hidden_size
        # 0: negative point, 1: positive point, 2/3: box corners
        self.point_embed = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def embed_boxes(self, boxes: torch.Tensor, shared: nn.Module
                    ) -> torch.Tensor:
        """``[B, Nb, 4]`` pixel xyxy → ``[B, Nb, 2, D]``."""
        corners = (boxes.reshape(*boxes.shape[:-1], 2, 2) + 0.5) / float(
            self.cfg.image_size)
        corner = torch.cat([self.point_embed[2].weight,
                            self.point_embed[3].weight])
        return shared(corners) + corner

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                     shared: nn.Module) -> torch.Tensor:
        """``[B, P, N, 2]`` pixel xy and labels ``[B, P, N]`` (-10 padding,
        -1 not a point, 0 negative, 1 positive) → ``[B, P, N, D]``."""
        emb = shared((points + 0.5) / float(self.cfg.image_size))
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed.weight[0], emb)
        emb = torch.where(lab == -10, torch.zeros_like(emb), emb)
        emb = torch.where(lab == 0, emb + self.point_embed[0].weight[0], emb)
        return torch.where(lab == 1, emb + self.point_embed[1].weight[0],
                           emb)

    def dense_no_mask(self, batch: int) -> torch.Tensor:
        g = self.cfg.grid_size
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            batch, g, g, -1)

    def image_wide_pe(self, shared: nn.Module) -> torch.Tensor:
        """``[g, g, D]`` positional grid of the decoder."""
        g = self.cfg.grid_size
        coords = (torch.arange(g, dtype=torch.float32,
                               device=self.no_mask_embed.weight.device)
                  + 0.5) / g
        xy = torch.stack([coords[None, :].expand(g, g),
                          coords[:, None].expand(g, g)], dim=-1)
        return shared(xy)


# ------------------------------------------------------------ mask decoder

class SamDecoderAttention(nn.Module):
    """Attention with its inner width divided by ``downsample``, over
    ``[B, P, T, D]`` (batch and prompts folded into one batch)."""

    def __init__(self, cfg: SamHFConfig, downsample: int = 1):
        super().__init__()
        d = cfg.decoder_hidden_size
        self.inner = d // downsample
        self.heads = cfg.decoder_num_heads
        self.q_proj = nn.Linear(d, self.inner)
        self.k_proj = nn.Linear(d, self.inner)
        self.v_proj = nn.Linear(d, self.inner)
        self.out_proj = nn.Linear(self.inner, d)

    def forward(self, q_in, k_in, v_in):
        b, p = q_in.shape[:2]
        hd = self.inner // self.heads

        def split(x):
            return x.reshape(b * p, x.shape[2], self.heads, hd).transpose(1,
                                                                          2)

        q = split(self.q_proj(q_in))
        k = split(self.k_proj(k_in))
        v = split(self.v_proj(v_in))
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2)
        probs = torch.softmax(logits.float(), dim=-1)
        out = (probs.to(v.dtype) @ v).transpose(1, 2)
        return self.out_proj(out.reshape(b, p, -1, self.inner))


class SamTwoWayBlock(nn.Module):
    """Sparse self-attention → sparse-to-image cross-attention → MLP →
    image-to-sparse cross-attention, each followed by a LayerNorm."""

    def __init__(self, cfg: SamHFConfig, skip_first_layer_pe: bool = False):
        super().__init__()
        d, eps = cfg.decoder_hidden_size, cfg.layer_norm_eps
        rate = cfg.attention_downsample_rate
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = SamDecoderAttention(cfg, 1)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps)
        self.cross_attn_token_to_image = SamDecoderAttention(cfg, rate)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps)
        self.mlp = SamMLPBlock(d, cfg.decoder_mlp_dim, act=F.relu)
        self.layer_norm3 = nn.LayerNorm(d, eps=eps)
        self.layer_norm4 = nn.LayerNorm(d, eps=eps)
        self.cross_attn_image_to_token = SamDecoderAttention(cfg, rate)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.layer_norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.layer_norm2(
            queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.layer_norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.layer_norm4(
            keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class SamTwoWayTransformer(nn.Module):
    def __init__(self, cfg: SamHFConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            SamTwoWayBlock(cfg, skip_first_layer_pe=(i == 0))
            for i in range(cfg.decoder_num_layers))
        self.final_attn_token_to_image = SamDecoderAttention(
            cfg, cfg.attention_downsample_rate)
        # torch's default eps, as transformers builds it
        self.layer_norm_final_attn = nn.LayerNorm(cfg.decoder_hidden_size)

    def forward(self, tokens, img, pe):
        queries, keys = tokens, img
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, pe)
        q, k = queries + tokens, keys + pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.layer_norm_final_attn(queries), keys


class SamFeedForward(nn.Module):
    """proj_in → ReLU → hidden layers with ReLU → proj_out."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int):
        super().__init__()
        self.proj_in = nn.Linear(in_dim, hidden)
        self.layers = nn.ModuleList(nn.Linear(hidden, hidden)
                                    for _ in range(num_layers - 2))
        self.proj_out = nn.Linear(hidden, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.proj_in(x))
        for layer in self.layers:
            x = F.relu(layer(x))
        return self.proj_out(x)


class SamMaskDecoder(nn.Module):
    def __init__(self, cfg: SamHFConfig):
        super().__init__()
        d = cfg.decoder_hidden_size
        self.num_masks = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_masks, d)
        self.transformer = SamTwoWayTransformer(cfg)
        self.upscale_conv1 = nn.ConvTranspose2d(d, d // 4, 2, stride=2)
        self.upscale_layer_norm = nn.LayerNorm(d // 4, eps=1e-6)
        self.upscale_conv2 = nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2)
        self.output_hypernetworks_mlps = nn.ModuleList(
            SamFeedForward(d, d, d // 8, 3) for _ in range(self.num_masks))
        self.iou_prediction_head = SamFeedForward(
            d, cfg.iou_head_hidden_dim, self.num_masks, cfg.iou_head_depth)

    def forward(self, image_embed, image_pe, sparse, dense):
        """``image_embed [B, g, g, D]``, ``image_pe [g, g, D]``, ``sparse
        [B, P, T, D]``, ``dense [B, g, g, D]`` → (mask logits ``[B, P, M+1,
        4g, 4g]``, iou ``[B, P, M+1]``)."""
        b, p = sparse.shape[:2]
        g, d, m = image_embed.shape[1], image_embed.shape[-1], self.num_masks
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight])
        tokens = torch.cat([out_tokens[None, None].expand(b, p, 1 + m, d),
                            sparse], dim=2)
        img = (image_embed + dense).reshape(b, 1, g * g, d).expand(
            b, p, g * g, d)
        pe = image_pe.reshape(1, 1, g * g, d).expand(b, p, g * g, d)
        queries, keys = self.transformer(tokens, img, pe)
        iou_out, mask_out = queries[:, :, 0], queries[:, :, 1:1 + m]

        up = keys.reshape(b * p, g, g, d).permute(0, 3, 1, 2)
        up = self.upscale_layer_norm(
            self.upscale_conv1(up).permute(0, 2, 3, 1))
        up = self.upscale_conv2(F.gelu(up).permute(0, 3, 1, 2))
        up = F.gelu(up).permute(0, 2, 3, 1).reshape(b, p, 16 * g * g,
                                                    d // 8)
        hyper = torch.stack([mlp(mask_out[:, :, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)],
                            dim=2)
        masks = torch.einsum("bpmc,bpnc->bpmn", hyper, up)
        masks = masks.reshape(b, p, m, 4 * g, 4 * g)
        return masks, self.iou_prediction_head(iou_out)


# --------------------------------------------------------------- top level

# SamProcessor's pixel normalisation (ImageNet), on [0, 1] inputs
SAM_PIXEL_MEAN = (0.485, 0.456, 0.406)
SAM_PIXEL_STD = (0.229, 0.224, 0.225)


def preprocess(image01: torch.Tensor) -> torch.Tensor:
    """``[..., H, W, 3]`` in [0, 1] → normalised; resizing to
    ``cfg.image_size`` is the caller's."""
    mean = torch.tensor(SAM_PIXEL_MEAN, device=image01.device)
    std = torch.tensor(SAM_PIXEL_STD, device=image01.device)
    return (image01.float() - mean) / std


class SamHF(nn.Module):
    """Vision encoder, prompt encoder and mask decoder.

    ``forward(pixels [B, S, S, 3] normalised, boxes [B, Nb, 4] pixel xyxy)
    → (mask logits [B, Nb, 3, 4g, 4g], iou [B, Nb, 3])``: the three
    multimask candidates (``multimask=False``: the single-mask output)."""

    def __init__(self, cfg: SamHFConfig):
        super().__init__()
        self.cfg = cfg
        self.shared_image_embedding = SamPositionalEmbedding(cfg)
        self.vision_encoder = SamVisionEncoder(cfg)
        self.prompt_encoder = SamPromptEncoder(cfg)
        self.mask_decoder = SamMaskDecoder(cfg)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision_encoder(pixels)

    def decode(self, image_embed: torch.Tensor, boxes: torch.Tensor,
               multimask: bool = True):
        shared = self.shared_image_embedding
        sparse = self.prompt_encoder.embed_boxes(boxes, shared)
        dense = self.prompt_encoder.dense_no_mask(boxes.shape[0])
        pe = self.prompt_encoder.image_wide_pe(shared)
        masks, iou = self.mask_decoder(image_embed, pe, sparse, dense)
        if multimask:
            return masks[:, :, 1:], iou[:, :, 1:]
        return masks[:, :, :1], iou[:, :, :1]

    def forward(self, pixels: torch.Tensor, boxes: torch.Tensor,
                multimask: bool = True):
        return self.decode(self.encode_image(pixels), boxes, multimask)
