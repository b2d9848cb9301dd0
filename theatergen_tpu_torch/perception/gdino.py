"""Grounding DINO, the port of ``theatergen_tpu/perception/gdino.py``.

The reference detects each generated character with an external
GroundingDINO checkout (``utils/detector.py:5-21``) and regenerates it with
a new seed when nothing is found (``theatergen.py:98-160``).  This is that
detector: the Swin backbone (``perception/swin.py``), the BERT text tower
(``perception/bert.py``), the feature-enhancer encoder (bidirectional
vision/text fusion, text self-attention, multiscale deformable attention),
language-guided two-stage query selection, the cross-modality decoder with
iterative box refinement and the contrastive class and MLP box heads, in
the JAX package's order and numerics (transformers'
``GroundingDinoForObjectDetection``).  The modules carry transformers'
names (``model.backbone.conv_encoder.model...``,
``model.encoder.layers.3.fusion_layer.attn.vision_proj``,
``model.input_proj_vision.2.1``, ``bbox_embed.0.layers.1`` ...), so
``models/weights.py::port_grounding_dino`` is almost the identity.

Inference is on fixed-size, all-valid images, as in the JAX package: the
sine position grids, the encoder's reference points and the first-stage
proposals are numpy constants, built once per shape and device.  The
deformable attention samples with ``F.grid_sample`` (bilinear, zero
padding, ``align_corners=False``, at ``2·loc − 1``), which equals the JAX
package's four-corner gather.  ``BiMultiHeadAttention`` subtracts one
maximum over its whole logit tensor, batch included, then clamps at
±50 000, exactly as the JAX package (and transformers) do.  Everything is
plain PyTorch: the detector launches none of the port's kernels (the input
projections' GroupNorm has no SiLU and is ``torch.nn.GroupNorm``).

Precision: the detector runs in fp32, as the JAX backend runs the fp32
tree of ``port_grounding_dino``, and :class:`GroundingDinoBackend` turns
TF32 off for its matmuls and cuDNN convolutions while it runs (restoring
the caller's settings after), so the card computes what the CPU does up to
fp32 summation order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import geometry as G
from .bert import (BertConfig, BertTextEncoder, attend, merge_heads,
                   split_heads, tiny_bert_config)
from .detector import Detection
from .swin import SwinBackbone, SwinConfig, tiny_swin_config

# BERT [CLS], [SEP], '.', '?': the phrase delimiters (transformers'
# SPECIAL_TOKENS)
SPECIAL_TOKEN_IDS = (101, 102, 1012, 1029)


@dataclasses.dataclass(frozen=True)
class GroundingDinoConfig:
    """transformers' GroundingDinoConfig (inference part); the defaults
    are IDEA-Research/grounding-dino-tiny."""

    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    image_size: int = 800
    d_model: int = 256
    num_queries: int = 900
    encoder_layers: int = 6
    decoder_layers: int = 6
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_dim: int = 2048
    decoder_ffn_dim: int = 2048
    num_feature_levels: int = 4
    encoder_n_points: int = 4
    decoder_n_points: int = 4
    max_text_len: int = 256
    layer_norm_eps: float = 1e-5
    positional_embedding_temperature: float = 20.0

    @property
    def level_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """(h, w) of each feature level: the backbone's emitted stages,
        then extra stride-2 levels.  Patch merging rounds up (it pads odd
        resolutions), and so do the extra levels."""
        per_stage = {}
        s = self.image_size // self.swin.patch_size
        for stage in range(1, len(self.swin.depths) + 1):
            per_stage[stage] = s
            s = (s + 1) // 2
        shapes = [(per_stage[st], per_stage[st])
                  for st in self.swin.out_stages]
        for _ in range(self.num_feature_levels - len(self.swin.out_stages)):
            s = (shapes[-1][0] + 1) // 2
            shapes.append((s, s))
        return tuple(shapes)


def tiny_gdino_config() -> GroundingDinoConfig:
    return GroundingDinoConfig(
        swin=tiny_swin_config(), bert=tiny_bert_config(), image_size=64,
        d_model=32, num_queries=10, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=64, decoder_ffn_dim=64, num_feature_levels=3,
        max_text_len=32,
    )


# ----------------------------------------------------- static geometry


def sine_position_2d(h: int, w: int, d_model: int, temperature: float
                     ) -> np.ndarray:
    """``[h, w, d_model]`` DETR sine grid (transformers'
    GroundingDinoSinePositionEmbedding with an all-valid mask)."""
    half = d_model // 2
    eps = 1e-6
    y = (np.arange(1, h + 1, dtype=np.float32) / (h + eps) * 2 * np.pi)
    x = (np.arange(1, w + 1, dtype=np.float32) / (w + eps) * 2 * np.pi)
    dim_t = temperature ** (2 * (np.arange(half) // 2) / half)
    py = y[:, None] / dim_t
    px = x[:, None] / dim_t
    py = np.stack([np.sin(py[:, 0::2]), np.cos(py[:, 1::2])],
                  axis=2).reshape(h, -1)
    px = np.stack([np.sin(px[:, 0::2]), np.cos(px[:, 1::2])],
                  axis=2).reshape(w, -1)
    pos = np.concatenate(
        [np.broadcast_to(py[:, None], (h, w, py.shape[-1])),
         np.broadcast_to(px[None, :], (h, w, px.shape[-1]))], axis=-1)
    return pos.astype(np.float32)


def encoder_reference_points(shapes: Sequence[Tuple[int, int]]
                             ) -> np.ndarray:
    """``[S, 2]`` normalised centres of every position (all-valid masks
    make each level's valid ratio 1)."""
    refs = []
    for h, w in shapes:
        ry = (np.arange(h, dtype=np.float32) + 0.5) / h
        rx = (np.arange(w, dtype=np.float32) + 0.5) / w
        gy, gx = np.meshgrid(ry, rx, indexing="ij")
        refs.append(np.stack([gx, gy], -1).reshape(-1, 2))
    return np.concatenate(refs, 0)


def output_proposals(shapes: Sequence[Tuple[int, int]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """First-stage proposal logits ``[S, 4]`` (``+inf`` rows where a
    proposal is invalid) and validity ``[S]`` (transformers'
    generate_encoder_output_proposals on all-valid padding)."""
    props = []
    for lvl, (h, w) in enumerate(shapes):
        gy, gx = np.meshgrid(np.arange(h, dtype=np.float32),
                             np.arange(w, dtype=np.float32), indexing="ij")
        grid = np.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1)
        wh = np.full_like(grid, 0.05 * 2.0 ** lvl)
        props.append(np.concatenate([grid, wh], -1).reshape(-1, 4))
    p = np.concatenate(props, 0)
    valid = ((p > 0.01) & (p < 0.99)).all(-1)
    with np.errstate(invalid="ignore", divide="ignore"):   # invalid rows
        logit = np.log(p / (1 - p))
    logit[~valid] = np.inf
    return logit.astype(np.float32), valid


@functools.lru_cache(maxsize=None)
def _static(cfg: GroundingDinoConfig, device: torch.device) -> dict:
    """The numpy constants of ``cfg``'s level shapes on ``device``: the
    position grid of every level ``[S, d]`` (level embeddings not added),
    the encoder's reference points ``[1, S, 2]``, the proposals' logits
    ``[1, S, 4]`` and validity ``[1, S, 1]``."""
    shapes, d = cfg.level_shapes, cfg.d_model
    pos = np.concatenate([sine_position_2d(
        h, w, d, cfg.positional_embedding_temperature).reshape(h * w, d)
        for h, w in shapes])
    logit, valid = output_proposals(shapes)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(pos=on(pos), ref=on(encoder_reference_points(shapes))[None],
                prop_logits=on(logit)[None], prop_valid=on(valid)[None, :,
                                                                  None])


def get_sine_pos_embed(pos: torch.Tensor, num_pos_feats: int,
                       temperature: float = 10000.0,
                       exchange_xy: bool = True) -> torch.Tensor:
    """``[..., n]`` positions → ``[..., n·num_pos_feats]`` sine embeddings
    (transformers' get_sine_pos_embed)."""
    scale = 2 * math.pi
    dim_t = temperature ** (2 * (torch.arange(
        num_pos_feats, device=pos.device) // 2) / num_pos_feats)

    def embed(x):
        sx = x[..., None] * scale / dim_t
        return torch.stack([torch.sin(sx[..., 0::2]),
                            torch.cos(sx[..., 1::2])], dim=-1).reshape(
            *x.shape, num_pos_feats)

    parts = [embed(pos[..., i]) for i in range(pos.shape[-1])]
    if exchange_xy and len(parts) >= 2:
        parts[0], parts[1] = parts[1], parts[0]
    return torch.cat(parts, dim=-1)


# ------------------------------------------- multiscale deformable attn


def ms_deform_attention(value: torch.Tensor,
                        shapes: Sequence[Tuple[int, int]],
                        sampling_locations: torch.Tensor,
                        attention_weights: torch.Tensor) -> torch.Tensor:
    """``value [B, S, H, D]``, ``sampling_locations [B, Q, H, L, P, 2]``
    in [0, 1], ``attention_weights [B, Q, H, L, P]`` (softmaxed) →
    ``[B, Q, H·D]``: bilinear samples with zero padding
    (``align_corners=False``) of each level, weighted and summed."""
    b, _, heads, d = value.shape
    q, points = sampling_locations.shape[1], sampling_locations.shape[4]
    grids = 2 * sampling_locations - 1
    out = None
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w]               # [B, hw, H, D]
        start += h * w
        v = v.permute(0, 2, 3, 1).reshape(b * heads, d, h, w)
        g = grids[:, :, :, lvl].transpose(1, 2).reshape(
            b * heads, q, points, 2)
        s = F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)          # [BH, D, Q, P]
        aw = attention_weights[:, :, :, lvl].transpose(1, 2).reshape(
            b * heads, 1, q, points)
        part = (s * aw).sum(-1)                         # [BH, D, Q]
        out = part if out is None else out + part
    return out.reshape(b, heads, d, q).permute(0, 3, 1, 2).reshape(
        b, q, heads * d)


class DeformableAttention(nn.Module):
    """transformers' GroundingDinoMultiscaleDeformableAttention."""

    def __init__(self, cfg: GroundingDinoConfig, heads: int, points: int):
        super().__init__()
        d, levels = cfg.d_model, cfg.num_feature_levels
        self.heads, self.points, self.levels = heads, points, levels
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, hidden, encoder_hidden, position_embeddings,
                reference_points, shapes):
        """hidden ``[B, Q, D]``; encoder_hidden ``[B, S, D]``;
        reference_points ``[B or 1, Q, 2 or 4]``."""
        heads, levels, points = self.heads, self.levels, self.points
        if position_embeddings is not None:
            hidden = hidden + position_embeddings
        b, q, d = hidden.shape
        value = self.value_proj(encoder_hidden).reshape(b, -1, heads,
                                                        d // heads)
        offsets = self.sampling_offsets(hidden).reshape(
            b, q, heads, levels, points, 2)
        weights = torch.softmax(self.attention_weights(hidden).reshape(
            b, q, heads, levels * points).float(), dim=-1).to(hidden.dtype)
        weights = weights.reshape(b, q, heads, levels, points)
        ref = reference_points[:, :, None, None, None]
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[wd, ht] for ht, wd in shapes],
                                      dtype=torch.float32,
                                      device=hidden.device)
            locs = ref + offsets / normalizer[None, None, None, :, None, :]
        else:
            locs = ref[..., :2] + offsets / points * ref[..., 2:] * 0.5
        return self.output_proj(ms_deform_attention(value, shapes, locs,
                                                    weights))


# ------------------------------------------------------- encoder layers


class MultiheadAttention(nn.Module):
    """transformers' GroundingDinoMultiheadAttention (separate q/k/v/out
    projections)."""

    def __init__(self, d_model: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, queries, keys, values, mask=None):
        q = split_heads(self.query(queries), self.heads)
        k = split_heads(self.key(keys), self.heads)
        v = split_heads(self.value(values), self.heads)
        return self.out_proj(merge_heads(attend(q, k, v, mask)))


class TextEnhancerLayer(nn.Module):
    """Text self-attention, post-LN, with half the encoder's heads and FFN
    width (transformers' GroundingDinoTextEnhancerLayer)."""

    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = MultiheadAttention(d, cfg.encoder_attention_heads
                                            // 2)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim // 2)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim // 2, d)
        self.layer_norm_before = nn.LayerNorm(d, eps=eps)
        self.layer_norm_after = nn.LayerNorm(d, eps=eps)

    def forward(self, text, text_pos, self_attn_mask):
        add_mask = None
        if self_attn_mask is not None:      # [B, T, T] bool, True = attend
            add_mask = ((1.0 - self_attn_mask[:, None].float())
                        * torch.finfo(torch.float32).min)
        qk = text + text_pos
        text = self.layer_norm_before(text + self.self_attn(qk, qk, text,
                                                            add_mask))
        h = self.fc2(F.relu(self.fc1(text)))
        return self.layer_norm_after(text + h)


class BiMultiHeadAttention(nn.Module):
    """Bidirectional vision↔text cross-attention on shared logits, with
    transformers' numerics: one maximum subtracted over the whole logit
    tensor (batch included), a ±50 000 clamp, then the text→vision side
    shifted by its own row maxima and clamped again."""

    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, embed = cfg.d_model, cfg.encoder_ffn_dim // 2
        self.heads = cfg.encoder_attention_heads // 2
        self.scale = (embed // self.heads) ** -0.5
        self.vision_proj = nn.Linear(d, embed)
        self.text_proj = nn.Linear(d, embed)
        self.values_vision_proj = nn.Linear(d, embed)
        self.values_text_proj = nn.Linear(d, embed)
        self.out_vision_proj = nn.Linear(embed, d)
        self.out_text_proj = nn.Linear(embed, d)

    def forward(self, vision, text, text_pad_mask):
        heads = self.heads
        vq = split_heads(self.vision_proj(vision) * self.scale, heads)
        tk = split_heads(self.text_proj(text), heads)
        vv = split_heads(self.values_vision_proj(vision), heads)
        tv = split_heads(self.values_text_proj(text), heads)

        logits = vq @ tk.transpose(-1, -2)                    # [B, H, V, T]
        logits = torch.clamp(logits - logits.max(), -50000, 50000)
        logits_t = logits.transpose(-1, -2)                   # [B, H, T, V]
        logits_t = torch.clamp(
            logits_t - logits_t.max(dim=-1, keepdim=True).values,
            -50000, 50000)
        # all-valid vision: no mask on the text→vision softmax
        text_attn = torch.softmax(logits_t.float(), dim=-1)
        if text_pad_mask is not None:       # [B, T] bool, True = padding
            logits = logits.masked_fill(text_pad_mask[:, None, None, :],
                                        -math.inf)
        vision_attn = torch.softmax(logits.float(), dim=-1)
        v_out = merge_heads(vision_attn.to(tv.dtype) @ tv)
        t_out = merge_heads(text_attn.to(vv.dtype) @ vv)
        return self.out_vision_proj(v_out), self.out_text_proj(t_out)


class FusionLayer(nn.Module):
    """Pre-LN fusion with layer-scale residuals (transformers'
    GroundingDinoFusionLayer; drop-path is the identity at inference)."""

    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.layer_norm_vision = nn.LayerNorm(d, eps=eps)
        self.layer_norm_text = nn.LayerNorm(d, eps=eps)
        self.attn = BiMultiHeadAttention(cfg)
        self.vision_param = nn.Parameter(torch.full((d,), 1e-4))
        self.text_param = nn.Parameter(torch.full((d,), 1e-4))

    def forward(self, vision, text, text_pad_mask):
        vn = self.layer_norm_vision(vision)
        tn = self.layer_norm_text(text)
        dv, dt = self.attn(vn, tn, text_pad_mask)
        return vn + self.vision_param * dv, tn + self.text_param * dt


class DeformableLayer(nn.Module):
    """Deformable self-attention over the multiscale map and an FFN,
    post-LN (transformers' GroundingDinoDeformableLayer)."""

    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, eps = cfg.d_model, cfg.layer_norm_eps
        self.self_attn = DeformableAttention(
            cfg, cfg.encoder_attention_heads, cfg.encoder_n_points)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.encoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, vision, vision_pos, reference_points, shapes):
        attn = self.self_attn(vision, vision, vision_pos, reference_points,
                              shapes)
        vision = self.self_attn_layer_norm(vision + attn)
        h = self.fc2(F.relu(self.fc1(vision)))
        return self.final_layer_norm(vision + h)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        self.fusion_layer = FusionLayer(cfg)
        self.text_enhancer_layer = TextEnhancerLayer(cfg)
        self.deformable_layer = DeformableLayer(cfg)

    def forward(self, vision, text, vision_pos, text_pos, reference_points,
                shapes, text_self_mask, text_pad_mask):
        vision, text = self.fusion_layer(vision, text, text_pad_mask)
        text = self.text_enhancer_layer(text, text_pos, text_self_mask)
        vision = self.deformable_layer(vision, vision_pos, reference_points,
                                       shapes)
        return vision, text


class MLPHead(nn.Module):
    """ReLU MLP (transformers' GroundingDinoMLPPredictionHead)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DecoderLayer(nn.Module):
    """Self-attention → text cross-attention → deformable vision
    cross-attention → FFN, post-LN (transformers'
    GroundingDinoDecoderLayer)."""

    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d, eps, heads = (cfg.d_model, cfg.layer_norm_eps,
                         cfg.decoder_attention_heads)
        self.self_attn = MultiheadAttention(d, heads)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn_text = MultiheadAttention(d, heads)
        self.encoder_attn_text_layer_norm = nn.LayerNorm(d, eps=eps)
        self.encoder_attn = DeformableAttention(cfg, heads,
                                                cfg.decoder_n_points)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=eps)
        self.fc1 = nn.Linear(d, cfg.decoder_ffn_dim)
        self.fc2 = nn.Linear(cfg.decoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=eps)

    def forward(self, hidden, query_pos, reference_points, shapes,
                vision_states, text_states, text_cross_mask):
        qk = hidden + query_pos
        hidden = self.self_attn_layer_norm(
            hidden + self.self_attn(qk, qk, hidden))
        hidden = self.encoder_attn_text_layer_norm(
            hidden + self.encoder_attn_text(hidden + query_pos, text_states,
                                            text_states, text_cross_mask))
        hidden = self.encoder_attn_layer_norm(
            hidden + self.encoder_attn(hidden, vision_states, query_pos,
                                       reference_points, shapes))
        h = self.fc2(F.relu(self.fc1(hidden)))
        return self.final_layer_norm(hidden + h)


def _logit(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def contrastive_logits(vision: torch.Tensor, text: torch.Tensor,
                       text_token_mask: torch.Tensor, max_text_len: int
                       ) -> torch.Tensor:
    """``[B, Q, D] × [B, T, D]`` → ``[B, Q, max_text_len]``, ``-inf``
    outside the valid text tokens (transformers'
    GroundingDinoContrastiveEmbedding)."""
    out = vision @ text.transpose(-1, -2)
    out = out.masked_fill(~text_token_mask[:, None, :], -math.inf)
    pad = max_text_len - out.shape[-1]
    if pad > 0:
        out = F.pad(out, (0, pad), value=-math.inf)
    return out[..., :max_text_len]


class _Decoder(nn.Module):
    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.decoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.reference_points_head = MLPHead(2 * d, d, d, 2)


class GroundingDinoModel(nn.Module):
    """The parameters under transformers' ``model.`` (the forward is
    :class:`GroundingDinoForDetection`'s)."""

    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        d = cfg.d_model
        groups = 32 if d % 32 == 0 else d
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_feature_levels,
                                                    d))
        self.backbone = nn.ModuleDict(dict(conv_encoder=nn.ModuleDict(dict(
            model=SwinBackbone(cfg.swin)))))
        dims = [cfg.swin.stage_dim(s) for s in cfg.swin.out_stages]
        proj = [nn.Sequential(nn.Conv2d(c, d, 1),
                              nn.GroupNorm(groups, d, eps=1e-5))
                for c in dims]
        for i in range(len(dims), cfg.num_feature_levels):
            c = dims[-1] if i == len(dims) else d
            proj.append(nn.Sequential(
                nn.Conv2d(c, d, 3, stride=2, padding=1),
                nn.GroupNorm(groups, d, eps=1e-5)))
        self.input_proj_vision = nn.ModuleList(proj)
        self.text_backbone = BertTextEncoder(cfg.bert)
        self.text_projection = nn.Linear(cfg.bert.hidden_size, d)
        self.query_position_embeddings = nn.Embedding(cfg.num_queries, d)
        self.encoder = nn.ModuleDict(dict(layers=nn.ModuleList(
            EncoderLayer(cfg) for _ in range(cfg.encoder_layers))))
        self.decoder = _Decoder(cfg)
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.encoder_output_bbox_embed = MLPHead(d, d, 4, 3)


class GroundingDinoForDetection(nn.Module):
    """The detector: ``pixels [B, S, S, 3]`` (ImageNet-normalised, NHWC)
    and the text inputs of :func:`prepare_text_inputs` → per-query token
    logits ``[B, Q, max_text_len]`` and cxcywh boxes ``[B, Q, 4]`` in
    [0, 1].  ``bbox_embed.0`` is the one box head that the decoder's
    refinement and the output share (transformers ties the others to
    it)."""

    def __init__(self, cfg: GroundingDinoConfig):
        super().__init__()
        self.cfg = cfg
        self.model = GroundingDinoModel(cfg)
        self.bbox_embed = nn.ModuleList([MLPHead(cfg.d_model, cfg.d_model,
                                                 4, 3)])

    def forward(self, pixels, input_ids, text_self_mask=None,
                position_ids=None, token_type_ids=None,
                text_token_mask=None):
        cfg, m = self.cfg, self.model
        shapes = cfg.level_shapes
        b, d = pixels.shape[0], cfg.d_model
        const = _static(cfg, pixels.device)
        if text_token_mask is None:
            text_token_mask = torch.ones_like(input_ids, dtype=torch.bool)

        # text tower
        text = m.text_projection(m.text_backbone(
            input_ids, text_self_mask, token_type_ids, position_ids))

        # vision tower and input projections
        feats = [f.permute(0, 3, 1, 2) for f in
                 m.backbone["conv_encoder"]["model"](pixels)]
        maps: List[torch.Tensor] = [p(f) for p, f in
                                    zip(m.input_proj_vision, feats)]
        for i in range(len(feats), cfg.num_feature_levels):
            src = feats[-1] if i == len(feats) else maps[-1]
            maps.append(m.input_proj_vision[i](src))
        vision = torch.cat([x.flatten(2).transpose(1, 2) for x in maps], 1)
        level = torch.cat([m.level_embed[lvl].expand(h * w, d)
                           for lvl, (h, w) in enumerate(shapes)])
        vision_pos = (const["pos"] + level)[None].expand_as(vision)

        # feature-enhancer encoder
        if position_ids is None:
            position_ids = torch.arange(text.shape[1], device=text.device
                                        ).expand(text.shape[:2])
        text_pos = get_sine_pos_embed(position_ids.float()[..., None], d,
                                      exchange_xy=False)
        for layer in m.encoder["layers"]:
            vision, text = layer(vision, text, vision_pos, text_pos,
                                 const["ref"], shapes, text_self_mask,
                                 ~text_token_mask)

        # language-guided query selection (two-stage)
        obj = torch.where(const["prop_valid"], vision, 0.0)
        obj = m.enc_output_norm(m.enc_output(obj))
        enc_class = contrastive_logits(obj, text, text_token_mask,
                                       cfg.max_text_len)
        enc_coord_logits = (m.encoder_output_bbox_embed(obj)
                            + const["prop_logits"])
        topk_idx = torch.topk(enc_class.max(dim=-1).values, cfg.num_queries,
                              dim=1).indices
        reference = torch.sigmoid(torch.gather(
            enc_coord_logits, 1, topk_idx[..., None].expand(-1, -1, 4)))
        hidden = m.query_position_embeddings.weight[None].expand(b, -1, -1)

        # decoder with iterative box refinement (the shared box head)
        box_head = self.bbox_embed[0]
        dec = m.decoder
        text_cross_mask = torch.where(
            text_token_mask[:, None, None, :], 0.0,
            torch.finfo(torch.float32).min)
        for layer in dec.layers:
            query_pos = dec.reference_points_head(
                get_sine_pos_embed(reference, d // 2))
            hidden = layer(hidden, query_pos, reference, shapes, vision,
                           text, text_cross_mask)
            prev_reference = reference
            reference = torch.sigmoid(box_head(hidden) + _logit(reference))

        # the heads on the last layer (transformers' outputs_class[-1])
        last = dec.layer_norm(hidden)
        logits = contrastive_logits(last, text, text_token_mask,
                                    cfg.max_text_len)
        boxes = torch.sigmoid(box_head(last) + _logit(prev_reference))
        return logits, boxes


# -------------------------------------------------- text preprocessing


def prepare_text_inputs(input_ids: np.ndarray):
    """Token ids → the self-attention block mask ``[B, T, T]`` (True =
    attend) and position ids restarting at each phrase (transformers'
    generate_masks_with_special_tokens_and_transfer_map, on the host)."""
    input_ids = np.asarray(input_ids)
    b, t = input_ids.shape
    special = np.isin(input_ids, np.asarray(SPECIAL_TOKEN_IDS))
    mask = np.broadcast_to(np.eye(t, dtype=bool), (b, t, t)).copy()
    position_ids = np.zeros((b, t), np.int64)
    for row in range(b):
        prev = 0
        for col in np.nonzero(special[row])[0]:
            if col == 0 or col == t - 1:
                mask[row, col, col] = True
                position_ids[row, col] = 0
            else:
                mask[row, prev + 1:col + 1, prev + 1:col + 1] = True
                position_ids[row, prev + 1:col + 1] = np.arange(col - prev)
            prev = col
    return mask, position_ids


# ImageNet normalisation (transformers' GroundingDinoImageProcessor)
GDINO_PIXEL_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
GDINO_PIXEL_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(image01: torch.Tensor) -> torch.Tensor:
    mean = torch.as_tensor(GDINO_PIXEL_MEAN, device=image01.device)
    std = torch.as_tensor(GDINO_PIXEL_STD, device=image01.device)
    return (image01 - mean) / std


# ------------------------------------------------------------ tokenizer


class WordPieceTokenizer:
    """BERT-uncased WordPiece over a ``vocab.txt``, enough to encode
    detection phrases ("a cat.") as BertTokenizer does: lower case,
    punctuation split off, greedy longest-match ``##`` pieces."""

    def __init__(self, vocab_path: str):
        self.vocab = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.cls = self.vocab.get("[CLS]", 101)
        self.sep = self.vocab.get("[SEP]", 102)
        self.unk = self.vocab.get("[UNK]", 100)

    def _basic(self, text: str) -> List[str]:
        out, cur = [], []
        for ch in text.lower():
            if ch.isalnum():
                cur.append(ch)
            else:
                if cur:
                    out.append("".join(cur))
                    cur = []
                if not ch.isspace():
                    out.append(ch)
        if cur:
            out.append("".join(cur))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = self.vocab[sub]
                    break
                end -= 1
            if piece is None:
                return [self.unk]
            pieces.append(piece)
            start = end
        return pieces

    def encode(self, text: str) -> List[int]:
        ids = [self.cls]
        for tok in self._basic(text):
            ids.extend(self._wordpiece(tok))
        ids.append(self.sep)
        return ids


# ------------------------------------------------------------- backend


@contextlib.contextmanager
def _exact_fp32():
    """TF32 off for matmuls and cuDNN convolutions, the caller's settings
    restored after."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


class GroundingDinoBackend:
    """The story turn's detector: ``(image01, phrase) → Detection``, as the
    reference's ``predict_with_classes`` is used (box threshold 0.3, the
    highest-confidence box kept, ``utils/detector.py:5-21``), and
    :meth:`detect_batch` for a batch of characters in one forward.

    ``weights``: the port's state dict of a
    :class:`GroundingDinoForDetection` of ``cfg``, loaded ``strict=True``
    in fp32 on ``device`` (tensors already there in fp32 are used as they
    are, not copied).  Runs on the card unless ``device`` names another
    device; without a card it raises.  The text pads to ``text_pad_len`` tokens
    (16), truncating longer phrases.  The scores stay on the device: a
    caller reads ``ok`` once per call, or once per batch."""

    BOX_THRESHOLD = 0.3   # utils/detector.py:13
    TEXT_PAD_LEN = 16

    def __init__(self, cfg: GroundingDinoConfig, weights: Mapping, tokenizer,
                 text_pad_len: int | None = None, *, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GroundingDinoBackend: no CUDA device; pass "
                               "device='cpu' to run the detector on the CPU")
        with torch.device("meta"):
            model = GroundingDinoForDetection(cfg)
        model.load_state_dict(
            {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
             for k, v in weights.items()}, strict=True, assign=True)
        self.cfg = cfg
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.pad_len = text_pad_len or self.TEXT_PAD_LEN
        self.device = device

    def _encode_text(self, phrase: str):
        text = phrase.strip().lower()
        if not text.endswith("."):
            text = text + "."
        ids = self.tokenizer.encode(text)[: self.pad_len]
        n = len(ids)
        padded = np.zeros((1, self.pad_len), np.int64)
        padded[0, :n] = ids
        token_mask = np.zeros((1, self.pad_len), bool)
        token_mask[0, :n] = True
        # [PAD] = 0 is no delimiter: pads attend only to themselves, as in
        # transformers' batched padding
        self_mask, pos_ids = prepare_text_inputs(padded)
        return padded, self_mask, pos_ids, token_mask, n

    def _resize(self, images01: torch.Tensor) -> torch.Tensor:
        """``[..., H, W, 3]`` on the device, resized to the model's side
        by the port's ``resize_bilinear``."""
        x = torch.as_tensor(images01, device=self.device).float()
        s = self.cfg.image_size
        if x.shape[-3] == s and x.shape[-2] == s:
            return x
        return G.resize_bilinear(x.movedim(-1, -3), s, s).movedim(-3, -1)

    def _forward(self, pixels, phrases):
        enc = [self._encode_text(p) for p in phrases]
        ids, self_mask, pos_ids, token_mask = (
            torch.from_numpy(np.concatenate([e[i] for e in enc])).to(
                self.device) for i in range(4))
        with torch.no_grad(), _exact_fp32():
            logits, boxes = self.model(pixels, ids, self_mask, pos_ids,
                                       text_token_mask=token_mask)
        return logits.float(), boxes.float(), [e[4] for e in enc]

    def _detection(self, scores, boxes) -> Detection:
        """Per row: the best query's score and its box as clipped xyxy."""
        best = scores.argmax(-1)
        rows = torch.arange(scores.shape[0], device=scores.device)
        conf = scores[rows, best]
        cx, cy, w, h = boxes[rows, best].unbind(-1)
        box = torch.clamp(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                       cy + h / 2], -1), 0.0, 1.0)
        return Detection(box=box, confidence=conf,
                         ok=conf > self.BOX_THRESHOLD)

    def __call__(self, image01, phrase: str) -> Detection:
        """``image01 [H, W, 3]`` in [0, 1] → Detection (normalised xyxy
        box).  A query scores its highest probability over the phrase's
        word tokens ``[1, max(n-1, 1))``."""
        pixels = preprocess(self._resize(image01))[None]
        logits, boxes, (n,) = self._forward(pixels, [phrase])
        probs = torch.sigmoid(logits[0])
        scores = probs[:, 1:max(n - 1, 1)].max(dim=-1).values
        d = self._detection(scores[None], boxes)
        return Detection(box=d.box[0], confidence=d.confidence[0],
                         ok=d.ok[0])

    def detect_batch(self, images01, phrases: Sequence[str]) -> Detection:
        """``images01 [B, H, W, 3]`` with one phrase each → Detection with
        ``[B]``-shaped leaves from one forward (the batched character path:
        one forward and one host read of ``ok`` for a batch).  A row
        scores over the tokens ``[1, max(n-1, 2))``, as the JAX package's
        batched path does."""
        if len(phrases) != len(images01):
            raise ValueError(f"detect_batch: {len(phrases)} phrases for "
                             f"{len(images01)} images")
        pixels = preprocess(self._resize(images01))
        logits, boxes, ns = self._forward(pixels, phrases)
        probs = torch.sigmoid(logits)                            # [B, Q, T]
        ar = torch.arange(probs.shape[-1], device=probs.device)
        ends = torch.tensor([max(n - 1, 2) for n in ns], device=probs.device)
        word = (ar[None] >= 1) & (ar[None] < ends[:, None])
        scores = probs.masked_fill(~word[:, None, :], -math.inf).amax(-1)
        return self._detection(scores, boxes)
