"""Promptable segmentation of the characters, the port of
``theatergen_tpu/perception/sam.py``.

``SAMLite`` is the JAX package's weightless segmenter: a ViT encoder with
global attention and learned absolute positions, a box prompt encoder and
a two-way transformer mask decoder giving 3 candidate masks with IoU
scores.  :func:`segment_with_box` runs it or the checkpoint-faithful
``sam_hf.SamHF`` on one box and picks a mask by the reference's rule
(``models/sam.py:68-174``: the largest candidate, heavily penalised below
a confidence or a coarse-mask IoU), then binarises it with one erode and
dilate round at each requested size.  Modules take NHWC images in [0, 1]
and normalised xyxy boxes, and run fp32.

``segments`` counts the characters segmented (one per
:func:`segment_with_box` call, B per :func:`segment_with_box_batch`).
"""

from __future__ import annotations

import types
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import SAMConfig
from ..models.clip import CLIPEncoderLayer
from ..ops import geometry as G
from ..ops.attention import multi_head_attention
from .sam_hf import SamHF, preprocess as hf_preprocess

segments = 0


def _conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ViTEncoder(nn.Module):
    """Patchify → CLIP-style layers (quick GELU, LayerNorm eps 1e-6) →
    neck: ``[B, S, S, 3]`` → ``[B, n, n, prompt_embed_dim]``."""

    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, n = cfg.encoder_dim, cfg.image_size // cfg.patch_size
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size,
                                     stride=cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(n * n, d))
        layer_cfg = types.SimpleNamespace(
            hidden_size=d, num_heads=cfg.encoder_heads,
            intermediate_size=4 * d, layer_norm_eps=1e-6)
        self.layers = nn.ModuleList(CLIPEncoderLayer(layer_cfg)
                                    for _ in range(cfg.encoder_layers))
        p = cfg.prompt_embed_dim
        self.neck_conv1 = nn.Conv2d(d, p, 1, bias=False)
        self.neck_ln1 = nn.LayerNorm(p, eps=1e-6)
        self.neck_conv2 = nn.Conv2d(p, p, 3, padding=1, bias=False)
        self.neck_ln2 = nn.LayerNorm(p, eps=1e-6)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b = pixels.shape[0]
        x = _conv_nhwc(self.patch_embed, pixels)
        n, d = x.shape[1], x.shape[-1]
        x = x.reshape(b, n * n, d) + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        x = self.neck_ln1(_conv_nhwc(self.neck_conv1, x.reshape(b, n, n, d)))
        return self.neck_ln2(_conv_nhwc(self.neck_conv2, x))


class PromptEncoder(nn.Module):
    """A box → its two corners' Fourier embeddings plus a learned
    embedding per corner: ``[B, Nb, 4]`` → ``[B, Nb, 2, D]``."""

    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.pe_gaussian = nn.Parameter(torch.zeros(2, d // 2))
        self.corner_embed = nn.Parameter(torch.zeros(2, d))

    def forward(self, boxes: torch.Tensor) -> torch.Tensor:
        def fourier(pts):
            proj = (2 * pts - 1) @ self.pe_gaussian * (2 * torch.pi)
            return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

        tl = fourier(boxes[..., 0:2]) + self.corner_embed[0]
        br = fourier(boxes[..., 2:4]) + self.corner_embed[1]
        return torch.stack([tl, br], dim=-2)


class TwoWayBlock(nn.Module):
    """Token self-attention → token-to-image cross-attention → MLP →
    image-to-token cross-attention, each with a residual and LayerNorm."""

    def __init__(self, heads: int, d: int):
        super().__init__()
        self.heads = heads
        for name in ("self", "t2i", "i2t"):
            for part in ("q", "k", "v", "out"):
                setattr(self, f"{name}_{part}", nn.Linear(d, d))
        for i in range(1, 5):
            setattr(self, f"ln{i}", nn.LayerNorm(d, eps=1e-6))
        self.mlp_1 = nn.Linear(d, 4 * d)
        self.mlp_2 = nn.Linear(4 * d, d)

    def _attn(self, q_in, kv_in, name: str):
        d = q_in.shape[-1]

        def heads(x):
            return x.reshape(*x.shape[:-1], self.heads, d // self.heads)

        out = multi_head_attention(
            heads(getattr(self, f"{name}_q")(q_in)),
            heads(getattr(self, f"{name}_k")(kv_in)),
            heads(getattr(self, f"{name}_v")(kv_in)))
        return getattr(self, f"{name}_out")(out.reshape(q_in.shape))

    def forward(self, tokens, image):
        tokens = self.ln1(tokens + self._attn(tokens, tokens, "self"))
        tokens = self.ln2(tokens + self._attn(tokens, image, "t2i"))
        tokens = self.ln3(tokens + self.mlp_2(F.gelu(self.mlp_1(tokens))))
        image = self.ln4(image + self._attn(image, tokens, "i2t"))
        return tokens, image


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, self.m = cfg.prompt_embed_dim, cfg.num_mask_outputs
        # the IoU token, then the mask tokens
        self.output_tokens = nn.Parameter(torch.zeros(1 + self.m, d))
        self.blocks = nn.ModuleList(TwoWayBlock(cfg.decoder_heads, d)
                                    for _ in range(cfg.decoder_layers))
        self.upscale_1 = nn.ConvTranspose2d(d, d // 4, 2, stride=2)
        self.upscale_ln = nn.LayerNorm(d // 4, eps=1e-6)
        self.upscale_2 = nn.ConvTranspose2d(d // 4, d // 8, 2, stride=2)
        self.iou_mlp_1 = nn.Linear(d, d)
        self.iou_mlp_2 = nn.Linear(d, self.m)
        self.hyper = nn.Linear(d, d // 8)

    def forward(self, image_embed: torch.Tensor, prompt_tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``image_embed [B, n, n, D]``, ``prompt_tokens [B, P, D]`` →
        (mask logits ``[B, M, 4n, 4n]``, iou ``[B, M]``)."""
        b, n, _, d = image_embed.shape
        tokens = torch.cat([self.output_tokens[None].expand(b, -1, -1),
                            prompt_tokens], dim=1)
        img = image_embed.reshape(b, n * n, d)
        for block in self.blocks:
            tokens, img = block(tokens, img)
        up = _conv_nhwc(self.upscale_1, img.reshape(b, n, n, d))
        up = F.gelu(self.upscale_ln(up))
        up = F.gelu(_conv_nhwc(self.upscale_2, up))       # [B, 4n, 4n, D/8]
        iou = self.iou_mlp_2(F.relu(self.iou_mlp_1(tokens[:, 0])))
        hyper = self.hyper(tokens[:, 1:1 + self.m])         # [B, M, D/8]
        return torch.einsum("bmd,bhwd->bmhw", hyper, up), iou


class SAMLite(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = ViTEncoder(cfg)
        self.prompt = PromptEncoder(cfg)
        self.decoder = MaskDecoder(cfg)

    def forward(self, image: torch.Tensor, boxes: torch.Tensor):
        """``image [B, S, S, 3]`` in [0, 1], ``boxes [B, Nb, 4]``
        normalised → (mask logits ``[B, Nb, M, 4n, 4n]``, iou ``[B, Nb,
        M]``); each box decoded on its own."""
        embed = self.encoder(image)
        pts = self.prompt(boxes)                            # [B, Nb, 2, D]
        b, nb = pts.shape[:2]
        eb = embed[:, None].expand(b, nb, *embed.shape[1:]).reshape(
            b * nb, *embed.shape[1:])
        masks, iou = self.decoder(eb, pts.reshape(b * nb, 2, -1))
        return (masks.reshape(b, nb, *masks.shape[1:]),
                iou.reshape(b, nb, -1))


def select_mask(masks: torch.Tensor, ious: torch.Tensor,
                coarse_mask: Optional[torch.Tensor] = None, *,
                min_confidence: float = 0.85, min_coarse_iou: float = 0.25,
                penalty: float = 1e6) -> torch.Tensor:
    """The reference's "largest over confidence" rule: the index of the
    candidate ``masks [M, h, w]`` (binary) of largest area, less
    ``penalty`` where its IoU score is below ``min_confidence`` and where
    its IoU with ``coarse_mask [h, w]`` is below ``min_coarse_iou``; ties
    go to the first index.  A 0-dim tensor."""
    score = masks.sum((1, 2)).float()
    score = score - penalty * (ious < min_confidence).float()
    if coarse_mask is not None:
        score = score - penalty * (G.iou(coarse_mask, masks)
                                   < min_coarse_iou).float()
    return torch.argmax(score)


def refine_mask(mask: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Binarise ``[..., h, w]`` at ``threshold``, then one erode (3×3
    min-pool, the border padded with 1) and one dilate (3×3 max-pool, the
    border padded with 0); fp32."""
    shape = mask.shape
    x = (mask > threshold).float().reshape(-1, 1, *shape[-2:])
    eroded = -F.max_pool2d(-F.pad(x, (1, 1, 1, 1), value=1.0), 3, 1)
    dilated = F.max_pool2d(F.pad(eroded, (1, 1, 1, 1), value=0.0), 3, 1)
    return dilated.reshape(shape)


def sam_input_size(sam: nn.Module) -> int:
    """Native input side of a segmenter (``SAMLite`` or ``SamHF``)."""
    return sam.cfg.image_size


@torch.no_grad()
def _apply_sam(sam: nn.Module, images: torch.Tensor, boxes: torch.Tensor):
    """Either backend on ``[B, S, S, 3]`` images in [0, 1] and normalised
    boxes ``[B, Nb, 4]`` → (mask logits ``[B, Nb, M, h, w]``, iou ``[B,
    Nb, M]``); ``SamHF`` takes normalised pixels and boxes in pixels."""
    images, boxes = images.float(), boxes.float()
    if isinstance(sam, SamHF):
        return sam(hf_preprocess(images), boxes * float(sam.cfg.image_size))
    return sam(images, boxes)


def segment_with_box(sam: nn.Module, image: torch.Tensor, box: torch.Tensor,
                     out_sizes: Tuple[int, ...] = (64, 512),
                     coarse_mask: Optional[torch.Tensor] = None):
    """One image ``[S, S, 3]`` and one box ``[4]`` → (one refined mask per
    size in ``out_sizes``, the chosen candidate's IoU score): the
    reference's dual-scale ``sam_refine_attn`` (``models/sam.py:126-174``).
    ``coarse_mask`` (any multiple of the masks' side) is max-pooled to
    it."""
    global segments
    segments += 1
    logits, iou = _apply_sam(sam, image[None], box[None, None])
    logits, iou = logits[0, 0], iou[0, 0]                # [M, h, w], [M]
    probs = torch.sigmoid(logits)
    masks_bin = (probs > 0.5).float()
    cm = None
    if coarse_mask is not None:
        cm = G.downsample_max(coarse_mask, *masks_bin.shape[-2:])
    idx = select_mask(masks_bin, iou, cm)
    chosen = probs[idx]
    return (tuple(refine_mask(G.resize_bilinear(chosen, s, s))
                  for s in out_sizes), iou[idx])


def segment_with_box_batch(sam: nn.Module, images: torch.Tensor,
                           boxes: torch.Tensor,
                           out_sizes: Tuple[int, ...] = (64, 512)):
    """:func:`segment_with_box` for ``B`` characters in one forward:
    ``images [B, S, S, 3]``, one box each ``[B, 4]`` → (per size a stack
    ``[B, s, s]``, the chosen IoU scores ``[B]``); no coarse mask."""
    global segments
    segments += images.shape[0]
    logits, iou = _apply_sam(sam, images, boxes[:, None])
    logits, iou = logits[:, 0], iou[:, 0]               # [B, M, h, w], [B, M]
    probs = torch.sigmoid(logits)
    masks_bin = (probs > 0.5).float()
    idx = torch.stack([select_mask(mb, io) for mb, io in zip(masks_bin,
                                                             iou)])
    rows = torch.arange(images.shape[0], device=idx.device)
    chosen = probs[rows, idx]
    return (tuple(refine_mask(G.resize_bilinear(chosen, s, s))
                  for s in out_sizes), iou[rows, idx])


def segment_with_boxes(sam: nn.Module, image: torch.Tensor,
                       boxes: torch.Tensor, out_size: int = 64, *,
                       min_confidence: float = 0.85,
                       min_coarse_iou: float = 0.25):
    """One image ``[S, S, 3]`` and ``Nb`` boxes ``[Nb, 4]`` in one forward
    → (refined masks ``[Nb, out_size, out_size]``, the chosen IoU scores
    ``[Nb]``): the reference's legacy ``sam_refine_box``/
    ``sam_refine_boxes`` (``models/sam.py:176-215``), whose coarse mask
    for the selection is each prompt box rasterised."""
    global segments
    segments += boxes.shape[0]
    logits, iou = _apply_sam(sam, image[None], boxes[None])
    logits, iou = logits[0], iou[0]                  # [Nb, M, h, w], [Nb, M]
    probs = torch.sigmoid(logits)
    masks_bin = (probs > 0.5).float()
    h, w = masks_bin.shape[-2:]
    idx = torch.stack([
        select_mask(mb, io, G.box_mask(box, h, w),
                    min_confidence=min_confidence,
                    min_coarse_iou=min_coarse_iou)
        for mb, io, box in zip(masks_bin, iou, boxes.float())])
    rows = torch.arange(boxes.shape[0], device=idx.device)
    return (refine_mask(G.resize_bilinear(probs[rows, idx], out_size,
                                          out_size)), iou[rows, idx])


def segment_with_box_legacy(sam: nn.Module, image: torch.Tensor,
                            box: torch.Tensor, out_size: int = 64,
                            **select_kwargs):
    """One image and one box ``[4]`` → (mask ``[out_size, out_size]``,
    confidence): the reference's ``sam_refine_box``
    (``models/sam.py:176-182``), :func:`segment_with_boxes` of one box."""
    masks, confs = segment_with_boxes(sam, image, box[None],
                                      out_size=out_size, **select_kwargs)
    return masks[0], confs[0]
