"""OWL-ViT, the open-vocabulary detector the turn uses without a
GroundingDINO (PyTorch), the port of ``theatergen_tpu/perception/owl.py``.

A CLIP ViT whose patch tokens carry a box-regression head and a class head
scored against text-query embeddings, as transformers'
``OwlViTForObjectDetection`` computes it, under its parameter names
(``owlvit.{text_model,vision_model,text_projection,visual_projection}``,
``layer_norm``, ``box_head.dense{0,1,2}``, ``class_head.{dense0,
logit_shift,logit_scale}``), so a google/owlvit-* file loads with
``models/weights.py::port_owl``, which drops only the contrastive
``owlvit.logit_scale``:

- the towers are ``models/clip.py``'s (the vision tower with OWL-ViT's
  ``pre_layernorm`` and without a projection of its own); the detection
  features are the post-LN tokens with the class token multiplied into
  every patch token, then ``layer_norm``;
- the box head is a 3-layer exact-GELU MLP whose output is biased by each
  patch's grid position and size before the sigmoid (:func:`box_bias`);
- the class head scores each patch's class embedding against the
  normalised text queries, with a learned per-patch shift and ELU(+1)
  scale.  The query is normalised twice, ``+1e-6`` each time, as in the
  JAX package.

:class:`OwlBackend` is the ``(image, phrase) -> (box, confidence, ok)``
interface of the JAX package (box threshold 0.3), plus
``count_instances`` (greedy NMS, sorted on the host in numpy as the JAX
package sorts).  It runs on the card unless told otherwise, in fp32 with
TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import CLIPTextConfig, CLIPVisionConfig
from ..models.clip import CLIPTextEncoder, CLIPVisionEncoder
from ..ops import geometry as G
from .gdino import _exact_fp32

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class OwlConfig:
    vision: CLIPVisionConfig
    text: CLIPTextConfig


def owlvit_base_patch32() -> OwlConfig:
    """google/owlvit-base-patch32's widths, as the JAX package's
    ``load_bundle`` builds them (``models/weights.py:1252-1274``)."""
    return OwlConfig(
        vision=CLIPVisionConfig(
            image_size=768, patch_size=32, hidden_size=768,
            intermediate_size=3072, num_layers=12, num_heads=12,
            projection_dim=512),
        text=CLIPTextConfig(
            hidden_size=512, intermediate_size=2048, num_layers=12,
            num_heads=8, max_length=16, projection_dim=512,
            use_text_projection=True))


def tiny_owl_config() -> OwlConfig:
    """The tiny detector of the CPU tests (``tests/test_owl.py``)."""
    return OwlConfig(
        vision=CLIPVisionConfig(
            image_size=32, patch_size=8, hidden_size=32,
            intermediate_size=64, num_layers=2, num_heads=2,
            projection_dim=32),
        text=CLIPTextConfig(
            vocab_size=1000, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=2, max_length=16, projection_dim=32,
            use_text_projection=True))


def box_bias(num_patches: int) -> np.ndarray:
    """``[N, 4]`` box-logit bias: each patch's prediction starts at its own
    grid cell (centre the patch's, size one patch), transformers'
    ``compute_box_bias``; ``'xy'`` meshgrid order, rows flattened as the
    patch tokens are."""
    r = np.arange(1, num_patches + 1, dtype=np.float32)
    xx, yy = np.meshgrid(r, r)
    coords = np.stack([xx, yy], axis=-1).reshape(-1, 2) / num_patches
    coords = np.clip(coords, 0.0, 1.0)
    coord_bias = np.log(coords + 1e-4) - np.log1p(-coords + 1e-4)
    size = np.full_like(coords, 1.0 / num_patches)
    size_bias = np.log(size + 1e-4) - np.log1p(-size + 1e-4)
    return np.concatenate([coord_bias, size_bias], axis=-1)


class OwlBoxHead(nn.Module):
    """``OwlViTBoxPredictionHead``: dense, GELU, dense, GELU, dense(4)."""

    def __init__(self, width: int):
        super().__init__()
        self.dense0 = nn.Linear(width, width)
        self.dense1 = nn.Linear(width, width)
        self.dense2 = nn.Linear(width, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.dense0(x), approximate="none")
        h = F.gelu(self.dense1(h), approximate="none")
        return self.dense2(h)


class OwlClassHead(nn.Module):
    """``OwlViTClassPredictionHead``: cosine logits against the normalised
    queries, shifted and scaled per patch; returns ``(logits [B, N, Q],
    class embeddings [B, N, D])``."""

    def __init__(self, width: int, out_dim: int):
        super().__init__()
        self.dense0 = nn.Linear(width, out_dim)
        self.logit_shift = nn.Linear(width, 1)
        self.logit_scale = nn.Linear(width, 1)

    def forward(self, image_feats: torch.Tensor, query_embeds: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        ce = self.dense0(image_feats)
        ce_n = ce / (torch.linalg.vector_norm(ce, dim=-1, keepdim=True)
                     + 1e-6)
        q_n = query_embeds / (torch.linalg.vector_norm(
            query_embeds, dim=-1, keepdim=True) + 1e-6)
        logits = torch.einsum("bpd,qd->bpq", ce_n, q_n)
        shift = self.logit_shift(image_feats)
        scale = F.elu(self.logit_scale(image_feats)) + 1.0
        return (logits + shift) * scale, ce


class OwlViT(nn.Module):
    """The towers and their projections (transformers' ``OwlViTModel``
    without its contrastive ``logit_scale``)."""

    def __init__(self, cfg: OwlConfig):
        super().__init__()
        tcfg = dataclasses.replace(cfg.text, use_text_projection=False,
                                   projection_dim=cfg.text.hidden_size)
        self.text_model = CLIPTextEncoder(tcfg)
        self.vision_model = CLIPVisionEncoder(
            cfg.vision, pre_norm="pre_layernorm", projection=False)
        self.text_projection = nn.Linear(cfg.text.hidden_size,
                                         cfg.text.projection_dim, bias=False)
        self.visual_projection = nn.Linear(
            cfg.vision.hidden_size, cfg.vision.projection_dim, bias=False)


class OwlDetector(nn.Module):
    """``OwlViTForObjectDetection``: ``(pixels [B, 3, S, S] CLIP-normalised,
    input_ids [Q, L]) → (boxes [B, N, 4] normalised xyxy, logits [B, N,
    Q])``."""

    def __init__(self, cfg: OwlConfig):
        super().__init__()
        self.cfg = cfg
        width = cfg.vision.hidden_size
        self.owlvit = OwlViT(cfg)
        self.layer_norm = nn.LayerNorm(width,
                                       eps=cfg.vision.layer_norm_eps)
        self.box_head = OwlBoxHead(width)
        self.class_head = OwlClassHead(width, cfg.text.hidden_size)
        self._box_bias = box_bias(cfg.vision.image_size
                                  // cfg.vision.patch_size)

    def image_features(self, pixels: torch.Tensor):
        """→ ``(boxes [B, N, 4] xyxy clipped to [0, 1], feats [B, N, C])``."""
        *_, tokens = self.owlvit.vision_model(pixels, return_tokens=True)
        # the class token merged into every patch token (image_embedder)
        feats = self.layer_norm(tokens[:, 1:] * tokens[:, :1])
        bias = torch.as_tensor(self._box_bias, device=feats.device)
        cx, cy, w, h = torch.sigmoid(self.box_head(feats) + bias).unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                             cy + h / 2], dim=-1)
        return torch.clamp(boxes, 0.0, 1.0), feats

    def text_queries(self, input_ids: torch.Tensor) -> torch.Tensor:
        _, pooled = self.owlvit.text_model(input_ids)
        q = self.owlvit.text_projection(pooled)
        return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor):
        boxes, feats = self.image_features(pixels)
        logits, _ = self.class_head(feats, self.text_queries(input_ids))
        return boxes, logits


class OwlBackend:
    """The turn's and the evaluation's OWL-ViT: ``(image [H, W, 3] in [0,
    1], phrase) → (box [4] numpy, confidence float, ok bool)``, the JAX
    package's interface, and :meth:`count_instances`.

    ``weights``: the port's state dict of an :class:`OwlDetector` of
    ``cfg`` (transformers' names), loaded ``strict=True`` in fp32 on
    ``device``.  Runs on the card unless ``device`` names another device;
    without a card it raises.  ``tokenizer`` is the CLIP tokenizer
    (``utils/tokenizer.load_tokenizer``), padding to ``max_length``."""

    def __init__(self, cfg: OwlConfig, weights: Mapping, tokenizer, *,
                 max_length: int | None = None, box_threshold: float = 0.3,
                 device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("OwlBackend: no CUDA device; pass "
                               "device='cpu' to run the detector on the CPU")
        with torch.device("meta"):
            model = OwlDetector(cfg)
        model.load_state_dict(
            {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
             for k, v in weights.items()}, strict=True, assign=True)
        self.cfg = cfg
        self.model = model.eval().requires_grad_(False)
        self.tokenizer = tokenizer
        self.max_length = max_length or cfg.text.max_length
        self.box_threshold = box_threshold      # utils/detector.py:14
        self.device = device

    def pixels(self, image) -> torch.Tensor:
        """``[H, W, 3]`` in [0, 1] (numpy or a tensor) → ``[1, 3, S, S]``
        CLIP-normalised on the device, resized by the port's
        ``resize_bilinear`` (antialiased when it shrinks, as
        ``jax.image.resize``)."""
        x = torch.as_tensor(image, device=self.device).float()
        s = self.cfg.vision.image_size
        x = G.resize_bilinear(x.permute(2, 0, 1), s, s)
        mean = torch.as_tensor(CLIP_MEAN, device=self.device)[:, None, None]
        std = torch.as_tensor(CLIP_STD, device=self.device)[:, None, None]
        return ((x - mean) / std)[None]

    def forward(self, pixels: torch.Tensor, phrases: List[str]):
        """``(boxes [B, N, 4], logits [B, N, Q])`` on the device."""
        ids = torch.as_tensor(np.asarray(self.tokenizer(
            list(phrases), max_length=self.max_length)), dtype=torch.long,
            device=self.device)
        with torch.no_grad(), _exact_fp32():
            return self.model(pixels, ids)

    def _detect(self, image, phrase: str):
        """→ ``(boxes [N, 4], probs [N])`` as numpy."""
        boxes, logits = self.forward(self.pixels(image), [phrase])
        return (boxes[0].cpu().numpy(),
                torch.sigmoid(logits[0, :, 0]).cpu().numpy())

    def __call__(self, image, phrase: str) -> Tuple[np.ndarray, float, bool]:
        boxes, probs = self._detect(image, phrase)
        best = int(np.argmax(probs))
        conf = float(probs[best])
        return boxes[best], conf, conf > self.box_threshold

    def count_instances(self, image, phrase: str, max_n: int = 8,
                        iou_nms: float = 0.5) -> int:
        boxes, probs = self._detect(image, phrase)
        order = np.argsort(-probs)
        picked: List[np.ndarray] = []
        for i in order:
            if probs[i] <= self.box_threshold or len(picked) >= max_n:
                break
            if all(_iou(boxes[i], p) < iou_nms for p in picked):
                picked.append(boxes[i])
        return len(picked)


def _iou(a, b, eps=1e-6):
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x1 - x0, 0) * max(y1 - y0, 0)
    union = ((a[2] - a[0]) * (a[3] - a[1])
             + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / (union + eps)
