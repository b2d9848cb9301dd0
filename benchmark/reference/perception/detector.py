"""Attention-based character detection for the detect-and-regenerate loop.

The port of ``theatergen_tpu/perception/detector.py::{Detection,
attention_detect, ClipBoxScorer, detect_from_attention_and_sam}``, with
:func:`attention_detect_batch` for a batch of characters (the JAX
Theater's ``vmap`` of it).  The reference runs GroundingDINO on every
generated character (``utils/detector.py:5-21``) and regenerates with a
new seed when it finds nothing (``theatergen.py:98-160``); the port's
GroundingDINO is ``perception/gdino.py``, the turn's detector where the
bundle carries one.  Without it, the character pass's captured
cross-attention maps of the character's word token localise it, so the
default detector needs no weights: the box around the strong attention,
accepted when it holds enough of the attention's mass and area.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops import geometry as G


@dataclasses.dataclass
class Detection:
    box: torch.Tensor         # [4] normalised [x0, y0, x1, y1]
    confidence: torch.Tensor  # scalar
    ok: torch.Tensor          # bool scalar


def attention_detect(attn_maps: Sequence[torch.Tensor],
                     word_token: Optional[int] = None, *,
                     mass_threshold: float = 0.5, min_area: float = 0.001,
                     out_hw: int = 64) -> Detection:
    """Localise a character from its word token's cross-attention.

    Each guidance key's map (``[heads, HW]``, or ``[heads, HW, T]`` with
    ``word_token``) is averaged over heads, resized to ``out_hw``² and
    summed; the sum, normalised by its maximum, is thresholded at
    ``mass_threshold`` and boxed.  ``ok`` where the box's area exceeds
    ``min_area`` and it holds more than a quarter of the attention mass,
    the analogue of DINO's confidence threshold
    (``utils/detector.py:14-20``).  Stays on the maps' device."""
    if word_token is not None:
        attn_maps = [m[:, :, word_token] if m.ndim == 3 else m
                     for m in attn_maps]
    return _detect(attn_maps, mass_threshold, min_area, out_hw)


def attention_detect_batch(attn_maps: Sequence[torch.Tensor], *,
                           mass_threshold: float = 0.5,
                           min_area: float = 0.001,
                           out_hw: int = 64) -> Detection:
    """:func:`attention_detect` of B characters at once (the JAX package's
    ``vmap`` of it, ``theater.py:604-612``): per key ``[B, heads, HW]``
    maps → a Detection with ``box [B, 4]``, ``confidence [B]`` and ``ok
    [B]``, element b equal to the detection of element b's maps; a caller
    reads every ``ok`` in one host sync."""
    return _detect(attn_maps, mass_threshold, min_area, out_hw)


def _detect(attn_maps, mass_threshold, min_area, out_hw) -> Detection:
    """The detection over maps ``[..., heads, HW]`` (any leading axes)."""
    first = attn_maps[0]
    lead = tuple(first.shape[:-2])
    agg = torch.zeros(lead + (out_hw, out_hw), dtype=torch.float32,
                      device=first.device)
    for m in attn_maps:
        m = m.float().mean(-2)                                  # [..., HW]
        side = int(round(m.shape[-1] ** 0.5))
        agg = agg + G.resize_bilinear(m.reshape(lead + (side, side)),
                                      out_hw, out_hw)
    agg = agg / (agg.amax((-2, -1), keepdim=True) + 1e-8)
    binary = (agg > mass_threshold).float()
    box = G.mask_to_box(binary, enlarge_by_one=False).float() / out_hw
    area = (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])
    inside = (agg * binary).sum((-2, -1)) / (agg.sum((-2, -1)) + 1e-8)
    ok = torch.logical_and(area > min_area, inside > 0.25)
    return Detection(box=box, confidence=inside, ok=ok)


class ClipBoxScorer:
    """Score a crop against a phrase with a PAIRED CLIP embedder (both
    towers in one joint space — see ``eval.cmig.ClipEmbedder``) — the
    verification half of detection (plays the role of DINO's text
    threshold).  Comparing embeddings of unrelated models is meaningless,
    so this takes an embedder, not the generation bundle."""

    def __init__(self, embedder):
        self.embedder = embedder

    def score(self, image, box, phrase: str) -> float:
        """Cosine similarity between the box crop and the phrase."""
        from ..eval.metrics import cosine_similarity, crop

        crop_img = crop(_host(image), _host(box))
        img_e = self.embedder.embed_images([crop_img])
        txt_e = self.embedder.embed_texts([phrase])
        return float(cosine_similarity(img_e, txt_e)[0])


def _host(x):
    """A tensor (any device) or array as a numpy array."""
    import numpy as np

    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def detect_from_attention_and_sam(attn_maps, word_token, sam_segment_fn=None,
                                  image=None
                                  ) -> Tuple[Detection,
                                             Optional[torch.Tensor]]:
    """Attention detection, its box then refined into a mask by
    ``sam_segment_fn(image, box) → (masks, scores)`` where both are given
    (the reference's DINO box → SAM chain, ``theatergen.py:162-182``)."""
    d = attention_detect(attn_maps, word_token)
    mask = None
    if sam_segment_fn is not None and image is not None:
        masks, _ = sam_segment_fn(image, d.box)
        mask = masks[0]
    return d, mask
