"""Attention-based character detection for the detect-and-regenerate loop.

The port of ``theatergen_tpu/perception/detector.py::{Detection,
attention_detect}``.  The reference runs GroundingDINO on every generated
character (``utils/detector.py:5-21``) and regenerates with a new seed when
it finds nothing (``theatergen.py:98-160``).  The character pass already
captures the cross-attention maps of the character's word token, and they
localise it, so the default detector needs no weights: the box around the
strong attention, accepted when it holds enough of the attention's mass
and area.  ``ClipBoxScorer`` and the SAM-refined detector wait for SAM.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

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
    dev = attn_maps[0].device
    agg = torch.zeros((out_hw, out_hw), dtype=torch.float32, device=dev)
    for m in attn_maps:
        if word_token is not None and m.ndim == 3:
            m = m[:, :, word_token]
        m = m.float().mean(0)                                  # [HW]
        side = int(round(m.shape[0] ** 0.5))
        agg = agg + G.resize_bilinear(m.reshape(side, side), out_hw, out_hw)
    agg = agg / (agg.max() + 1e-8)
    binary = (agg > mass_threshold).float()
    box = G.mask_to_box(binary, enlarge_by_one=False).float() / out_hw
    area = (box[2] - box[0]) * (box[3] - box[1])
    inside = (agg * binary).sum() / (agg.sum() + 1e-8)
    ok = torch.logical_and(area > min_area, inside > 0.25)
    return Detection(box=box, confidence=inside, ok=ok)
