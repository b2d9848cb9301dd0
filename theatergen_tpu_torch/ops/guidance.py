"""Cross-attention maps for guidance: the port of
``theatergen_tpu/ops/guidance.py::attn_collection_to_maps``.  The rest of
that module (the energy and its losses) comes with latent guidance.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch


def attn_collection_to_maps(
        captured: Mapping[Tuple[str, int, int, int], torch.Tensor],
        capture_keys: Sequence[Tuple[str, int, int, int]],
        cond_batch_index: int = 1, text_len: Optional[int] = None) -> list:
    """``[heads, HW, T]`` fp32 maps of the cond branch, ordered like
    ``capture_keys``, from the UNet's capture (``{key: probs [B, heads, HW,
    Lk]}`` with B = [uncond, cond] under CFG); ``text_len`` keeps the first
    T keys."""
    maps = []
    for key in capture_keys:
        m = captured[tuple(key)][cond_batch_index].float()
        maps.append(m if text_len is None else m[..., :text_len])
    return maps
