"""Cross-attention guidance energies: the port of
``theatergen_tpu/ops/guidance.py``.

The reference's loss stack (``utils/guidance.py``) over padded inputs:
per-object token positions are ``[K, P]`` index arrays with validity masks,
``max_objects`` slots with an object mask, and the ``topk(k = area ·
top_p)`` a sort with a prefix mask whose ``k`` is a tensor, so nothing
here reads a value on the host.  The JAX package's ``vmap`` over objects
and tokens becomes batched indexing.  :mod:`..pipelines.guidance`
differentiates the energy with respect to the latents.

Attention maps are ``[heads, HW, T]``: the cond branch's cross-attention
probabilities at one guidance key (:func:`attn_collection_to_maps`).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import torch

from . import geometry as G


def map_shape(hw: int, latent_hw=None) -> Tuple[int, int]:
    """(h, w) of a flattened attention map: square by default; with the
    latent aspect ratio given, h·w = hw with h/w = lat_h/lat_w."""
    if latent_hw is None:
        h = w = int(round(hw ** 0.5))
    else:
        lh, lw = latent_hw
        h = int(round((hw * lh / lw) ** 0.5))
        w = hw // max(h, 1)
    assert h * w == hw, (hw, latent_hw)
    return h, w


def topk_mean(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Mean of the ``k`` largest entries along the last axis; ``k`` is a
    tensor broadcast against ``x``'s leading axes, clipped to [1, n] and
    truncated to an integer.  A descending sort and a prefix mask, so
    ``k`` stays on the device."""
    n = x.shape[-1]
    k = torch.as_tensor(k, device=x.device).clamp(1, n).to(torch.int32)
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    idx = torch.arange(n, device=x.device, dtype=torch.int32)
    take = (idx < k[..., None]).to(x.dtype)
    return (sorted_desc * take).sum(-1) / k.to(x.dtype)


def box_ca_loss_single_key(attn: torch.Tensor, boxes: torch.Tensor,
                           token_pos: torch.Tensor,
                           token_valid: torch.Tensor,
                           obj_valid: torch.Tensor, *,
                           fg_top_p: float = 0.2, bg_top_p: float = 0.2,
                           fg_weight: float = 1.0, bg_weight: float = 1.0,
                           latent_hw=None) -> torch.Tensor:
    """Max-based in/out-box loss of one guidance key (the reference's
    ``add_ca_loss_per_attn_map_to_loss``, ``utils/guidance.py:131-144``):
    the top-k attention inside an object's box should be 1 (weight
    ``fg_weight``), outside it 0 (``bg_weight``); summed over heads,
    averaged over the object's valid tokens, summed over valid objects.

    ``attn [heads, HW, T]``, ``boxes [K, 4]`` normalised, ``token_pos`` and
    ``token_valid`` ``[K, P]``, ``obj_valid [K]``."""
    hw = attn.shape[1]
    h, w = map_shape(hw, latent_hw)
    k_obj = boxes.shape[0]
    mask = G.box_mask(boxes.float(), h, w).reshape(k_obj, hw)
    k_fg = torch.clamp_min(mask.sum(-1) * fg_top_p, 1.0)
    k_bg = torch.clamp_min((1 - mask).sum(-1) * bg_top_p, 1.0)
    # [K, P, heads, HW]: each object's token maps
    ca = attn.permute(2, 0, 1)[token_pos.long()]
    fg_in = ca * mask[:, None, None, :]
    bg_in = ca * (1 - mask)[:, None, None, :]
    fg = (1.0 - topk_mean(fg_in, k_fg[:, None, None])).sum(-1) * fg_weight
    bg = topk_mean(bg_in, k_bg[:, None, None]).sum(-1) * bg_weight
    tok = (fg + bg) * token_valid.to(attn.dtype)
    n = torch.clamp_min(token_valid.sum(-1), 1)
    return (tok.sum(-1) / n * obj_valid.to(attn.dtype)).sum()


def ref_ca_transfer_loss_single_key(attn: torch.Tensor,
                                    ref_attn: torch.Tensor,
                                    boxes: torch.Tensor,
                                    word_token: torch.Tensor,
                                    obj_valid: torch.Tensor,
                                    eps: float = 1e-5,
                                    latent_hw=None) -> torch.Tensor:
    """Attention-transfer L1 of one guidance key (the reference's
    ``add_ref_ca_loss_per_attn_map_to_lossv2``,
    ``utils/guidance.py:220-242``): the current map at each object's word
    token and its reference map ``ref_attn [K, heads, HW]``, each masked to
    the object's box and normalised to sum 1 over space, compared by an
    L1 summed over space and averaged over heads."""
    hw = attn.shape[1]
    h, w = map_shape(hw, latent_hw)
    k_obj = boxes.shape[0]
    mask = G.box_mask(boxes.float(), h, w).reshape(k_obj, 1, hw)
    cur = attn.permute(2, 0, 1)[word_token.long()] * mask
    cur = cur / (cur.sum(-1, keepdim=True) + eps)
    r = ref_attn * mask
    r = r / (r.sum(-1, keepdim=True) + eps)
    per_obj = (cur - r).abs().sum(-1).mean(-1)
    return (per_obj * obj_valid.to(attn.dtype)).sum()


def compute_ca_loss(attn_maps: Sequence[torch.Tensor], boxes: torch.Tensor,
                    token_pos: torch.Tensor, token_valid: torch.Tensor,
                    obj_valid: torch.Tensor, *,
                    ref_attn_maps: Optional[Sequence[torch.Tensor]] = None,
                    word_token: Optional[torch.Tensor] = None,
                    fg_top_p: float = 0.2, bg_top_p: float = 0.2,
                    fg_weight: float = 1.0, bg_weight: float = 1.0,
                    ref_ca_loss_weight: float = 1.0,
                    latent_hw=None) -> torch.Tensor:
    """The guidance energy over every key (the reference's
    ``compute_ca_lossv3``, ``utils/guidance.py:244-286``): the box loss
    summed over keys and divided by objects × keys, plus
    ``ref_ca_loss_weight`` times the transfer loss under the same
    normalisation where reference maps (one ``[K, heads, HW]`` per key)
    are given.  A 0-dim fp32 tensor."""
    num_keys = len(attn_maps)
    n_obj = torch.clamp_min(obj_valid.sum(), 1).to(torch.float32)
    loss = torch.zeros((), dtype=torch.float32, device=boxes.device)
    for attn in attn_maps:
        loss = loss + box_ca_loss_single_key(
            attn, boxes, token_pos, token_valid, obj_valid,
            fg_top_p=fg_top_p, bg_top_p=bg_top_p, fg_weight=fg_weight,
            bg_weight=bg_weight, latent_hw=latent_hw)
    loss = loss / (n_obj * num_keys)
    if ref_attn_maps is not None:
        assert word_token is not None
        ref_loss = torch.zeros((), dtype=torch.float32, device=boxes.device)
        for attn, ref in zip(attn_maps, ref_attn_maps):
            ref_loss = ref_loss + ref_ca_transfer_loss_single_key(
                attn, ref, boxes, word_token, obj_valid, latent_hw=latent_hw)
        loss = loss + ref_ca_loss_weight * ref_loss / (n_obj * num_keys)
    return loss


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
