"""Latent seeding and blending, trajectory composition, alignment and the
pixel collage.

The port of ``theatergen_tpu/ops/latents.py::{unscaled_latents,
blend_latents, input_latents_for_boxes, compose_trajectories,
align_with_boxes, collage_images}``: per-object stacks carry a leading
axis of ``max_objects`` slots, and a padded slot (an empty mask, a zero
trajectory, ``valid`` False) changes nothing.  NHWC at the boundary, as
in the JAX package: latents ``[B, h, w, C]``, trajectories ``[S+1, B, h,
w, C]``, images ``[H, W, 3]``; boxes normalised ``[x0, y0, x1, y1]``.
Everything stays on the tensors' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import geometry as G


def unscaled_latents(generator: torch.Generator, shape, *,
                     device=None) -> torch.Tensor:
    """fp32 unit-normal noise of ``shape`` drawn from ``generator`` (on its
    device), then moved to ``device`` (reference ``get_unscaled_latents``,
    ``utils/latents.py:138-149``)."""
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return x if device is None else x.to(device)


def blend_latents(latents_bg: torch.Tensor, latents_fg: torch.Tensor,
                  fg_mask: torch.Tensor, fg_blending_ratio: float = 0.1
                  ) -> torch.Tensor:
    """Variance-preserving fg/bg noise blend inside the mask ``[h, w]``
    (reference ``blend_latents``, ``utils/latents.py:156-166``)."""
    r = fg_blending_ratio
    mask = fg_mask[..., None]                    # over NHWC channels
    blended = latents_bg * (1.0 - r) ** 0.5 + latents_fg * r ** 0.5
    return latents_bg * (1.0 - mask) + blended * mask


def input_latents_for_boxes(generator: Optional[torch.Generator],
                            boxes: torch.Tensor, h: int, w: int, *,
                            fg_blending_ratio: float = 0.1,
                            init_noise_sigma: float = 1.0, channels: int = 4,
                            bg_noise: Optional[torch.Tensor] = None,
                            fg_noise: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared background noise and, per box ``boxes [K, 4]``, foreground
    noise blended into it inside the box (reference
    ``get_input_latents_list``, ``utils/latents.py:257-295``).  Both draws
    come from ``generator``, the background first; ``bg_noise [1, h, w,
    C]`` and ``fg_noise [K, 1, h, w, C]`` replace them (no draw is made
    for a given one).  Returns ``(per_object [K, 1, h, w, C], bg [1, h, w,
    C])``, scaled by ``init_noise_sigma``, on the boxes' device."""
    dev = boxes.device
    k = boxes.shape[0]
    bg = (unscaled_latents(generator, (1, h, w, channels), device=dev)
          if bg_noise is None else bg_noise.to(dev, torch.float32))
    fg = (unscaled_latents(generator, (k, 1, h, w, channels), device=dev)
          if fg_noise is None else fg_noise.to(dev, torch.float32))
    masks = G.box_mask(boxes, h, w)                          # [K, h, w]
    per_obj = torch.stack([blend_latents(bg, fg[i], masks[i],
                                         fg_blending_ratio)
                           for i in range(k)])
    return per_obj * init_noise_sigma, bg * init_noise_sigma


def compose_trajectories(trajectories: torch.Tensor, masks: torch.Tensor,
                         latents_bg: torch.Tensor, *,
                         compose_box_to_bg: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked merge of the objects' trajectories ``[K, S+1, B, h, w, C]``
    under their latent masks ``[K, h, w]``, largest mask first (so smaller
    characters stay on top).  Slot 0 starts from the background noise
    ``latents_bg [B, h, w, C]``, with each object's own t = T noise copied
    in under its mask's bounding box (``compose_box_to_bg``).  Returns
    ``(composed [S+1, B, h, w, C], fg_index [h, w])``, the index being the
    object (+1) that owns each latent pixel, 0 for the background."""
    k = trajectories.shape[0]
    h, w = masks.shape[-2:]
    sizes = masks.sum((1, 2))
    # a stable descending sort: equal sizes keep their slot order, as the
    # JAX package's argsort of the negated sizes does
    order = torch.sort(-sizes, stable=True).indices
    composed = torch.zeros_like(trajectories[0])
    composed[0] = latents_bg
    fg_idx = torch.zeros((h, w), dtype=torch.int32, device=masks.device)
    if compose_box_to_bg:
        scale = torch.tensor([w, h, w, h], dtype=torch.float32,
                             device=masks.device)
        boxes = G.mask_to_box(masks).float() / scale          # [K, 4]
        # an empty slot falls back to the whole-image box: keep it out
        bms = G.box_mask(boxes, h, w) * (sizes > 0).float()[:, None, None]
        for j in range(k):
            bm = bms[order[j]][..., None]
            composed[0] = (composed[0] * (1 - bm)
                           + trajectories[order[j], 0] * bm)
    for j in range(k):
        i = order[j]
        m = masks[i]
        me = m[None, None, :, :, None]
        composed = composed * (1 - me) + trajectories[i] * me
        fg_idx = torch.where(m > 0, (i + 1).to(torch.int32), fg_idx)
    return composed, fg_idx


def align_with_boxes(trajectories: torch.Tensor, masks: torch.Tensor,
                     boxes: torch.Tensor, *, horizontal_only: bool = False,
                     base: int = 8
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shift each object's trajectory ``[S+1, B, h, w, C]`` and mask
    ``[h, w]`` so the mask's mass centre lands on its layout box's centre,
    the offset snapped to 1/``base`` of the canvas.  Returns
    ``(trajectories, masks, offsets [K, 2])``, offsets normalised (x, y).

    The shift moves the latent rows and columns (the h and w axes of the
    NHWC trajectory).  The JAX function hands the trajectory to
    ``shift2d``, which shifts the trailing two axes, w and C there; the
    port shifts h and w, as the reference's ``align_with_bboxes`` does
    (ROADMAP §3)."""
    h, w = masks.shape[-2:]
    cx, cy = G.mask_center(masks, normalize=True)                 # [K]
    tx = (boxes[:, 0] + boxes[:, 2]) / 2 - cx
    ty = (boxes[:, 1] + boxes[:, 3]) / 2 - cy
    if horizontal_only:
        ty = torch.zeros_like(ty)
    dx = torch.round(tx * base).to(torch.int32) * (w // base)
    dy = torch.round(ty * base).to(torch.int32) * (h // base)
    trajs, ms = [], []
    for i in range(trajectories.shape[0]):
        trajs.append(G.shift2d(trajectories[i], dy[i], dx[i], dims=(-3, -2)))
        ms.append(G.shift2d(masks[i], dy[i], dx[i]))
    return torch.stack(trajs), torch.stack(ms), torch.stack([tx, ty], -1)


def collage_images(images: torch.Tensor, masks: torch.Tensor,
                   boxes: torch.Tensor,
                   valid: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mid-image collage: each character ``images [K, H, W, 3]`` cut
    out by its pixel mask ``[K, H, W]``, its mask's bounding box rescaled
    into its layout box (linear, antialiased when it shrinks), pasted in
    slot order on a black canvas where the warped mask exceeds 0.5.
    Returns ``(collage [H, W, 3], union_mask [H, W])``."""
    k, h, w = masks.shape
    dev = masks.device
    if valid is None:
        valid = torch.ones(k, dtype=torch.bool, device=dev)
    canvas = torch.zeros((h, w, 3), dtype=images.dtype, device=dev)
    union = torch.zeros((h, w), dtype=torch.float32, device=dev)
    src = G.mask_to_box(masks).float()                    # [K, 4] pixels
    for i in range(k):
        box = boxes[i].float()
        sw = torch.clamp(src[i, 2] - src[i, 0], min=1.0)
        sh = torch.clamp(src[i, 3] - src[i, 1], min=1.0)
        tx0, ty0 = box[0] * w, box[1] * h
        tw = torch.clamp((box[2] - box[0]) * w, min=1.0)
        th = torch.clamp((box[3] - box[1]) * h, min=1.0)
        scale = (th / sh, tw / sw)
        trans = (ty0 - src[i, 1] * scale[0], tx0 - src[i, 0] * scale[1])
        warped = G.scale_and_translate(images[i] * masks[i][..., None],
                                       (h, w), (0, 1), scale, trans)
        wmask = G.scale_and_translate(masks[i].float(), (h, w), (0, 1),
                                      scale, trans)
        wmask = (wmask > 0.5).float() * valid[i].float()
        canvas = (canvas * (1 - wmask[..., None])
                  + warped.to(canvas.dtype) * wmask[..., None])
        union = torch.maximum(union, wmask)
    return canvas, union
