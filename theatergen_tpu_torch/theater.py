"""The back half of a turn as plain functions: the step mean of the
reference attention maps, the character mask from them, and the
composition program that feeds the final pass.

The port of the module-level parts of ``theatergen_tpu/theater.py``
(``_attn_mask_fallback``, ``_compose_program``) and of the step mean in
``Theater._aggregate_attn``.  The ``Theater`` orchestrator itself
(``run_turn``: dedup, the character DB, detect-and-regenerate) comes with
the CLI.  Everything stays on the tensors' device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .ops import geometry as G
from .ops import latents as L
from .ops.lineart import dog_lineart

# the reference aggregates the late, semantically stable steps
ATTN_AGG_START = 10


def aggregate_attn(ref_attn: Sequence[torch.Tensor], num_steps: int
                   ) -> List[torch.Tensor]:
    """Mean over steps ≥ ``ATTN_AGG_START`` (the last step where a run
    is shorter) of each guidance key's maps, ``[S, heads, HW]`` →
    ``[heads, HW]``, or batched ``[B, S, heads, HW]`` → ``[B, heads,
    HW]``; fp32."""
    start = min(ATTN_AGG_START, max(num_steps - 1, 0))
    out = []
    for m in ref_attn:
        if m.ndim == 4:
            out.append(m[:, start:].float().mean(1))
        else:
            out.append(m[start:].float().mean(0))
    return out


def _attn_mask_fallback(maps: Sequence[torch.Tensor], hint: torch.Tensor,
                        h: int, w: int, H: int, W: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A character's mask without a segmenter: the step-mean maps
    (``[heads, HW]`` each) averaged over heads, resized to the latent grid
    and summed, normalised by their maximum; the mask holds where that
    exceeds 0.3, or 0.1 inside the box ``hint``.  Returns ``(latent mask
    [h, w], pixel mask [H, W])``, {0, 1} fp32."""
    agg = torch.zeros((h, w), dtype=torch.float32, device=hint.device)
    for m in maps:
        mm = m.float().mean(0)
        side = int(round(mm.shape[0] ** 0.5))
        agg = agg + G.resize_bilinear(mm.reshape(side, side), h, w)
    agg = agg / (agg.max() + 1e-8)
    box_m = G.box_mask(hint.float(), h, w)
    m_lat = torch.maximum((agg > 0.3).float(), box_m * (agg > 0.1).float())
    return m_lat, G.upsample_nearest(m_lat, H, W)


def _compose_program(lineart_module=None):
    """Alignment, trajectory composition, the pixel collage, the lineart
    hint and the frozen mask, as one function.  Only the default path's
    weightless lineart (``dog_lineart``) is ported: a lineart annotator
    needs a checkpoint.

    ``run(traj [K, S+1, 1, h, w, 4], masks_lat [K, h, w], masks_pix [K, H,
    W], images [K, H, W, 3], boxes [K, 4], valid [K], bg_lat [1, h, w, 4])
    -> (composed [S+1, 1, h, w, 4], collage [H, W, 3], cond_img [H, W, 3],
    frozen_mask [h, w])``."""
    if lineart_module is not None:
        raise NotImplementedError(
            "a lineart annotator needs a checkpoint; only dog_lineart is "
            "ported")

    def run(traj, masks_lat, masks_pix, images, boxes, valid, bg_lat):
        traj_a, masks_a, _ = L.align_with_boxes(traj, masks_lat, boxes)
        composed, fg_idx = L.compose_trajectories(traj_a, masks_a, bg_lat)
        collage, _ = L.collage_images(images, masks_pix, boxes, valid)
        return composed, collage, dog_lineart(collage), (fg_idx > 0).float()

    return run
