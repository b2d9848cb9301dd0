"""Visualization + image-saving utilities.

Equivalent of the reference's ``utils/vis.py`` (SURVEY.md §2.9): latent /
mask / cross-attention visualization dumps and the ``display()`` saver with
its monotonically-increasing save index (``utils/vis.py:240-264``), which
defines the output-tree contract the eval scripts read.
The port's copy of ``theatergen_tpu/utils/vis.py``: numpy only, its
PNGs written and read by the port's own codec (``utils/png.py``) where
the JAX package uses PIL.  :func:`load_image_rgb` reads PNG files (8-bit,
any colour type but palette) and returns RGB.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from .png import read_png, to_uint8, write_png

_save_ind = 0


def reset_save_ind() -> None:
    """Reference ``vis.reset_save_ind`` (``utils/vis.py:240``)."""
    global _save_ind
    _save_ind = 0


def display(image: np.ndarray, save_prefix: str = "",
            ind: Optional[int] = None, save_ind_in_filename: bool = True,
            img_dir: str = ".") -> str:
    """Save an image following the reference's naming scheme
    (``utils/vis.py:244-264``): ``img_{ind}.png`` with an auto-increment
    index. Returns the path."""
    global _save_ind
    os.makedirs(img_dir, exist_ok=True)
    if ind is None:
        ind = _save_ind
        _save_ind += 1
    if save_ind_in_filename:
        name = f"{save_prefix}img_{ind}.png" if save_prefix else f"img_{ind}.png"
    else:
        name = f"{save_prefix}.png"
    path = os.path.join(img_dir, name)
    save_image_rgb(path, image)
    return path


def save_image_rgb(path: str, image: np.ndarray) -> None:
    """[H, W, 3] float [0,1] (or uint8) → PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    write_png(path, arr)


def load_image_rgb(path: str) -> np.ndarray:
    """PNG → [H, W, 3] float32 in [0, 1]."""
    return read_png(path).astype(np.float32) / 255.0


def colorize(gray: np.ndarray) -> np.ndarray:
    """[H, W] scalar map → viridis-like RGB [H, W, 3] in [0,1]."""
    g = np.asarray(gray, np.float32)
    g = (g - g.min()) / (g.max() - g.min() + 1e-8)
    # simple 3-stop gradient: dark blue → green → yellow
    r = np.clip(2 * g - 1, 0, 1)
    gch = np.clip(2 * g, 0, 1) * 0.9
    b = np.clip(1 - 2 * g, 0, 1) * 0.6 + 0.2 * (1 - g)
    return np.stack([r, gch, b], -1)


def visualize_latents(latents: np.ndarray) -> np.ndarray:
    """[h, w, 4] (or [1, h, w, 4]) latent → RGB visualization (first three
    channels, normalized) — the reference's latent dumps
    (``utils/vis.py:11-19``)."""
    z = np.asarray(latents)
    if z.ndim == 4:
        z = z[0]
    z = z[..., :3]
    z = (z - z.min()) / (z.max() - z.min() + 1e-8)
    return z


def visualize_masks(masks: Sequence[np.ndarray],
                    seed: int = 0) -> np.ndarray:
    """Overlay several binary masks in random colors (reference
    ``show_masks``, ``utils/parse.py:302-311``)."""
    rng = np.random.RandomState(seed)
    h, w = np.asarray(masks[0]).shape
    canvas = np.zeros((h, w, 3), np.float32)
    for m in masks:
        color = rng.random(3) * 0.6 + 0.4
        canvas += np.asarray(m, np.float32)[..., None] * color[None, None]
    return np.clip(canvas, 0, 1)


def visualize_attn(attn_map: np.ndarray, out_hw: int = 64) -> np.ndarray:
    """[heads, HW] or [HW] attention → upsampled heat map RGB."""
    a = np.asarray(attn_map, np.float32)
    if a.ndim == 2:
        a = a.mean(0)
    side = int(round(len(a) ** 0.5))
    a = a.reshape(side, side)
    reps = out_hw // side
    a = np.repeat(np.repeat(a, reps, 0), reps, 1)
    return colorize(a)


def draw_boxes(image: np.ndarray, boxes: Sequence[Sequence[float]],
               labels: Optional[List[str]] = None) -> np.ndarray:
    """Draw normalized boxes on an image (reference ``draw_box``,
    ``utils/utils.py:8-15``)."""
    img = np.array(image, np.float32).copy()
    h, w = img.shape[:2]
    red = np.array([1.0, 0, 0])
    for box in boxes:
        x0, y0, x1, y1 = (int(box[0] * w), int(box[1] * h),
                          int(box[2] * w), int(box[3] * h))
        x0, x1 = np.clip([x0, x1], 0, w - 1)
        y0, y1 = np.clip([y0, y1], 0, h - 1)
        img[y0:y1 + 1, x0:x0 + 2] = red
        img[y0:y1 + 1, x1 - 1:x1 + 1] = red
        img[y0:y0 + 2, x0:x1 + 1] = red
        img[y1 - 1:y1 + 1, x0:x1 + 1] = red
    return img
