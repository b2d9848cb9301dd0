"""Metric primitives for the CMIGBench evaluation suite, the port's own
copy of ``theatergen_tpu/eval/metrics.py`` (numpy and scipy only: nothing
here runs on a device), ``sqrtm`` called so that scipy releases without
its ``disp`` argument give the same root.

Re-implementation of the reference's metric machinery
(``CMIGBench/eval/eval.py``, SURVEY.md §2.10):

- **CCS** (character-character similarity): CLIP cosine between a detected
  character crop and its first-appearance reference crop
  (``eval.py:97-193``).
- **TIS** (text-image similarity): CLIP logits between caption and image
  (``eval.py:197-228``).
- **FID** over crop sets (``eval.py:66-94``) — Fréchet distance in a
  pluggable feature space (InceptionV3 in the reference; any embedding
  model here), with a scipy-free Newton–Schulz matrix sqrt.
- Box-geometry rules for spatial accuracy (``eval_extra.py:51-185``).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import numpy as np


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-8)
    b = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-8)
    return (a * b).sum(-1)


def clip_logit(image_embed: np.ndarray, text_embed: np.ndarray,
               logit_scale: float = 100.0) -> np.ndarray:
    """CLIP logits_per_image, the reference's TIS score (``eval.py:197-228``)."""
    return logit_scale * cosine_similarity(image_embed, text_embed)


def _sqrtm_newton_schulz(a: np.ndarray, iters: int = 30) -> np.ndarray:
    """Matrix square root via Newton–Schulz (no scipy in this image)."""
    norm = np.linalg.norm(a)
    if norm < 1e-12:
        return np.zeros_like(a)
    y = a / norm
    z = np.eye(a.shape[0], dtype=a.dtype)
    eye = np.eye(a.shape[0], dtype=a.dtype)
    for _ in range(iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y = y @ t
        z = t @ z
    return y * np.sqrt(norm)


def _scipy_sqrtm(linalg, a: np.ndarray) -> np.ndarray:
    """``scipy.linalg.sqrtm(a, disp=False)``'s root, as the JAX package
    calls it; scipy releases that no longer take ``disp`` return the root
    alone, the same values."""
    import inspect

    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        return linalg.sqrtm(a, disp=False)[0]
    return linalg.sqrtm(a)


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FID between two feature sets [N, D] — the exact pytorch_fid
    ``calculate_frechet_distance`` algorithm the reference calls
    (``eval.py:66-94``): scipy ``sqrtm`` with the eps-jitter retry and
    imaginary-part discard; Newton–Schulz fallback without scipy."""
    mu1, mu2 = feats_a.mean(0), feats_b.mean(0)
    s1 = np.cov(feats_a, rowvar=False)
    s2 = np.cov(feats_b, rowvar=False)
    diff = mu1 - mu2
    prod = (s1 @ s2).astype(np.float64)
    try:
        from scipy import linalg

        covmean = _scipy_sqrtm(linalg, prod)
        if not np.isfinite(covmean).all():
            offset = np.eye(s1.shape[0]) * eps
            covmean = _scipy_sqrtm(linalg, (s1 + offset) @ (s2 + offset))
        if np.iscomplexobj(covmean):
            covmean = covmean.real
    except ImportError:
        covmean = _sqrtm_newton_schulz(prod)
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * np.trace(covmean))


# --------------------------------------------------------------- spatial


def eval_spatial_reference(
    detections: Sequence[Tuple[str, Sequence[float]]],
    caption: str,
    n_expected: int,
    middle_thresh: float = 300.0 / 512.0,
) -> Optional[bool]:
    """The reference's named-object spatial check, faithfully
    (``eval_extra.py:51-185``):

    - every object must be detected (count match) or the turn fails;
    - the caption is matched against ``to the right of`` / ``to the left
      of`` / ``to the top of`` / ``to the down of`` / ``below`` /
      ``in the middle of`` (that priority order);
    - e.g. for "A to the right of B": the *leftmost* detected box's name
      must end with B's last word (and symmetrically for the others);
    - "in the middle of" with two objects checks center distance below
      ~300px on a 512 canvas (normalized here).

    ``detections`` are (name, [x0, y0, x1, y1] normalized).  Returns None
    when the caption asserts no known relation (turn not scored).
    """
    import math

    def last_word(s: str) -> str:
        w = s.strip().split()
        return w[-1] if w else s

    def center(box):
        return ((box[0] + box[2]) / 2, (box[1] + box[3]) / 2)

    rules = [
        (r"(.+?)\sto the right of\s(.+)",
         lambda: min(detections, key=lambda d: d[1][0])),   # leftmost
        (r"(.+?)\sto the left of\s(.+)",
         lambda: max(detections, key=lambda d: d[1][0])),   # rightmost
        (r"(.+?)\sto the top of\s(.+)",
         lambda: max(detections, key=lambda d: d[1][1])),   # bottom-most
        (r"(.+?)\sto the down of\s(.+)",
         lambda: min(detections, key=lambda d: d[1][1])),   # top-most
        (r"(.+?)\sbelow\s(.+)",
         lambda: min(detections, key=lambda d: d[1][1])),
    ]
    for pattern, pick in rules:
        m = re.search(pattern, caption)
        if m:
            if len(detections) != n_expected:
                return False
            return last_word(m.group(2)) == last_word(pick()[0])
    if re.search(r"(.+?)\sin the middle of\s(.+)", caption):
        if len(detections) != n_expected or len(detections) < 2:
            return False
        (ax, ay), (bx, by) = center(detections[0][1]), center(detections[1][1])
        return math.hypot(bx - ax, by - ay) < middle_thresh
    return None


SPATIAL_WORDS = {
    "left": ("left of", "on the left"),
    "right": ("right of", "on the right"),
    "top": ("above", "on top of", "top of"),
    "bottom": ("below", "under", "beneath", "at the bottom"),
    "middle": ("in the middle", "between", "center"),
}


def parse_spatial_relation(caption: str) -> Optional[str]:
    """Extract the asserted spatial relation from a caption
    (the regex rule set of ``eval_extra.py:51-185``)."""
    c = caption.lower()
    for rel, pats in SPATIAL_WORDS.items():
        for p in pats:
            if re.search(rf"\b{re.escape(p)}\b", c):
                return rel
    return None


def check_spatial(rel: str, box_a: Sequence[float],
                  box_b: Sequence[float]) -> bool:
    """Does box_a stand in relation ``rel`` to box_b? Centers-based
    geometry, as in the reference's box checks (``eval_extra.py:51-185``)."""
    ax = (box_a[0] + box_a[2]) / 2
    ay = (box_a[1] + box_a[3]) / 2
    bx = (box_b[0] + box_b[2]) / 2
    by = (box_b[1] + box_b[3]) / 2
    if rel == "left":
        return ax < bx
    if rel == "right":
        return ax > bx
    if rel == "top":
        return ay < by
    if rel == "bottom":
        return ay > by
    if rel == "middle":
        return abs(ax - 0.5) < 0.25
    return False


def crop(image: np.ndarray, box_norm: Sequence[float]) -> np.ndarray:
    """Crop a normalized box from an [H, W, 3] image (min 8px sides)."""
    h, w = image.shape[:2]
    x0 = int(np.clip(box_norm[0] * w, 0, w - 1))
    y0 = int(np.clip(box_norm[1] * h, 0, h - 1))
    x1 = int(np.clip(box_norm[2] * w, x0 + 1, w))
    y1 = int(np.clip(box_norm[3] * h, y0 + 1, h))
    x1 = max(x1, min(x0 + 8, w))
    y1 = max(y1, min(y0 + 8, h))
    return image[y0:y1, x0:x1]
