"""LLM layout stage: response parsing, box filtering, and layout evaluation;
the port's own copy of ``theatergen_tpu/utils/layout.py`` (host code;
``eval_layout`` scores through the port's ``eval/metrics.py``).

The reference's stage-one (LLM generates per-turn box layouts) survives only
as fragments: the text-response parser ``parse_input_with_negative``
(``utils/parse.py:66-133``), the box sanitizer ``filter_boxes``
(``:135-235``), the query cache (``utils/cache.py``) and a layout-eval
harness whose imports are missing from the repo
(``scripts/eval_stage_one.py:10-12`` — SURVEY.md §2.9).  This module is the
complete equivalent: a pluggable generator interface + cache,
a non-interactive parser, the sanitizer, and rule-based layout scoring.

Canvas convention matches the reference: 512×512 pixel boxes
``(x, y, w, h)``.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional, Protocol, Sequence, Tuple

from .cache import QueryCache

SIZE_H = SIZE_W = 512

OBJECTS_TEXT = "Objects:"
BG_PROMPT_TEXT = "Background prompt:"
NEG_PROMPT_TEXT = "Negative prompt:"

LAYOUT_PROMPT_TEMPLATE = (
    "You are a layout planner for a {width}x{height} image.\n"
    "Given the caption, list each object with a bounding box and a stable\n"
    "character id, then a background prompt and a negative prompt.\n"
    "Format exactly:\n"
    "Objects: [('name', [x, y, w, h], id), ...]\n"
    "Background prompt: ...\n"
    "Negative prompt: ...\n"
    "Caption: {caption}\n"
)


class LayoutGenerator(Protocol):
    """The LLM stage's interface (the reference's absent ``utils/llm``)."""

    def __call__(self, prompt: str) -> str: ...


def parse_layout_response(text: str):
    """Parse an LLM layout response (non-interactive version of the
    reference's ``parse_input_with_negative``, ``utils/parse.py:66-133``).

    Returns ``(obj_ids, gen_boxes [(name, (x,y,w,h))], bg_prompt,
    neg_prompt)``.
    """
    if OBJECTS_TEXT in text:
        text = text.split(OBJECTS_TEXT, 1)[1]
    parts = text.split(BG_PROMPT_TEXT.rstrip())
    if len(parts) != 2:
        raise ValueError(f"invalid layout response (background prompt): {text!r}")
    boxes_text, rem = parts
    parts = rem.split(NEG_PROMPT_TEXT.rstrip())
    if len(parts) == 2:
        bg_prompt, neg_prompt = parts
    elif len(parts) == 1:
        bg_prompt, neg_prompt = rem, ""
    else:
        raise ValueError(f"invalid layout response (negative prompt): {text!r}")

    boxes_text = boxes_text.strip().rstrip(":").strip()
    try:
        raw = ast.literal_eval(boxes_text)
    except (SyntaxError, ValueError):
        if "No objects" in boxes_text or not boxes_text:
            raw = []
        else:
            raise
    neg_prompt = neg_prompt.strip()
    if neg_prompt == "None":
        neg_prompt = ""

    obj_ids, gen_boxes = [], []
    for item in raw:
        if len(item) >= 3:
            name, box, oid = item[0], item[1], item[-1]
        else:
            name, box = item
            oid = len(obj_ids)
        obj_ids.append(oid)
        gen_boxes.append((str(name), tuple(box)))
    return obj_ids, gen_boxes, bg_prompt.strip(), neg_prompt


def filter_boxes(gen_boxes, scale_boxes: bool = True,
                 ignore_background: bool = True, max_scale: float = 3.0,
                 return_indices: bool = False, force_scale: bool = False):
    """Sanitize layout boxes: drop empty/background boxes, rescale/shift
    out-of-bounds layouts to fit the canvas (reference ``filter_boxes``,
    ``utils/parse.py:135-235``; dict entries with ``name``/``bounding_box``
    keys are accepted for compatibility).  ``return_indices=True`` also
    returns the surviving input indices so callers can keep per-box
    metadata (character ids) aligned."""
    import numpy as np

    if not gen_boxes:
        return ([], []) if return_indices else []

    def unpack(g):
        if isinstance(g, dict):
            return g["name"], g.get("bounding_box")
        return g[0], g[1]

    kept = []
    kept_idx = []
    # only rescale when boxes actually fall outside the canvas (the
    # reference always rescales with scale_boxes=True, which mangles valid
    # layouts — pass force_scale=True for reference-exact behavior)
    needs_scale = force_scale
    for gi, g in enumerate(gen_boxes):
        name, box = unpack(g)
        if not box:
            continue
        x, y, w, h = box
        if w <= 0 or h <= 0:
            continue
        if ignore_background and ((w >= SIZE_W and h >= SIZE_H)
                                  or x > SIZE_W or y > SIZE_H):
            continue
        if scale_boxes and (x < 0 or y < 0 or x + w > SIZE_W
                            or y + h > SIZE_H):
            needs_scale = True
        kept.append((name, (x, y, w, h)))
        kept_idx.append(gi)
    if not kept:
        return ([], []) if return_indices else []

    x_min = min(b[1][0] for b in kept)
    x_max = max(b[1][0] + b[1][2] for b in kept)
    y_min = min(b[1][1] for b in kept)
    y_max = max(b[1][1] + b[1][3] for b in kept)
    if x_max - x_min == 0:
        return []
    shift = -x_min
    scale = min(SIZE_W / (x_max - x_min), SIZE_H / max(y_max - y_min, 1e-6),
                max_scale)

    out = []
    for name, (x, y, w, h) in kept:
        if needs_scale:
            x = (x + shift) * scale
            y = y * scale
            w, h = w * scale, h * scale
            y_off = 0.0
            if y_min * scale + y_off < 0:
                y_off -= y_min * scale
            if y_max * scale + y_off >= SIZE_H:
                y_off -= y_max * scale - SIZE_H
            y += y_off
            if y < 0:
                y, h = 0, h - y
        out.append((name.rstrip("."),
                    (int(np.round(x)), int(np.round(y)),
                     int(np.round(w)), int(np.round(h)))))
    if return_indices:
        return out, kept_idx
    return out


def generate_layout(
    caption: str,
    generator: LayoutGenerator,
    cache: Optional[QueryCache] = None,
    height: int = SIZE_H, width: int = SIZE_W,
):
    """Full stage-one step: prompt → (cached) LLM → parsed + filtered spec
    dict, ready for ``utils/parse.py::convert_spec``."""
    prompt = LAYOUT_PROMPT_TEMPLATE.format(
        caption=caption, height=height, width=width)
    if cache is not None:
        response = cache.get_or_compute(prompt, lambda: generator(prompt))
    else:
        response = generator(prompt)
    obj_ids, boxes, bg, neg = parse_layout_response(response)
    boxes, kept = filter_boxes(boxes, return_indices=True)
    return {
        "prompt": caption, "gen_boxes": boxes, "bg_prompt": bg,
        "extra_neg_prompt": neg,
        # keep character ids aligned with their surviving boxes
        "obj_ids": [obj_ids[i] for i in kept],
    }


# ------------------------------------------------------------- layout eval

def eval_layout(caption: str, gen_boxes: Sequence) -> dict:
    """Rule-based layout scoring (the reference's stage-one eval intent,
    ``scripts/eval_stage_one.py:16-23,62-83``): object-mention coverage,
    count consistency, in-bounds rate, and overlap sanity."""
    import numpy as np

    from ..eval.metrics import check_spatial, parse_spatial_relation

    names = [b[0] for b in gen_boxes]
    cap = caption.lower()

    def head(n):
        return n.lower().split(" ")[-1]

    mentioned = [head(n) for n in names if head(n) in cap]
    coverage = len(mentioned) / max(len(names), 1)

    in_bounds = [
        0 <= x and 0 <= y and x + w <= SIZE_W and y + h <= SIZE_H
        for _, (x, y, w, h) in gen_boxes
    ]

    rel = parse_spatial_relation(caption)
    spatial_ok = None
    if rel and len(gen_boxes) >= 2:
        def norm(b):
            x, y, w, h = b
            return (x / SIZE_W, y / SIZE_H, (x + w) / SIZE_W, (y + h) / SIZE_H)

        spatial_ok = check_spatial(rel, norm(gen_boxes[0][1]),
                                   norm(gen_boxes[1][1]))

    return {
        "num_boxes": len(gen_boxes),
        "mention_coverage": coverage,
        "in_bounds_rate": float(np.mean(in_bounds)) if in_bounds else 1.0,
        "spatial_ok": spatial_ok,
    }
