"""Spec parsing: CMIGBench turn dicts → per-object generation plans.

The port's copy of ``theatergen_tpu/utils/parse.py`` (it imports nothing
of the JAX package).  Equivalent of the reference's ``utils/parse.py``
spec path (``convert_box`` ``:313-320``, ``convert_spec`` ``:322-379``)
with a dependency-free pluralizer replacing ``inflect``.

A turn *spec* is the dict the reference's generate.py builds per turn
(``generate.py:216-226``)::

    {"prompt": caption, "gen_boxes": [(name, (x, y, w, h)), ...],
     "bg_prompt": str, "extra_neg_prompt": str, "obj_ids": [int, ...]}

Boxes arrive in 512-canvas pixel ``(x, y, w, h)`` and convert to
normalized ``(x0, y0, x1, y1)``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

_IRREGULAR = {
    "man": "men", "woman": "women", "child": "children", "person": "people",
    "mouse": "mice", "goose": "geese", "foot": "feet", "tooth": "teeth",
    "wolf": "wolves", "knife": "knives", "leaf": "leaves", "sheep": "sheep",
    "deer": "deer", "fish": "fish",
}

_NUMBER_WORDS = ["zero", "one", "two", "three", "four", "five", "six",
                 "seven", "eight", "nine", "ten", "eleven", "twelve"]


def plural_noun(noun: str) -> str:
    """Small English pluralizer (stand-in for inflect.plural_noun,
    reference ``utils/parse.py:352``)."""
    words = noun.split(" ")
    head = words[-1].lower()
    if head in _IRREGULAR:
        out = _IRREGULAR[head]
    elif head.endswith(("s", "x", "z", "ch", "sh")):
        out = head + "es"
    elif head.endswith("y") and len(head) > 1 and head[-2] not in "aeiou":
        out = head[:-1] + "ies"
    elif head.endswith("f"):
        out = head[:-1] + "ves"
    elif head.endswith("fe"):
        out = head[:-2] + "ves"
    else:
        out = head + "s"
    return " ".join(words[:-1] + [out])


def number_to_words(n: int) -> str:
    return _NUMBER_WORDS[n] if 0 <= n < len(_NUMBER_WORDS) else str(n)


def strip_article(phrase: str) -> str:
    for art in ("an ", "a ", "the "):
        if phrase.startswith(art):
            return phrase[len(art):]
    return phrase


def convert_box(box: Sequence[float], height: float, width: float
                ) -> Tuple[float, float, float, float]:
    """(x, y, w, h) pixels → normalized (x0, y0, x1, y1), clamped to the
    canvas (reference ``utils/parse.py:313-320``; the clamp mirrors
    ``filter_boxes``'s ``:135-235`` bounds discipline — an out-of-canvas
    box would otherwise silently degenerate every downstream guidance
    mask)."""
    x0, y0 = box[0] / width, box[1] / height
    x1, y1 = x0 + box[2] / width, y0 + box[3] / height
    clamp = lambda v: min(max(v, 0.0), 1.0)
    return (clamp(x0), clamp(y0), clamp(x1), clamp(y1))


@dataclasses.dataclass
class ObjectPlan:
    """One character's single-object generation plan."""

    prompt: str          # bg-aware prompt for single-object generation
    phrase: str          # the full object phrase ("an orange cat")
    word: str            # the attention-transfer word ("cat")
    box: Tuple[float, float, float, float]   # normalized layout box
    obj_id: int


@dataclasses.dataclass
class TurnPlan:
    objects: List[str]
    bg_prompt: str
    object_plans: List[ObjectPlan]
    overall_prompt: str
    overall_phrases: List[Tuple[str, str, List[Tuple[float, float, float, float]]]]
    obj_ids: List[int]


def convert_spec(spec: dict, height: int = 512, width: int = 512,
                 include_counts: bool = True) -> TurnPlan:
    """Spec dict → TurnPlan (reference ``convert_spec``,
    ``utils/parse.py:322-379``): boxes sorted by name for stable grouping,
    per-object prompts of the form "{bg} with {name}", overall prompt with
    pluralized duplicate groups.

    Boxes normalize against the spec's authoring canvas when given
    (``spec["canvas_height"/"canvas_width"]`` — CMIGBench authors at 512)
    and the render size otherwise (the reference divides by the render
    size, which coincides at 512).  The explicit canvas makes boxes
    resolution-independent, e.g. for tiny-config smoke runs over the
    512-authored sample data."""
    canvas_h = spec.get("canvas_height") or height
    canvas_w = spec.get("canvas_width") or width
    gen_boxes = list(spec["gen_boxes"])
    obj_ids = list(spec.get("obj_ids", range(len(gen_boxes))))
    order = sorted(range(len(gen_boxes)), key=lambda i: gen_boxes[i][0])
    gen_boxes = [gen_boxes[i] for i in order]
    obj_ids = [obj_ids[i] for i in order]

    bg_prompt = spec.get("bg_prompt") or ""
    boxes_n = [(name, convert_box(box, canvas_h, canvas_w))
               for name, box in gen_boxes]

    plans = []
    for (name, box), oid in zip(boxes_n, obj_ids):
        prompt = f"{bg_prompt} with {name}" if bg_prompt else name
        plans.append(ObjectPlan(
            prompt=prompt, phrase=name, word=name.split(" ")[-1],
            box=box, obj_id=oid,
        ))

    objects = [name for name, _ in boxes_n]
    groups: dict = {}
    for name, box in boxes_n:
        groups.setdefault(name, []).append(box)

    overall_phrases = []
    for name in sorted(groups):
        bxs = groups[name]
        if len(bxs) > 1:
            phrase = plural_noun(strip_article(name))
            if include_counts:
                phrase = f"{number_to_words(len(bxs))} {phrase}"
        else:
            phrase = name
        overall_phrases.append((phrase, phrase.split(" ")[-1], bxs))

    objects_str = ", ".join(p for p, _, _ in overall_phrases)
    if objects_str:
        overall = f"{bg_prompt} with {objects_str}" if bg_prompt else objects_str
    else:
        overall = bg_prompt

    return TurnPlan(
        objects=objects, bg_prompt=bg_prompt, object_plans=plans,
        overall_prompt=overall, overall_phrases=overall_phrases,
        obj_ids=obj_ids,
    )


# Default negative prompts: character-identical to reference prompt.py:1-2.
# These strings are behavioral constants — they define the released model's
# output behavior, so parity requires the exact wording, not a paraphrase.
DEFAULT_SO_NEGATIVE_PROMPT = (
    "artifacts, blurry, smooth texture, bad quality, distortions, "
    "unrealistic, distorted image, bad proportions, duplicate, two, many, "
    "group, occlusion, occluded, side, border, collate"
)
DEFAULT_OVERALL_NEGATIVE_PROMPT = (
    "artifacts, blurry, smooth texture, bad quality, distortions, "
    "unrealistic, distorted image, bad proportions, duplicate"
)
