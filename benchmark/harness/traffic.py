"""The load: closed-loop story sessions drawn from a traffic file.

A traffic file fixes the shape of the load and the seed draws only its
content.  The shape: the number of sessions, the cycle of turn shapes
(which characters each turn holds, so its character count and DB hits),
where each session starts in the cycle (``stagger``, ``offset``), how many
rounds (one turn of every session) make a repeat of the mix, the box
ranges and the server's batching.  The content, per session and
dialogue: the characters' phrases and the background from the word lists,
the boxes, each turn's noise seed, the images of the DB entries a session
needs before its first turn.

Each session plays dialogues of ``len(turns)`` turns back to back.  A
character's id is fresh in every dialogue (``3·j + its index`` in
dialogue ``j``), so each dialogue starts from an empty character DB; a
session that starts inside the cycle finds the characters of the earlier
turns already in its DB, written in set-up.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


class Traffic:
    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, int(seed)
        self.sessions = int(mix["sessions"])
        self.turns = [list(t["objects"]) for t in mix["turns"]]
        self.letters = sorted({c for t in self.turns for c in t})
        self.rounds_per_repeat = int(mix["rounds_per_repeat"])
        self.canvas = int(mix["boxes"]["canvas"])

    # ------------------------------------------------------------- shape

    def start(self, session: int) -> int:
        """The position in the turn cycle of the session's first turn."""
        return ((session * int(self.mix.get("stagger", 0))
                 + int(self.mix.get("offset", 0))) % len(self.turns))

    def position(self, session: int, n: int) -> Tuple[int, int]:
        """(dialogue, turn index) of the session's ``n``-th turn."""
        p = self.start(session) + n
        return divmod(p, len(self.turns))

    def obj_id(self, dialogue: int, letter: str) -> int:
        return len(self.letters) * dialogue + self.letters.index(letter)

    # ----------------------------------------------------------- content

    def _rng(self, *key: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, *key]))

    def dialogue(self, session: int, dialogue: int) -> dict:
        """The content of one dialogue of a session, drawn in one fixed
        order from its own stream."""
        mix, rng = self.mix, self._rng(session, dialogue)
        phrases = {}
        for c in self.letters:
            adj = mix["adjectives"][rng.integers(len(mix["adjectives"]))]
            noun = mix["nouns"][rng.integers(len(mix["nouns"]))]
            phrases[c] = f"a {adj} {noun}"
        b = mix["boxes"]
        turns = []
        for shape in self.turns:
            bg = mix["backgrounds"][rng.integers(len(mix["backgrounds"]))]
            boxes = []
            for _ in shape:
                w = int(rng.integers(b["w"][0], b["w"][1] + 1))
                h = int(rng.integers(b["h"][0], b["h"][1] + 1))
                x = int(rng.integers(0, self.canvas - w + 1))
                y = int(rng.integers(0, self.canvas - h + 1))
                boxes.append([x, y, w, h])
            turns.append(dict(bg=bg, boxes=boxes,
                              seed=int(rng.integers(0, 2 ** 31 - 1))))
        return dict(phrases=phrases, turns=turns)

    def turn(self, session: int, n: int) -> Tuple[dict, int]:
        """The session's ``n``-th turn: (spec, seed)."""
        j, t = self.position(session, n)
        d = self.dialogue(session, j)
        shape, content = self.turns[t], d["turns"][t]
        names = [d["phrases"][c] for c in shape]
        caption = " and ".join(names) + f" in {content['bg']}"
        spec = {
            "prompt": caption,
            "gen_boxes": [[nm, box] for nm, box in zip(names,
                                                        content["boxes"])],
            "bg_prompt": content["bg"],
            "extra_neg_prompt": "",
            "obj_ids": [self.obj_id(j, c) for c in shape],
            "canvas_height": self.canvas,
            "canvas_width": self.canvas,
        }
        return spec, content["seed"]

    def prefill(self, session: int) -> List[Tuple[int, int]]:
        """The DB entries the session needs before its first turn: ``(obj
        id, image seed)`` of each character that the turns before its
        start in the cycle introduce."""
        j, t = self.position(session, 0)
        seen: Dict[str, None] = {}
        for shape in self.turns[:t]:
            for c in shape:
                seen.setdefault(c)
        rng = self._rng(session, j, 1 << 20)
        return [(self.obj_id(j, c), int(rng.integers(0, 2 ** 31 - 1)))
                for c in seen]

    def check_sessions(self, count: int) -> List[int]:
        """The sessions whose first turns the check compares, drawn from
        the seed: first one of the turns with the most characters, then
        alternately from the half of the sessions it does not lie in and
        from the other, so that both halves of a wave are compared."""
        rng = self._rng(1 << 21)
        sizes = [len(self.turns[self.start(k)]) for k in range(self.sessions)]
        longest = [k for k in range(self.sessions) if sizes[k] == max(sizes)]
        picks = [int(longest[rng.integers(len(longest))])]
        half = self.sessions // 2
        while len(picks) < min(count, self.sessions):
            side = (picks[0] < half) == (len(picks) % 2 == 1)
            pool = [k for k in range(self.sessions) if k not in picks
                    and (k >= half) == side] or \
                [k for k in range(self.sessions) if k not in picks]
            picks.append(int(pool[rng.integers(len(pool))]))
        return picks
