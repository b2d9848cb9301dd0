"""CLIP tokenization, self-contained (the port's copy of
``theatergen_tpu/utils/tokenizer.py``; ids are identical, which a test
checks).

Two implementations behind one interface:

- :class:`CLIPBPETokenizer` — a full byte-level BPE matching OpenAI CLIP's
  scheme (lowercasing, whitespace cleanup, ``</w>`` word suffixes, 49408
  vocab).  It needs only ``merges.txt`` (the vocabulary is derivable from
  the merge list); ``vocab.json`` is used when present.
- :class:`HashTokenizer` — a deterministic, vocabulary-free stand-in for
  weightless testing: every whitespace/punct-split word maps to a stable
  id sequence.  Phrase-index search (the guidance machinery's requirement,
  reference ``utils/guidance.py:32-89``) works identically on both.

The interface mirrors what the reference gets from HF's ``CLIPTokenizer``:
``encode(text) -> list[int]``, ``__call__(texts, padding to max_len)``,
plus ``token_strings`` used by phrase-index search (the reference's
``get_token_map``, ``utils/guidance.py:10-30``).
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import json
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

BOS = 49406
EOS = 49407
VOCAB_SIZE = 49408
MAX_LEN = 77


@functools.lru_cache()
def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP byte↔unicode table: printable chars for all 256 bytes."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's word pattern (ASCII classes; the \p{L} unicode classes of the
# original need the third-party `regex` module, which CMIGBench never hits —
# its prompts are English).
_WORD_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
    re.IGNORECASE,
)


class HashTokenizer:
    """Deterministic vocabulary-free tokenizer for tests / weightless runs.

    One id per cleaned word, stable across processes (md5-based, not
    Python ``hash``).  Ids live in [1000, vocab) to avoid specials.
    """

    model_max_length = MAX_LEN

    def __init__(self, vocab_size: int = VOCAB_SIZE, max_length: int = MAX_LEN):
        self.vocab_size = vocab_size
        self.max_length = max_length
        # CLIP's specials when the full vocab is in play; shrink to fit
        # otherwise (tiny test configs).
        self.bos_token_id = BOS if vocab_size >= VOCAB_SIZE else vocab_size - 2
        self.eos_token_id = EOS if vocab_size >= VOCAB_SIZE else vocab_size - 1

    def _word_id(self, word: str) -> int:
        h = int(hashlib.md5(word.encode()).hexdigest(), 16)
        lo = min(1000, self.vocab_size // 4)
        hi = self.bos_token_id
        return lo + h % (hi - lo)

    def encode_words(self, text: str) -> List[tuple]:
        """[(word, [ids])] — one id per word here; BPE gives several."""
        text = _whitespace_clean(_basic_clean(text)).lower()
        return [(w, [self._word_id(w)]) for w in _WORD_PAT.findall(text)]

    def encode(self, text: str) -> List[int]:
        return [i for _, ids in self.encode_words(text) for i in ids]

    def token_strings(self, text: str) -> List[str]:
        return [w for w, ids in self.encode_words(text) for _ in ids]

    def __call__(self, texts, max_length: Optional[int] = None,
                 pad_token_id: Optional[int] = None) -> np.ndarray:
        """``pad_token_id`` overrides the fill after [bos, ids..., eos] —
        CLIP-L pads with eos, OpenCLIP bigG (SDXL tower 2) with 0."""
        if isinstance(texts, str):
            texts = [texts]
        L = max_length or self.max_length
        pad = self.eos_token_id if pad_token_id is None else pad_token_id
        out = np.full((len(texts), L), pad, np.int32)
        out[:, 0] = self.bos_token_id
        for r, t in enumerate(texts):
            ids = self.encode(t)[: L - 2]
            out[r, 1 : 1 + len(ids)] = ids
            out[r, 1 + len(ids)] = self.eos_token_id
        return out


class CLIPBPETokenizer(HashTokenizer):
    """Byte-level BPE with CLIP's ``</w>`` end-of-word convention.

    ``merges_path`` may point at a plain or gzipped merges file (first line
    header skipped if it starts with ``#``).
    """

    def __init__(
        self,
        merges_path: str,
        vocab_path: Optional[str] = None,
        max_length: int = MAX_LEN,
    ):
        super().__init__(VOCAB_SIZE, max_length)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        if lines and (lines[0].startswith("#") or "version" in lines[0]):
            lines = lines[1:]
        merges = [tuple(l.split()) for l in lines if len(l.split()) == 2]
        merges = merges[: VOCAB_SIZE - 256 - 256 - 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        if vocab_path and os.path.exists(vocab_path):
            with open(vocab_path, encoding="utf-8") as f:
                self.encoder = json.load(f)
        else:
            vocab = list(self.byte_encoder.values())
            vocab += [v + "</w>" for v in vocab]
            vocab += ["".join(m) for m in merges]
            vocab += ["<|startoftext|>", "<|endoftext|>"]
            self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self._bpe_cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = list(word)
        self._bpe_cache[token] = out
        return out

    def encode_words(self, text: str) -> List[tuple]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        out = []
        for w in _WORD_PAT.findall(text):
            translated = "".join(self.byte_encoder[b] for b in w.encode("utf-8"))
            pieces = self._bpe(translated)
            out.append((w, [self.encoder.get(p, 0) for p in pieces]))
        return out

    def token_strings(self, text: str) -> List[str]:
        strs = []
        for w, ids in self.encode_words(text):
            translated = "".join(self.byte_encoder[b] for b in w.encode("utf-8"))
            strs.extend(self._bpe(translated))
        return strs


def load_tokenizer(assets_dir: Optional[str] = None,
                   vocab_size: int = VOCAB_SIZE):
    """Best tokenizer available: real BPE if merges exist, else hash."""
    if assets_dir:
        for name in ("merges.txt", "merges.txt.gz", "bpe_simple_vocab_16e6.txt.gz"):
            p = os.path.join(assets_dir, name)
            if os.path.exists(p):
                vocab = os.path.join(assets_dir, "vocab.json")
                return CLIPBPETokenizer(p, vocab if os.path.exists(vocab) else None)
    return HashTokenizer(vocab_size)


def find_phrase_token_indices(tokenizer, prompt: str, phrase: str,
                              max_length: int = MAX_LEN) -> List[int]:
    """Positions (in the padded BOS+ids+EOS sequence) of ``phrase``'s tokens
    inside ``prompt``: word-level alignment on the word sequences, then
    expansion to token positions (reference ``utils/guidance.py:32-89``).
    Returns [] when the phrase is not present (the caller then suffixes
    the prompt, reference ``:33-36``)."""
    pw = tokenizer.encode_words(prompt)
    fw = tokenizer.encode_words(phrase)
    if not fw:
        return []
    words = [w for w, _ in pw]
    target = [w for w, _ in fw]
    # token start offset per word: BOS at 0, first word token at 1
    offsets, off = [], 1
    for _, ids in pw:
        offsets.append(off)
        off += len(ids)
    hits: List[int] = []
    for i in range(len(words) - len(target) + 1):
        if words[i:i + len(target)] == target:
            for j in range(len(target)):
                start = offsets[i + j]
                hits.extend(range(start, start + len(pw[i + j][1])))
    return sorted({h for h in hits if h < max_length - 1})
