"""Character database: the identity memory across turns.

The port of ``theatergen_tpu/db.py``, with the same layout on disk, so a
directory written by either package reads in the other: one PNG per
character id (``<root>/<obj_id>.png``, written after a new character's
first generation, reference ``models/pipelines.py:476-477``, read back as
the IP-Adapter reference on later turns, ``:183-199``) and its CLIP image
features, in the native single-file store ``<root>/embeddings.bin``
(``runtime.store``, keyed by :func:`_store_key`) or, where the store
cannot load, a ``<root>/<obj_id>.npy`` beside the PNG.  PNGs go through
the port's own codec (``utils.png``).  Everything here is host storage.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np

from .utils import png


def _store_key(obj_id) -> int:
    if isinstance(obj_id, (int, np.integer)):
        return int(obj_id)
    return int(hashlib.md5(str(obj_id).encode()).hexdigest()[:15], 16)


class CharacterDB:
    def __init__(self, root: str, use_native: bool = True):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._native = None
        self._use_native = use_native

    @property
    def store_kind(self) -> str:
        """Where embeddings go: "native" (embeddings.bin) or "npy"."""
        from .runtime import store

        return "native" if self._use_native and store.available() else "npy"

    def _store(self, dim: int = 0):
        """The native store, opened at the first embedding's dimension (0:
        an existing file's own), or None without it."""
        if not self._use_native:
            return None
        if self._native is None:
            from .runtime import store

            path = os.path.join(self.root, "embeddings.bin")
            if not store.available() or (dim == 0
                                         and not os.path.exists(path)):
                return None
            try:
                self._native = store.EmbeddingStore(path, dim)
            except (IOError, RuntimeError):
                self._use_native = False
        return self._native

    def _png(self, obj_id) -> str:
        return os.path.join(self.root, f"{obj_id}.png")

    def _emb(self, obj_id) -> str:
        return os.path.join(self.root, f"{obj_id}.npy")

    def has(self, obj_id) -> bool:
        return os.path.exists(self._png(obj_id))

    def load_image(self, obj_id) -> Optional[np.ndarray]:
        """[H, W, 3] float32 in [0, 1], or None."""
        if not self.has(obj_id):
            return None
        return png.read_png(self._png(obj_id)).astype(np.float32) / 255.0

    def load_embedding(self, obj_id) -> Optional[np.ndarray]:
        p = self._emb(obj_id)
        if os.path.exists(p):
            arr = np.load(p)
            store = self._store(arr.shape[-1])
            if store is not None and _store_key(obj_id) not in store:
                store.put(_store_key(obj_id), arr.reshape(-1))
            return arr
        store = self._store()
        return None if store is None else store.get(_store_key(obj_id))

    def save(self, obj_id, image: np.ndarray,
             embedding: Optional[np.ndarray] = None) -> None:
        """image [H, W, 3] in [0, 1]."""
        png.write_png(self._png(obj_id), png.to_uint8(image))
        if embedding is not None:
            emb = np.asarray(embedding, np.float32).reshape(-1)
            store = self._store(emb.shape[0])
            if store is not None:
                store.put(_store_key(obj_id), emb)
            else:
                np.save(self._emb(obj_id), emb)

    def delete(self, obj_id) -> None:
        """Remove a character before a regeneration retry (reference
        ``theatergen.py:158-159``)."""
        for p in (self._png(obj_id), self._emb(obj_id)):
            if os.path.exists(p):
                os.remove(p)
        store = self._store()
        if store is not None:
            store.delete(_store_key(obj_id))

    def lookup(self, obj_id) -> Tuple[Optional[np.ndarray],
                                      Optional[np.ndarray], bool]:
        """(image, embedding, hit)."""
        img = self.load_image(obj_id)
        return img, self.load_embedding(obj_id), img is not None
