"""ctypes bindings for the native embedding store (``native/theaterstore.cpp``).

The port of ``theatergen_tpu/runtime/store.py``.  The source is read where
it lies; the shared library is built on first use with ``g++`` into
``<checkout>/build/theaterstore/``, its file name carrying a hash of the
source and the flags, so an edited source rebuilds and a stale library is
never loaded.  Without a compiler :func:`available` is False and callers
keep their embeddings elsewhere (``db.CharacterDB`` falls back to ``.npy``
files).  The store is host storage: the card never sees it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SRC = _ROOT / "native" / "theaterstore.cpp"
BUILD_DIR = _ROOT / "build" / "theaterstore"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libtheaterstore-{h.hexdigest()[:12]}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        lib.ts_open.restype = ctypes.c_void_p
        lib.ts_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.ts_dim.restype = ctypes.c_uint32
        lib.ts_dim.argtypes = [ctypes.c_void_p]
        lib.ts_count.restype = ctypes.c_uint64
        lib.ts_count.argtypes = [ctypes.c_void_p]
        lib.ts_keys.restype = ctypes.c_uint64
        lib.ts_keys.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int64)]
        fvec = ctypes.POINTER(ctypes.c_float)
        for name in ("ts_put", "ts_get"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, fvec]
        for name in ("ts_has", "ts_delete"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ts_close.restype = None
        lib.ts_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


class EmbeddingStore:
    """Keyed float32-vector store in one file.  ``dim`` 0 opens an existing
    file at its own dimension."""

    def __init__(self, path: str, dim: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native theaterstore unavailable (no g++?)")
        self._lib = lib
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._h = lib.ts_open(path.encode(), dim)
        if not self._h:
            raise IOError(f"cannot open embedding store {path!r}")
        self.dim = int(lib.ts_dim(self._h))

    def _check_open(self) -> None:
        if not self._h:
            raise ValueError("EmbeddingStore is closed")

    def put(self, key: int, vec: np.ndarray) -> None:
        self._check_open()
        v = np.ascontiguousarray(vec, np.float32)
        if v.shape != (self.dim,):
            raise ValueError(f"EmbeddingStore.put: shape {v.shape}, want "
                             f"({self.dim},)")
        ok = self._lib.ts_put(
            self._h, int(key), v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if not ok:
            raise IOError("ts_put failed")

    def get(self, key: int) -> Optional[np.ndarray]:
        self._check_open()
        out = np.empty(self.dim, np.float32)
        ok = self._lib.ts_get(
            self._h, int(key),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out if ok else None

    def __contains__(self, key: int) -> bool:
        self._check_open()
        return bool(self._lib.ts_has(self._h, int(key)))

    def delete(self, key: int) -> bool:
        self._check_open()
        return bool(self._lib.ts_delete(self._h, int(key)))

    def keys(self) -> List[int]:
        """The live keys, ascending."""
        self._check_open()
        n = int(self._lib.ts_count(self._h))
        buf = np.empty(max(n, 1), np.int64)
        got = self._lib.ts_keys(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return sorted(int(k) for k in buf[:int(got)])

    def __len__(self) -> int:
        self._check_open()
        return int(self._lib.ts_count(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.ts_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
