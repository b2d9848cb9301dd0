"""Query cache for the LLM layout stage: the port's own copy of
``theatergen_tpu/utils/cache.py`` (host JSON; nothing here runs on a
device).

Equivalent of the reference's ``utils/cache.py`` (SURVEY.md §2.9): a JSON
cache keyed by query string with per-key access counters — the stage-one
layout LLM asks for box layouts per caption, and the cache makes benchmark
re-runs free (reference ``utils/cache.py:25-71``, consumed by
``scripts/eval_stage_one.py``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Optional


class QueryCache:
    def __init__(self, path: str, autosave: bool = True):
        self.path = path
        self.autosave = autosave
        self._lock = threading.Lock()
        self.values: dict = {}
        self.counters: dict = {}
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            self.values = data.get("values", {})
            self.counters = data.get("counters", {})

    def get(self, key: str) -> Optional[Any]:
        with self._lock:
            if key in self.values:
                self.counters[key] = self.counters.get(key, 0) + 1
                return self.values[key]
        return None

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self.values[key] = value
            self.counters.setdefault(key, 0)
        if self.autosave:
            self.save()

    def get_or_compute(self, key: str, fn: Callable[[], Any]) -> Any:
        hit = self.get(key)
        if hit is not None:
            return hit
        value = fn()
        self.put(key, value)
        return value

    def save(self) -> None:
        with self._lock:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"values": self.values, "counters": self.counters},
                          f)
            os.replace(tmp, self.path)
