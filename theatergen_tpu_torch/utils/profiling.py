"""Per-phase wall-clock timing, span records and counts of the program.

The port of ``theatergen_tpu/utils/profiling.py::PhaseTimer``: calls and
seconds per named phase (per-character denoise, detection, masks,
composition, the final pass) with p50/p90 summaries.  PyTorch returns
before the device finishes, so a phase that holds device work is opened
with ``sync=True`` and ends in ``torch.cuda.synchronize()`` when the timer's
device is a card: the phase then measures the device chain, not just the
launches (the JAX package's ``theater._sync_fetch``).

Beyond the JAX timer, the port's one record of where its time goes:

- every phase is also a :class:`Span`: its start and end on
  ``time.time_ns()`` (the wall clock, which a ``torch.profiler`` trace can
  be tied to), the innermost phase open on the same thread as its parent
  (across timers: the server's ``serve.wave`` parents the Theaters'
  phases), and the tag of the dispatch it ran in (:func:`dispatch_tag`,
  set by the turn server); the newest :data:`MAX_SPANS` are kept, and the
  server's ``GET /spans`` serves those of one dispatch;
- :meth:`PhaseTimer.add` takes a duration measured elsewhere (a request's
  queue wait) and :meth:`PhaseTimer.count` a count (character attempts,
  loop steps); both land in ``samples`` beside the phases;
- a phase opened on a thread that ``torch.profiler`` is tracing is also a
  ``record_function`` range, so it shows on that trace's own clock.  The
  profiler's state is thread-local: the turn server's worker thread is
  not traced, and its phases reach a trace through their span records.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

# spans a timer keeps: a long-lived server holds a fixed amount
MAX_SPANS = 65536
# the innermost open phase of each thread, and the dispatch tag
_local = threading.local()
_span_ids = itertools.count(1)


class Span(NamedTuple):
    """One phase (or added duration): wall-clock nanoseconds, its id, the
    id of the phase open around it on its thread (or None) and its
    dispatch tag (or None)."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    tag: Optional[int]


@contextlib.contextmanager
def dispatch_tag(tag: int) -> Iterator[None]:
    """Tag every span recorded on this thread inside the block with
    ``tag`` (the turn server's dispatch number)."""
    prev = getattr(_local, "tag", None)
    _local.tag = tag
    try:
        yield
    finally:
        _local.tag = prev


class PhaseTimer:
    """Accumulates wall-clock samples per named phase, counts, and span
    records."""

    def __init__(self, device=None) -> None:
        self.device = None if device is None else torch.device(device)
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.spans: Deque[Span] = deque(maxlen=MAX_SPANS)
        self._counters: set = set()

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False) -> Iterator[None]:
        sid, parent = next(_span_ids), getattr(_local, "open", None)
        _local.open = sid
        ranged = None
        if torch._C._autograd._profiler_enabled():
            ranged = torch.autograd.profiler.record_function(name)
            ranged.__enter__()
        t0_ns = time.time_ns()
        start = time.perf_counter()
        try:
            yield
        finally:
            try:
                if sync and self.device is not None \
                        and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.samples[name].append(time.perf_counter() - start)
                self.spans.append(Span(sid, name, t0_ns, time.time_ns(),
                                       parent, getattr(_local, "tag", None)))
            finally:
                # a failed synchronise still closes the phase on its thread
                _local.open = parent
                if ranged is not None:
                    ranged.__exit__(None, None, None)

    def add(self, name: str, seconds: float) -> None:
        """A duration measured elsewhere, ending now: a sample of ``name``
        and a span."""
        end = time.time_ns()
        self.samples[name].append(seconds)
        self.spans.append(Span(next(_span_ids), name,
                               end - int(seconds * 1e9), end,
                               getattr(_local, "open", None),
                               getattr(_local, "tag", None)))

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the count ``name`` (a sample of ``n``)."""
        self._counters.add(name)
        self.samples[name].append(n)

    def counts(self) -> Dict[str, int]:
        """Samples per name: a phase's calls, a count's increments."""
        return {name: len(xs) for name, xs in self.samples.items()}

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            if name in self._counters:
                out[name] = {"count": int(arr.size),
                             "total": float(arr.sum())}
                continue
            out[name] = {
                "count": int(arr.size),
                "total_s": float(arr.sum()),
                "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p90_s": float(np.percentile(arr, 90)),
            }
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """A ``torch.profiler`` trace of the enclosed block (host operators,
    and the card's kernels where CUDA is available), written as a Chrome
    trace ``trace.json`` into ``log_dir`` when the block ends."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
