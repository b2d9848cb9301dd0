"""Per-phase wall-clock timing of a turn.

The port of ``theatergen_tpu/utils/profiling.py::PhaseTimer``: calls and
seconds per named phase (per-character denoise, detection, masks,
composition, the final pass) with p50/p90 summaries.  PyTorch returns
before the device finishes, so a phase that holds device work is opened
with ``sync=True`` and ends in ``torch.cuda.synchronize()`` when the timer's
device is a card: the phase then measures the device chain, not just the
launches (the JAX package's ``theater._sync_fetch``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, List

import numpy as np
import torch


class PhaseTimer:
    """Accumulates wall-clock samples per named phase."""

    def __init__(self, device=None) -> None:
        self.device = None if device is None else torch.device(device)
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.device is not None \
                    and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.samples[name].append(time.perf_counter() - start)

    def counts(self) -> Dict[str, int]:
        return {name: len(xs) for name, xs in self.samples.items()}

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
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
