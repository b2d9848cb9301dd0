"""Spans, kernel calls and the device trace of one profiled repeat.

Installed only in a ``--trace 1`` run, from the benchmark's own files:

- a span around every call of the bundle's UNets, ControlNet,
  T2I-Adapter and VAE decoder (module hooks): its host start and end on
  the wall clock and the shapes of its inputs;
- the arguments' shapes of every call of the program's four hand-written
  kernels, recorded by a wrapper of each ``ops`` entry point;
- the wall-clock extents of the Theaters' PhaseTimer phases, which name
  the device's idle gaps;
- ``torch.profiler`` (host and CUDA activities) over the repeat, its
  Chrome trace read back here: every device operation, and each kernel's
  launch by its correlation id, which places it in the span that launched
  it.  The host clock is tied to the trace's by an annotation on the
  driving thread.

A span's operations are counted by replaying its call on the plain
reference's module on the meta device under
``torch.utils.flop_counter.FlopCounterMode``.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import inspect
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from .roofline import KERNELS

SPAN_MODULES = (("unet_ip", "unet_ip"), ("unet", "unet"),
                ("controlnet", "controlnet"), ("t2i_adapter", "t2i_adapter"),
                ("vae_decoder", "vae.decoder"))


class _Shape:
    """A tensor argument of a recorded call: its shape."""

    __slots__ = ("shape",)

    def __init__(self, shape):
        self.shape = tuple(shape)

    def __repr__(self):
        return f"T{self.shape}"


def _abstract(x):
    if torch.is_tensor(x):
        return _Shape(x.shape)
    if isinstance(x, (list, tuple)):
        return type(x)(_abstract(v) for v in x)
    if isinstance(x, dict):
        return {k: _abstract(v) for k, v in x.items()}
    return x


def _concrete(x, device="meta"):
    if isinstance(x, _Shape):
        return torch.zeros(x.shape, device=device)
    if isinstance(x, (list, tuple)):
        return type(x)(_concrete(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _concrete(v, device) for k, v in x.items()}
    return x


def _module(bundle, path: str):
    obj = bundle
    for part in path.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


class Recorder:
    """Hooks on the bundle and wrappers of the kernels' entry points; they
    record while ``on`` is set."""

    def __init__(self, bundle):
        self.on = False
        self.spans: List[dict] = []
        self.calls: Dict[str, list] = defaultdict(list)
        self._open = threading.local()
        self._handles, self._patched = [], []
        for kind, path in SPAN_MODULES:
            m = _module(bundle, path)
            if m is None:
                continue
            self._handles.append(m.register_forward_pre_hook(
                self._pre(kind), with_kwargs=True))
            self._handles.append(m.register_forward_hook(
                self._post(), with_kwargs=True))
        for name, k in KERNELS.items():
            mod = importlib.import_module(f"theatergen_tpu_torch.{k.module}")
            orig = getattr(mod, k.function)
            setattr(mod, k.function, self._wrap(name, orig))
            self._patched.append((mod, k.function, orig))
        # the Theaters' PhaseTimer phases, with their wall-clock extents
        from theatergen_tpu_torch.utils import profiling

        self.phases: List[tuple] = []
        orig_phase = profiling.PhaseTimer.phase
        rec = self

        @contextlib.contextmanager
        def phase(timer, name, sync=False):
            t0 = time.time_ns()
            try:
                with orig_phase(timer, name, sync):
                    yield
            finally:
                if rec.on:
                    rec.phases.append((name, t0, time.time_ns()))

        profiling.PhaseTimer.phase = phase
        self._patched.append((profiling.PhaseTimer, "phase", orig_phase))

    def _pre(self, kind):
        def hook(_m, args, kwargs):
            if self.on:
                self._open.span = dict(kind=kind, call=_abstract(
                    (args, kwargs)), t0=time.time_ns())
        return hook

    def _post(self):
        def hook(_m, _args, _kwargs, _out):
            span = getattr(self._open, "span", None)
            if self.on and span is not None:
                span["t1"] = time.time_ns()
                self.spans.append(span)
                self._open.span = None
        return hook

    def _wrap(self, name, orig):
        def wrapper(*args, **kwargs):
            if self.on:
                self.calls[name].append(
                    [tuple(a.shape) for a in args if torch.is_tensor(a)])
            return orig(*args, **kwargs)
        return wrapper

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        for mod, fn, orig in self._patched:
            setattr(mod, fn, orig)


class Profile:
    """``torch.profiler`` over one repeat; ``stop`` returns the parsed
    trace."""

    def __init__(self, out_dir: str):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.out_dir = out_dir
        self.prof = profile(activities=acts)

    def start(self) -> None:
        self.prof.start()
        with torch.profiler.record_function("bench.clock"):
            self.clock_ns = time.time_ns()

    def stop(self) -> dict:
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return parse(events, self.clock_ns)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def parse(events: list, clock_ns: int) -> dict:
    """Device operations, launches by correlation id and the offset of the
    wall clock (µs) from the trace's clock.  The launches are the CUDA
    runtime's and driver's calls, which the trace holds for every thread
    (its host operators only for the thread that started it)."""
    device, launches = [], {}
    offset_us = None
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat in DEVICE_CATS:
            device.append((float(e["ts"]), float(e.get("dur", 0.0)),
                           e.get("name", ""), cat,
                           e.get("args", {}).get("correlation")))
        elif cat == "cuda_runtime" or cat == "cuda_driver":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
        elif e.get("name") == "bench.clock" and offset_us is None:
            offset_us = clock_ns / 1e3 - float(e["ts"])
    device.sort()
    return dict(device=device, launches=launches, offset_us=offset_us)


def busy_us(device: list, t0: float, t1: float) -> float:
    """The time within [t0, t1] in which some device operation ran."""
    busy, end = 0.0, t0
    for ts, dur, *_ in device:
        a, b = max(ts, end), min(ts + dur, t1)
        if b > a:
            busy += b - a
        end = max(end, min(ts + dur, t1))
    return busy


def summarize(trace: dict, rec: Recorder, t0_ns: int, t1_ns: int,
              flops_of) -> dict:
    """The repeat's per-layer readings from its trace and records."""
    off = trace["offset_us"]
    if off is None:
        raise RuntimeError("the trace holds no clock annotation")
    w0, w1 = t0_ns / 1e3 - off, t1_ns / 1e3 - off
    device = [d for d in trace["device"] if d[0] + d[1] > w0 and d[0] < w1]
    busy = busy_us(device, w0, w1)
    spans = sorted(rec.spans, key=lambda s: s["t0"])
    starts = [s["t0"] / 1e3 - off for s in spans]
    span_dev = [0.0] * len(spans)
    kernel_dev: Dict[str, float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    for ts, dur, name, cat, corr in device:
        by_name[name] += dur
        for kname, k in KERNELS.items():
            if cat == "kernel" and k.pattern.search(name):
                kernel_dev[kname] += dur
        launch = trace["launches"].get(corr)
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= spans[i]["t1"] / 1e3 - off:
            span_dev[i] += dur
    out_spans = [dict(kind=s["kind"], host_s=(s["t1"] - s["t0"]) / 1e9,
                      device_s=d / 1e6, flops=flops_of(s))
                 for s, d in zip(spans, span_dev)]
    kernel_bound: Dict[str, float] = {}
    kernel_calls: Dict[str, int] = {}
    from .roofline import bound_s
    for kname, calls in rec.calls.items():
        kernel_calls[kname] = len(calls)
        kernel_bound[kname] = sum(bound_s(*KERNELS[kname].cost(c))
                                  for c in calls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        window_s=(w1 - w0) / 1e6, busy_s=busy / 1e6, spans=out_spans,
        kernel_device_s={k: v / 1e6 for k, v in kernel_dev.items()},
        kernel_bound_s=kernel_bound, kernel_calls=kernel_calls,
        device_ops=[[n[:120], v / 1e6] for n, v in top],
        idle_gaps=_gaps(device, w0, w1, rec.phases, spans, off))


def _gaps(device, w0, w1, phases, spans, off, count: int = 10) -> list:
    """The longest stretches with no device operation, each named by what
    the host was doing when it began: the innermost Theater phase over
    that moment and the last evaluation span before it."""
    gaps, end = [], w0
    for ts, dur, *_ in device:
        if ts > end:
            gaps.append((ts - end, end))
        end = max(end, ts + dur)
    if w1 > end:
        gaps.append((w1 - end, end))
    gaps.sort(reverse=True)
    out = []
    for length, start in gaps[:count]:
        mid = start + min(length / 2, 50.0)
        inner = [p for p in phases
                 if p[1] / 1e3 - off <= mid <= p[2] / 1e3 - off]
        before = [s["kind"] for s in spans if s["t1"] / 1e3 - off <= mid]
        name = ("in " + min(inner, key=lambda p: p[2] - p[1])[0]
                if inner else "outside the phases")
        name += ", after " + (before[-1] if before else "no evaluation")
        out.append([name, length / 1e6])
    return out


class FlopCounter:
    """Operations of a recorded span: its call replayed on the plain
    reference's module of the same kind, on the meta device."""

    def __init__(self, ref_modules: Dict[str, torch.nn.Module]):
        self.modules = ref_modules
        self.cache: Dict[str, float] = {}

    def __call__(self, span: dict) -> Optional[float]:
        m = self.modules.get(span["kind"])
        if m is None:
            return None
        key = span["kind"] + repr(span["call"])
        if key not in self.cache:
            from torch.utils.flop_counter import FlopCounterMode

            args, kwargs = _concrete(span["call"])
            params = inspect.signature(m.forward).parameters
            kwargs = {k: v for k, v in kwargs.items() if k in params}
            with FlopCounterMode(display=False) as fc, torch.no_grad():
                m(*args, **kwargs)
            self.cache[key] = float(fc.get_total_flops())
        return self.cache[key]
