"""One run of one cell: set-up, the measured window, the check, the line.

``run_cell`` builds or loads the port's kernels, makes the weights from
the seed, builds the port's bundle and turn server, warms every shape of
the mix up (one round of the same sessions at ``warmup_steps``), then
measures: rounds of turns from the first submit until the first whole
repeat of the mix that ends at or after ``seconds``.  With ``trace`` the first repeat runs under the
profiler and the per-layer metrics are reported, else the end-to-end
ones; every metric is its reader's in ``benchmark/metrics/``.  Once the
window has closed and the program's state is freed, the plain reference
replays the compared turns (``harness/check.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import shutil
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import bench, check
from .system import Load, load_bundle, meta_bundle, session_root
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "theatergen_tpu")


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    turns: List[dict]             # the window's turn records
    window_s: float               # first submit to the last turn's result
    setup_s: float
    phases: Dict[str, List[float]]
    peak_bytes: int               # the window's allocator peak
    trace: Optional[dict]         # tracing.summarize of the profiled repeat


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def build_kernels() -> None:
    """Build the port's CUDA kernels that the checkout has not built yet
    (``nvcc``, into ``build/torch_kernels/``) and load them, before any
    other set-up, and log on a line of its own what that took and
    whether ``nvcc`` ran.  It stays inside ``setup_s``: a run that
    compiles pays its compilation there."""
    from theatergen_tpu_torch import _build

    t0 = time.perf_counter()
    names = _build.kernel_names()
    for name in names:
        _build.library(name)
    built = sorted(_build.build_log)
    log(f"build: {len(names)} kernels in {time.perf_counter() - t0:.2f} s; "
        f"nvcc ran for {built if built else 'none (all found built)'}")


def _reference_skeletons(rcfg, names) -> Dict[str, torch.nn.Module]:
    from reference.turn import build_skeleton, module_specs

    specs = module_specs(rcfg)
    out = {}
    for kind, name in (("unet_ip", "unet_ip"), ("unet", "unet"),
                       ("controlnet", "controlnet"),
                       ("t2i_adapter", "t2i_adapter")):
        if name in names:
            out[kind] = build_skeleton(specs[name])
    out["vae_decoder"] = build_skeleton(specs["vae"]).decoder
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: Path = bench.ROOT,
             t_start: Optional[float] = None) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    from reference.turn import RefModels, Turn, module_specs
    from .weights import make_states

    marks = [("start", t_start), ("imports", time.perf_counter())]
    cell = bench.load_cell(workload, root)
    pcfg, rcfg = bench.program_config(cell), bench.reference_config(cell)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        build_kernels()
        marks.append(("kernel build", time.perf_counter()))
    meta, dtypes = meta_bundle(pcfg, cell.config["bundle"])
    specs = module_specs(rcfg)
    states = make_states(specs, dtypes, dtypes.keys(), seed, device)
    bundle = load_bundle(meta, states)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("weights and bundle", time.perf_counter()))
    traffic = Traffic(cell.traffic, seed)

    warm_root = session_root("warm")
    try:
        warm = Load(bundle, traffic, warm_root,
                    num_steps=int(cell.traffic["warmup_steps"]), prefix="w")
        warm.round()
        warm.close()
    finally:
        shutil.rmtree(warm_root, ignore_errors=True)
    del warm
    marks.append(("warm-up round", time.perf_counter()))

    root_dir = session_root("run")
    keep = traffic.check_sessions(int(cell.traffic["check_turns"]))
    recorder = profile = None
    try:
        load = Load(bundle, traffic, root_dir)
        if trace:
            from .tracing import Profile, Recorder

            recorder = Recorder(bundle)
            profile = Profile(str(root / "build" / "bench_trace"))
        base = [{k: len(v) for k, v in t.samples.items()}
                for t in load.timers()]
        if cuda:
            torch.cuda.synchronize()
            setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        turns, rounds, t0 = [], 0, None
        prof_span = None
        while True:
            first = rounds == 0
            if trace and first:
                profile.start()
                recorder.on = True
                p0 = time.time_ns()
            recs = load.round(keep=keep if first else ())
            t0 = recs[0]["submit"] if t0 is None else t0
            turns.extend(recs)
            rounds += 1
            if trace and rounds == traffic.rounds_per_repeat:
                recorder.on = False
                prof_span = (p0, time.time_ns(), profile.stop())
            if rounds % traffic.rounds_per_repeat == 0:
                t_end = max(r.get("done", r["submit"]) for r in recs)
                if t_end - t0 >= seconds:
                    break
        window_peak = torch.cuda.max_memory_allocated() if cuda else 0
        phases: Dict[str, List[float]] = {}
        for t, b0 in zip(load.timers(), base):
            for name, xs in t.samples.items():
                phases.setdefault(name, []).extend(xs[b0.get(name, 0):])
        stats = load.server.stats()
        db_images = load.db_images
        load.close()
    finally:
        shutil.rmtree(root_dir, ignore_errors=True)

    setup_s = turns[0]["submit"] - t_start
    marks.append(("sessions and DB entries", turns[0]["submit"]))
    log("set-up: " + ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                               in zip(marks, marks[1:])))
    summary = None
    if trace:
        from .tracing import FlopCounter, summarize

        p0, p1, parsed = prof_span
        flops = FlopCounter(_reference_skeletons(rcfg, set(dtypes)))
        summary = summarize(parsed, recorder, p0, p1, flops)
        recorder.remove()
    run = Run(turns=turns, window_s=t_end - t0, setup_s=setup_s,
              phases=phases, peak_bytes=window_peak, trace=summary)
    metrics_list = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in metrics_list:
        value = bench.metric_reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])

    failed = sum(1 for r in turns if not r.get("ok"))
    errors = [r["error"] for r in turns if "error" in r]
    if errors:
        log(f"{len(errors)} turns failed; the first:\n{errors[0][-3000:]}")
    kept = [r for r in turns if "result" in r]
    denoise = len(phases.get("char.denoise_decode", []))
    log(f"window: {len(turns)} turns in {rounds} rounds, {run.window_s:.4f} "
        f"s; server {stats}")
    log(f"turn latency samples: {len(turns)}")
    log(f"character passes (char.denoise_decode phases) per turn: "
        f"{denoise / max(len(turns), 1):.4f}")

    # the program's state goes before the reference runs
    del load, bundle, meta, recorder, profile
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = Turn(RefModels.build(rcfg, states, device))
    numbers = check.compare(ref, kept, db_images)
    log(f"reference: {len(kept)} turns in {time.perf_counter() - t_ref:.1f} s")
    log(f"reference attempts per compared turn: "
        f"{[r['ref_attempts'] for r in kept]}; served detections "
        f"{[r['result'].detections for r in kept]}")
    del ref, states
    gc.collect()

    limits = cell.limits or {}
    verdicts = {n: (n in limits and math.isfinite(numbers[n])
                    and numbers[n] <= limits[n]) for n in check.NUMBERS}
    correct = (all(verdicts.values()) and failed == 0
               and len(kept) == len(keep))
    checked = {n: dict(value=numbers[n], limit=limits.get(n))
               for n in check.NUMBERS}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(0) if cuda else "cpu",
               count=1 if cuda else 0,
               memory_peak_bytes=int(max(setup_peak, window_peak))
               if cuda else 0)
    result = dict(correct=bool(correct), attempted=len(turns), failed=failed,
                  metrics=metrics, device=dev)
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = dict(device_ops=summary["device_ops"],
                                   idle_gaps=summary["idle_gaps"])
    result["check"] = checked
    for n in check.NUMBERS:
        log(f"check {n}: {numbers[n]!r} limit {limits.get(n)!r} "
            f"{'ok' if verdicts[n] else 'FAIL'}")
    return result
