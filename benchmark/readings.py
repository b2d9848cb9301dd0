"""The readings a cell's limits are set from, on the card, in one process.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        [--program 1] [--control 1]

For each seed: the turns the check compares (the first round of the mix,
``Traffic.check_sessions``), the plain fp32 reference run on each, and

- with ``--program 1``, the served turns (the port's bundle and server,
  one round of the mix at the cell's own load, no warm-up, nothing
  timed) compared with it: the lower readings;
- with ``--control 1``, the control, the same reference computed with
  float8 linears and convolutions where the configuration states bf16,
  compared with it: the upper readings.

Prints one JSON line per seed and per side.  The benchmark's own runs do
not run this.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import time
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(workload, seed, program, control, device="cuda", root=ROOT):
    import torch

    from harness import bench, check
    from harness.system import Load, db_image, load_bundle, meta_bundle, \
        session_root
    from harness.traffic import Traffic
    from harness.weights import make_states
    from reference.turn import RefModels, Turn, module_specs

    cell = bench.load_cell(workload, root)
    pcfg, rcfg = bench.program_config(cell), bench.reference_config(cell)
    meta, dtypes = meta_bundle(pcfg, cell.config["bundle"])
    specs = module_specs(rcfg)
    states = make_states(specs, dtypes, dtypes.keys(), seed, device)
    traffic = Traffic(cell.traffic, seed)
    keep = traffic.check_sessions(int(cell.traffic["check_turns"]))
    size = rcfg.pipeline.height
    turns = []
    for k in keep:
        spec, tseed = traffic.turn(k, 0)
        db = {oid: db_image(s, size, device) for oid, s in traffic.prefill(k)}
        turns.append(dict(session=k, spec=spec, seed=tseed, db=db))
    out = {}
    if program:
        bundle = load_bundle(meta, states)
        droot = session_root("readings")
        try:
            load = Load(bundle, traffic, droot)
            served = {r["session"]: r for r in load.round(keep=keep)}
            bad = [r["error"] for r in served.values() if not r["ok"]]
            if bad:
                raise RuntimeError(f"a served turn failed:\n{bad[0]}")
            load.close()
        finally:
            shutil.rmtree(droot, ignore_errors=True)
        del load, bundle, meta
        gc.collect()
        torch.cuda.empty_cache()
    ref = Turn(RefModels.build(rcfg, states, device))
    refs = [ref.run(t["spec"], t["seed"], t["db"]) for t in turns]
    del ref
    gc.collect()
    if program:
        worst = {n: 0.0 for n in check.NUMBERS}
        for t, r in zip(turns, refs):
            for n, v in check.gaps(r, served[t["session"]]["result"]).items():
                worst[n] = max(worst[n], v)
        out["program"] = worst
    if control:
        ctl = Turn(RefModels.build(rcfg, states, device, precision="fp8"))
        worst = {n: 0.0 for n in check.NUMBERS}
        for t, r in zip(turns, refs):
            c = ctl.run(t["spec"], t["seed"], t["db"])
            got = types.SimpleNamespace(so_images=c["so_images"],
                                        image=c["image"])
            for n, v in check.gaps(r, got).items():
                worst[n] = max(worst[n], v)
        out["control"] = worst
        del ctl
    out["ref_attempts"] = [r["attempts"] for r in refs]
    del states
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args()
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(BENCH), str(ROOT)]
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(args.workload, int(s), args.program, args.control)
        print(json.dumps(dict(workload=args.workload, seed=int(s), **r,
                              seconds=time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
