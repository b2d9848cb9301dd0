"""Sweep the group_norm kernel's launch plans on one card: every cluster
size, CTA width and load route (shared memory or registers) at each
GroupNorm shape of chip_smoke.py
(and a few at other batch sizes), each plan checked against the plain
version and timed warm and cold, beside the plan ``gn_plan`` picks.

    python3 scripts/torch_gn_sweep.py [--out build/gn_sweep.json]

Warm: 20 calls on one input in a CUDA graph (the input stays in L2).
Cold: one call per input over a rotation of inputs past 100 MB
(``chip_smoke.cold_graph_ms``).  Both with SiLU.  Needs a CUDA device;
imports no JAX.  ``ops/groupnorm.py``'s planner constants are fitted to
its output.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from theatergen_tpu_torch import _build  # noqa: E402
from theatergen_tpu_torch.ops import groupnorm as gn  # noqa: E402

# shapes at batch sizes other than CFG's 2
OTHER_BATCH = [(b, c, hw) for b in (1, 4, 8)
               for c, hw in ((320, 4096), (1280, 256), (320, 16384),
                             (1280, 64))]


def plans(b: int, c: int, hw: int):
    """Every plan the kernel takes at this shape: cluster sizes whose
    shares leave no CTA empty, each CTA width, the share in shared memory
    (4 chunks) where it fits there and in registers where it fits
    there."""
    pieces = gn.gn_pieces(c, hw, 32)
    for cl in gn.GN_CLUSTERS:
        share = -(-pieces // cl)
        if (cl - 1) * share >= pieces:
            continue
        chunks = min(share, gn.GN_MAX_CHUNKS)
        smem = gn.gn_smem(share, c, hw, 32, chunks)
        for threads in gn.GN_THREADS:
            if smem <= gn.GN_SMEM_LIMIT:
                yield gn.GnPlan(cl, threads, share, chunks, smem)
            if share <= threads * gn.GN_REG_PIECES:
                yield gn.GnPlan(cl, threads, share, 0,
                                gn.gn_smem(share, c, hw, 32, 0))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/gn_sweep.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gn_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    _build.build(["group_norm"])
    for line in _build.build_log.get("group_norm", {}).get("ptxas", "").splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"  {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [s for _, s, _ in cs.GN_SHAPES] + OTHER_BATCH
    seen, results = set(), []
    planned = gn.launch_plan
    for b, c, hw in shapes:
        if (b, c, hw) in seen:
            continue
        seen.add((b, c, hw))
        side = int(hw ** 0.5)
        w = (1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)).to(
            torch.bfloat16)
        bias = cs.randn(gen, c, scale=0.1)
        x = cs.randn(gen, b, c, side, side)
        xl = cs.randn(gen, b, c, side, side,
                      scale=cs.GN_LARGE_STD) + cs.GN_LARGE_MEAN
        ref = gn.fused_group_norm_plain(xl.float(), w.float(), bias.float(),
                                        act="silu")
        xs = cs.cold_inputs(lambda: cs.randn(gen, b, c, side, side),
                            x.numel() * 2)
        pick = planned(b, c, hw, 32)
        lib = dict(ms=cs.graph_ms(
            lambda: F.silu(F.group_norm(x, 32, w, bias, 1e-5))),
            cold_ms=cs.cold_graph_ms(
                lambda xi: F.silu(F.group_norm(xi, 32, w, bias, 1e-5)), xs))
        rows = []
        for plan in plans(b, c, hw):
            gn.launch_plan = lambda *a, p=plan: p
            try:
                out = gn.fused_group_norm(xl, w, bias, act="silu")
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item()
                row = dict(plan=plan._asdict(), err=err,
                           ok=err <= cs.TOL * ref.abs().max().item())
                if row["ok"]:
                    row["ms"] = cs.graph_ms(
                        lambda: gn.fused_group_norm(x, w, bias, act="silu"))
                    row["cold_ms"] = cs.cold_graph_ms(
                        lambda xi: gn.fused_group_norm(xi, w, bias,
                                                       act="silu"), xs)
            except RuntimeError as e:
                row = dict(plan=plan._asdict(), error=str(e), ok=False)
            finally:
                gn.launch_plan = planned
            rows.append(row)
        good = [r for r in rows if r["ok"]]
        bound = gn.min_bytes(b, c, hw) / cs.PEAK_BYTES * 1e3
        best_w = min(good, key=lambda r: r["ms"]) if good else None
        best_c = min(good, key=lambda r: r["cold_ms"]) if good else None
        if best_c:
            # the same plan without the SiLU (its exp and reciprocal)
            gn.launch_plan = lambda *a, p=gn.GnPlan(**best_c["plan"]): p
            best_c["nosilu_cold_ms"] = cs.cold_graph_ms(
                lambda xi: gn.fused_group_norm(xi, w, bias), xs)
            gn.launch_plan = planned
        mine = [r for r in good if r["plan"] == pick._asdict()]
        entry = dict(shape=[b, c, hw], bound_ms=bound, library=lib,
                     planned=pick._asdict(), rows=rows)
        results.append(entry)
        bad = [r for r in rows if not r["ok"]]

        def brief(r):
            p = r["plan"]
            return (f"C{p['cluster']}/T{p['threads']}"
                    f"{'/reg' if not p['chunks'] else ''} "
                    f"{r['ms']:.5f}/{r['cold_ms']:.5f}")
        print(f"B{b} C{c} HW{hw}: bound {bound:.5f}  library "
              f"{lib['ms']:.5f}/{lib['cold_ms']:.5f}  planned "
              f"{brief(mine[0]) if mine else '-'}  best warm "
              f"{brief(best_w) if best_w else '-'}  best cold "
              f"{brief(best_c) if best_c else '-'} (no SiLU "
              f"{best_c.get('nosilu_cold_ms', 0) if best_c else 0:.5f})  "
              f"failed {len(bad)}", flush=True)
        for r in bad:
            print(f"  FAIL {r}", flush=True)
        del xs
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, results=results), f, indent=1)
    return 0 if all(r["ok"] for e in results for r in e["rows"]) else 1


if __name__ == "__main__":
    sys.exit(main())
