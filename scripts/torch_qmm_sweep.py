"""Time every launch of the ``quant_matmul`` kernel at the W8A8 UNets'
shapes, beside the one ``ops/quant_matmul.qmm_plan`` picks (on a CUDA
card).

    python3 scripts/torch_qmm_sweep.py [--out FILE]

For each (M, K, N) of ``chip_smoke.QMM_SHAPES`` of the SD1.5 and SDXL W8A8
UNets (models ``sd15_512_w8a8`` and ``sdxl_1024_w8a8``, CFG batch 2): every
cluster size C of ``QMM_CLUSTERS`` that divides the column tiles and every
split count that divides the K steps, forced through ``launch_plan``;
device ms of one call by CUDA-graph replay (``chip_smoke.graph_ms``), each
output checked bit for bit against ``quant_matmul_plain``.  Prints a line
per shape (the planner's plan and time, the fastest plan and time, their
ratio, and per evaluation the calls times each) and writes one JSON object
per shape to FILE (default ``build/qmm_sweep.jsonl``): the shape,
its calls per evaluation, the CTA slots of each C, every plan's ms, and the
planner's plan: the tables to fit the planner's constants to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from theatergen_tpu_torch import _build  # noqa: E402
from theatergen_tpu_torch.ops import quant as qz  # noqa: E402
from theatergen_tpu_torch.ops import quant_matmul as qm  # noqa: E402

MODELS = (cs.W8A8, cs.W8A8_XL)


def sweep_shape(gen, m: int, k: int, n: int) -> dict:
    dev = torch.device("cuda")
    x = cs.randn(gen, m, k)
    wq, ws = qz.quantize_linear_weight(
        torch.randn(n, k, device=dev, generator=gen) * k ** -0.5)
    bias = cs.randn(gen, n, scale=0.1)
    ref = qm.quant_matmul_plain(x, wq, ws, bias)
    _, nt, steps = qm.qmm_tiles(m, n, k)
    planned = qm.launch_plan(dev, m, n, k)
    times, slots = {}, {}
    real = qm.launch_plan
    try:
        for c in qm.QMM_CLUSTERS:
            if nt % c:
                continue
            slots[c] = qm.qmm_slots(dev, c)
            for s in range(1, steps + 1):
                if steps % s:
                    continue
                plan = (c, qm.QMM_BM, qm.QMM_BN, s)
                qm.launch_plan = lambda *a, p=plan: p
                out = qm.quant_matmul(x, wq, ws, bias)
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise SystemExit(f"M={m} K={k} N={n} plan {plan}: "
                                     f"differs from the plain version")
                times[f"{c},{s}"] = cs.graph_ms(
                    lambda: qm.quant_matmul(x, wq, ws, bias))
    finally:
        qm.launch_plan = real
    return dict(shape=[m, k, n], slots=slots, ms=times,
                plan=[planned[0], planned[3]])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/qmm_sweep.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qmm_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), flush=True)
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    per_eval = {model: [0.0, 0.0] for model in MODELS}
    with open(args.out, "w") as f:
        for model, (m, k, n), calls in cs.QMM_SHAPES:
            if model not in MODELS:
                continue
            row = dict(model=model, calls=calls, **sweep_shape(gen, m, k, n))
            f.write(json.dumps(row) + "\n")
            planned = row["ms"][f"{row['plan'][0]},{row['plan'][1]}"]
            best = min(row["ms"], key=row["ms"].get)
            per_eval[model][0] += calls * planned
            per_eval[model][1] += calls * row["ms"][best]
            print(f"{model} M={m} K={k} N={n} x{calls}: planned (C, splits) "
                  f"{tuple(row['plan'])} {planned:.5f} ms, best ({best}) "
                  f"{row['ms'][best]:.5f} ms, ratio "
                  f"{planned / row['ms'][best]:.3f}", flush=True)
    for model, (planned, best) in per_eval.items():
        print(f"{model}: one evaluation's calls {planned:.4f} ms as planned, "
              f"{best:.4f} ms at each shape's best plan", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
