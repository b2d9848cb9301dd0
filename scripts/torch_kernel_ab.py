"""Time the flash, FF, geglu_matmul, quant_matmul and group_norm kernels
of two checkouts of the PyTorch port on one card, in turns (A, B, B, A),
and print a table of device ms and wrapper host µs per call at the main
paths' shapes.

    python3 scripts/torch_kernel_ab.py OLD_CHECKOUT NEW_CHECKOUT [--out F]

Each checkout runs in a process of its own (its package on ``sys.path``,
its kernels built into its own ``build/torch_kernels``).  Device ms: CUDA
events over 20 back-to-back calls after 3 warm-up calls (L2 warm);
quant_matmul and group_norm, whose calls are shorter than an eager
launch, by replaying 20 calls captured in a CUDA graph; group_norm also
cold (``cold_ms``: one call per input over a rotation of inputs past
100 MB, twice the L2, in one graph), and summed per UNet evaluation of
the three models that call it.  Host µs: 200 calls enqueued back to back,
timed before the synchronise.  Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

FF_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120),
             (128, 1280, 5120), (18432, 320, 1280), (4608, 640, 2560),
             (1152, 1280, 5120)]
# (B, Sq, Sk, H, D)
FLASH_SHAPES = [(2, 4096, 4096, 8, 40), (2, 1024, 1024, 8, 80),
                (2, 4096, 4096, 10, 64), (2, 1024, 1024, 20, 64),
                (2, 1024, 1024, 8, 160), (2, 9216, 9216, 8, 40),
                (2, 4608, 9216, 8, 40), (2, 2304, 9216, 8, 40)]
# geglu_matmul's (M, K, N): SDXL's two levels
GEGLU_SHAPES = [(8192, 2560, 640), (2048, 5120, 1280)]
# quant_matmul's (M, K, N): the 19 shapes of one W8A8 SD1.5 evaluation
QMM_SHAPES = [
    (8192, 320, 320), (154, 768, 320), (8192, 320, 2560), (8192, 1280, 320),
    (2048, 640, 640), (154, 768, 640), (2048, 640, 5120), (2048, 2560, 640),
    (512, 1280, 1280), (154, 768, 1280), (512, 1280, 10240),
    (512, 5120, 1280), (128, 1280, 1280), (128, 1280, 10240),
    (128, 5120, 1280), (2, 320, 1280), (2, 1280, 1280), (2, 1280, 640),
    (2, 1280, 320)]

# group_norm's (model, (B, C, H·W), calls per UNet evaluation): the 35
# GN_SHAPES of chip_smoke.py (the SD1.5 / IP UNet at 512 px, SDXL at
# 1024 px, the 768-px final pass: IP UNet and ControlNet), SiLU on
GN_SHAPES = [("sd15_512_ip", (2, c, hw), n) for (c, hw), n in (
    ((320, 4096), 13), ((640, 4096), 2), ((960, 4096), 1),
    ((320, 1024), 1), ((640, 1024), 11), ((960, 1024), 1), ((1280, 1024), 1),
    ((1920, 1024), 1), ((640, 256), 1), ((1280, 256), 11), ((1920, 256), 1),
    ((2560, 256), 2), ((1280, 64), 12), ((2560, 64), 3))] + [
    ("sdxl_1024", (2, c, hw), n) for (c, hw), n in (
        ((320, 16384), 8), ((320, 4096), 1), ((640, 4096), 11),
        ((960, 4096), 1), ((1280, 4096), 1), ((640, 1024), 1),
        ((1280, 1024), 16), ((1920, 1024), 1), ((2560, 1024), 2))] + [
    ("sd15_768_final", (2, c, hw), n) for (c, hw), n in (
        ((320, 9216), 19), ((320, 2304), 2), ((640, 2304), 16),
        ((960, 2304), 1), ((1280, 2304), 1), ((1920, 2304), 1),
        ((640, 576), 2), ((1280, 576), 16), ((1920, 576), 1),
        ((2560, 576), 2), ((1280, 144), 21), ((2560, 144), 3))]
COLD_BYTES = 100e6


def gn_name(b: int, c: int, hw: int) -> str:
    return f"gn B{b} C{c} HW{hw}"


def time_one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from theatergen_tpu_torch.ops import flash_attention as fa
    from theatergen_tpu_torch.ops import geglu_matmul as gg
    from theatergen_tpu_torch.ops import quant as qz
    from theatergen_tpu_torch.ops import quant_matmul as qm
    if not fa.__file__.startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {fa.__file__}, not the one under {root}")

    def dev_ms(fn, n=20):
        for _ in range(3):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    def graph_ms(fn, n=20):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        return dev_ms(graph.replay, 5) / n

    def cold_ms(fn, inputs):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(inputs[0])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for xi in inputs:
                fn(xi)
        return dev_ms(graph.replay, 3) / len(inputs)

    def host_us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=g)
                * scale).to(torch.bfloat16)

    out = {}
    for m, d, k in FF_SHAPES:
        x, w1 = rnd(m, d), rnd(2 * k, d, scale=d ** -0.5)
        b1, w2 = rnd(2 * k, scale=0.1), rnd(d, k, scale=k ** -0.5)

        def ff():
            return gg.ff_matmul(x, w1, b1, w2)
        out[f"ff M{m} D{d} K{k}"] = dict(ms=dev_ms(ff), host_us=host_us(ff))
    for b, sq, sk, h, d in FLASH_SHAPES:
        q, kk, vv = rnd(b, sq, h, d), rnd(b, sk, h, d), rnd(b, sk, h, d)

        def flash():
            return fa.flash_attention(q, kk, vv, route="copy")
        out[f"flash B{b} Sq{sq} Sk{sk} H{h} d{d}"] = dict(
            ms=dev_ms(flash), host_us=host_us(flash))
    for m, k, n in GEGLU_SHAPES:
        hg, w = rnd(m, 2 * k), rnd(n, k, scale=k ** -0.5)

        def geglu():
            return gg.geglu_matmul(hg, w)
        out[f"geglu M{m} K{k} N{n}"] = dict(ms=dev_ms(geglu),
                                            host_us=host_us(geglu))
    for m, k, n in QMM_SHAPES:
        x, bias = rnd(m, k), rnd(n, scale=0.1)
        wq, ws = qz.quantize_linear_weight(
            torch.randn(n, k, device="cuda", generator=g) * k ** -0.5)

        def qmm():
            return qm.quant_matmul(x, wq, ws, bias)
        out[f"qmm M{m} K{k} N{n}"] = dict(ms=graph_ms(qmm),
                                          host_us=host_us(qmm))
    from theatergen_tpu_torch.ops import groupnorm as gn
    for b, c, hw in dict.fromkeys(shape for _, shape, _ in GN_SHAPES):
        xs = [rnd(b, c, hw) for _ in range(
            max(4, -(-int(COLD_BYTES) // (2 * b * c * hw))))]
        w, bias = rnd(c, scale=0.2) + 1, rnd(c, scale=0.1)

        def norm(xi=xs[0]):
            return gn.fused_group_norm(xi, w, bias, act="silu")
        out[gn_name(b, c, hw)] = dict(ms=graph_ms(norm),
                                      cold_ms=cold_ms(norm, xs),
                                      host_us=host_us(norm))
        del xs
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out", default=None, help="also write the runs here")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:  # child: time the checkout given as `old`
        print("AB " + json.dumps(time_one(args.old)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    order = (args.old, args.new, args.new, args.old)
    runs = []
    for root in order:
        p = subprocess.run([sys.executable, __file__, root, root, "--one"],
                           capture_output=True, text=True)
        line = [s for s in p.stdout.splitlines() if s.startswith("AB ")]
        if p.returncode or not line:
            print(p.stdout[-3000:], p.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(json.loads(line[0][3:]))
    print(f"{'shape':34s} {'old ms':>17s} {'new ms':>17s} "
          f"{'old host µs':>13s} {'new host µs':>13s}")
    for name in runs[0]:
        old = [runs[i][name] for i in (0, 3)]
        new = [runs[i][name] for i in (1, 2)]
        cold = (f"  cold {old[0]['cold_ms']:.5f}/{old[1]['cold_ms']:.5f} "
                f"{new[0]['cold_ms']:.5f}/{new[1]['cold_ms']:.5f}"
                if "cold_ms" in old[0] else "")
        print(f"{name:34s} {old[0]['ms']:.5f}/{old[1]['ms']:.5f} "
              f"{new[0]['ms']:.5f}/{new[1]['ms']:.5f} "
              f"{old[0]['host_us']:6.2f}/{old[1]['host_us']:6.2f} "
              f"{new[0]['host_us']:6.2f}/{new[1]['host_us']:6.2f}{cold}")
    print(f"{'group_norm per UNet evaluation':34s} {'old ms':>17s} "
          f"{'new ms':>17s} {'old cold ms':>17s} {'new cold ms':>17s}")
    for model in dict.fromkeys(m for m, _, _ in GN_SHAPES):
        sums = [{k: sum(run[gn_name(*shape)][k] * calls
                        for m, shape, calls in GN_SHAPES if m == model)
                 for k in ("ms", "cold_ms")} for run in runs]
        print(f"{model:34s} {sums[0]['ms']:.5f}/{sums[3]['ms']:.5f} "
              f"{sums[1]['ms']:.5f}/{sums[2]['ms']:.5f} "
              f"{sums[0]['cold_ms']:.5f}/{sums[3]['cold_ms']:.5f} "
              f"{sums[1]['cold_ms']:.5f}/{sums[2]['cold_ms']:.5f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, order=order, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
