"""Where a group_norm call spends its time on the card: a copy of
``csrc/group_norm.cu`` with ``%globaltimer`` stamps taken by thread 0 of
every CTA at the kernel's phase boundaries, built into
``build/gn_phases/`` and swapped in for the kernel, then called once
per shape on an input that is not in L2.

    python3 scripts/torch_gn_phases.py

Phases (from stamp to stamp): start → loads issued (``prologue``) → the
share arrived and its count, mean and centred M2 taken
(``load+stats``) → the cluster's exchange (``exchange``) → normalised
and stored (``store``); on the shared-memory route also when each chunk
arrived and when its statistics were done, from the CTA's start.
Prints per shape the median and largest of each phase over the CTAs,
the span from the first CTA's start to the last one's end, the graph
time of the call (warm and cold, as chip_smoke.py takes them), and the
graph time of a one-element kernel (the launch floor).  Needs a CUDA
device and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from theatergen_tpu_torch import _build  # noqa: E402
from theatergen_tpu_torch.ops import groupnorm as gn  # noqa: E402

SHAPES = [(2, 1280, 64), (2, 1280, 256), (2, 640, 1024), (2, 320, 4096),
          (2, 640, 4096), (2, 320, 16384)]
PHASES = ["prologue", "load+stats", "exchange", "store"]
HEADER = r'''
__device__ unsigned long long* tg_gn_stamps;
__device__ __forceinline__ unsigned long long tg_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TG_STAMP(k) \
  if (threadIdx.x == 0) tg_gn_stamps[(size_t)blockIdx.x * 16 + (k)] = tg_globaltimer();
extern "C" int tg_gn_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(tg_gn_stamps, &p, sizeof(p));
}
'''
# (text in the source, stamp placed after it)
ANCHORS = [
    ("  const int tid = threadIdx.x, nthr = blockDim.x;\n", 0),
    ("  if (V == 0) __syncthreads();             // the chunks' mbarriers exist\n",
     1),
    ("  float4 st = make_float4(n_loc, mean_loc, block_sum(m2_t + n_t * d_t * d_t, "
     "red, call), 0.f);\n", 2),
    ("  const float mean = st.y, inv = rsqrtf(st.z / st.x + eps);\n", 3),
    ("      next();\n    }\n  }\n", 4),
    # inside the prologue: the mbarriers initialised (5), the scale and
    # bias loads issued (6)
    ("  if (ncta > 1) cluster_arrive_relaxed();  // this CTA's stats_in exists\n",
     5),
    ("    bi0 = bias[c0 + tid];\n  }\n", 6),
    # shared-memory route: chunk k arrived (8 + k), its statistics done
    # (12 + k)
    ("      mbar_wait(&full[k], 0);\n", "8 + k"),
    ("      for (int i = k * cpc + tid; i < end; i += nthr) m += sq8(data[i], "
     "mean_k);\n      merge(count, s, m);\n", "12 + k"),
]


def build() -> ctypes.CDLL:
    src = (_build.CSRC / "group_norm.cu").read_text()
    for text, k in ANCHORS:
        if src.count(text) != 1:
            raise SystemExit(f"anchor not found once: {text!r}")
        src = src.replace(text, text + f"  TG_STAMP({k})\n")
    src = src.replace('#include "common.cuh"\n',
                      '#include "common.cuh"\n' + HEADER, 1)
    out = os.path.join(ROOT, "build", "gn_phases")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "group_norm.cu"), os.path.join(out, "libgn.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", so, cu]
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode:
        raise SystemExit(p.stdout + p.stderr)
    return ctypes.CDLL(so)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gn_phases: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = build()
    _build._libs["group_norm"] = lib
    set_stamps = lib.tg_gn_set_stamps
    set_stamps.restype, set_stamps.argtypes = ctypes.c_int, [ctypes.c_void_p]
    one = torch.zeros(1, device="cuda")
    floor = cs.graph_ms(lambda: one.add_(1.0))
    print(f"launch floor (one-element add, graph replay): {floor * 1e3:.2f} µs")
    for b, c, hw in SHAPES:
        plan = gn.launch_plan(b, c, hw, 32)
        ctas = b * 32 * plan.cluster
        stamps = torch.zeros(ctas, 16, dtype=torch.int64, device="cuda")
        w = (1.0 + 0.2 * torch.randn(c, device="cuda", generator=gen)).to(
            torch.bfloat16)
        bias = cs.randn(gen, c, scale=0.1)
        xs = cs.cold_inputs(lambda: cs.randn(gen, b, c, hw), 2 * b * c * hw)
        if set_stamps(stamps.data_ptr()):
            raise SystemExit("cudaMemcpyToSymbol failed")
        warm = cs.graph_ms(lambda: gn.fused_group_norm(xs[0], w, bias,
                                                       act="silu"))
        cold = cs.cold_graph_ms(
            lambda xi: gn.fused_group_norm(xi, w, bias, act="silu"), xs)
        for xi in xs[1:]:
            gn.fused_group_norm(xi, w, bias, act="silu")
        torch.cuda.synchronize()
        stamps.zero_()
        gn.fused_group_norm(xs[0], w, bias, act="silu")
        torch.cuda.synchronize()
        t = stamps.cpu().tolist()
        t0 = min(r[0] for r in t)
        span = (max(r[len(PHASES)] for r in t) - t0) / 1e3
        starts = sorted((r[0] - t0) / 1e3 for r in t)
        parts = []
        for k, name in enumerate(PHASES):
            d = [(r[k + 1] - r[k]) / 1e3 for r in t]
            parts.append(f"{name} {statistics.median(d):.2f}/{max(d):.2f}")
        for k, what in ((5, "mbarriers initialised"),
                        (6, "scale/bias loads issued")):
            d = [(r[k] - r[0]) / 1e3 for r in t]
            parts.append(f"{what} at {statistics.median(d):.2f}")
        if plan.chunks:
            for k in range(plan.chunks):
                arr = [(r[8 + k] - r[0]) / 1e3 for r in t]
                done = [(r[12 + k] - r[0]) / 1e3 for r in t]
                parts.append(f"chunk {k} in at {statistics.median(arr):.2f}"
                             f", stats at {statistics.median(done):.2f}")
        print(f"B{b} C{c} HW{hw} plan {tuple(plan)} ({ctas} CTAs): graph "
              f"warm {warm * 1e3:.2f} µs cold {cold * 1e3:.2f}; span "
              f"{span:.2f} µs, CTA starts over {starts[-1]:.2f} µs; phases "
              f"µs median/max: " + ", ".join(parts), flush=True)
        del xs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
