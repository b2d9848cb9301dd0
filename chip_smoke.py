"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # build, check, time, run 3 requests
    python3 chip_smoke.py --profile  # also print a kernel-time breakdown

Phases, in order (any failure exits non-zero):
  1. the card's name and power limit;
  2. build every kernel of ``theatergen_tpu_torch/csrc`` with nvcc (sm_90a);
  3. hold each kernel against its plain PyTorch version (fp32 from the same
     bf16 inputs) at every shape the main path gives it;
  4. time kernel, plain version and a library yardstick at those shapes;
  5. one full-size UNet evaluation with the kernels against the same UNet
     on its plain path;
  6. the main path: ``init_bundle(sd15_config())`` and
     ``Text2Img(bundle, num_steps=50)`` on three prompts at 512 px, CFG 7.5,
     with every launch counter set to 0 before and read after each request.
Then one JSON line of kernel records and, last, the device line.
Needs a CUDA device; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from theatergen_tpu_torch import _build
from theatergen_tpu_torch.config import sd15_config
from theatergen_tpu_torch.models.layers import CrossAttention, FeedForward
from theatergen_tpu_torch.ops import flash_attention as fa
from theatergen_tpu_torch.ops import geglu_matmul as gg
from theatergen_tpu_torch.pipelines import sd
from theatergen_tpu_torch.pipelines.bundle import init_bundle

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# the kernels' outputs are bf16: 8 mantissa bits round at ~4e-3 relative
TOL = 1e-2
# SD1.5 at 512 px, batch 1 with CFG (2 rows): (shape, calls per UNet eval)
FLASH_SHAPES = [((2, 4096, 8, 40), 5), ((2, 1024, 8, 80), 5)]
FF_SHAPES = [((8192, 320, 1280), 5), ((2048, 640, 2560), 5),
             ((512, 1280, 5120), 5), ((128, 1280, 5120), 1)]
STEPS = 50
PROMPTS = ["a red knight rides through a dark forest",
           "a girl with a blue umbrella on a rainy street",
           "two cats asleep on a wooden table"]


def log(*a):
    print(*a, flush=True)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, device="cuda", generator=gen) * scale).to(
        torch.bfloat16)


def check(err: float, ref_max: float, what: str) -> None:
    ok = err <= TOL * ref_max
    log(f"  {what}: max_abs_err {err:.3e}  bound {TOL * ref_max:.3e} "
        f"(1e-2*max|ref|)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{what}: kernel disagrees with its plain version")


def flash_phase(gen) -> dict:
    rows = []
    for (b, s, h, d), calls in FLASH_SHAPES:
        q, k, v = (randn(gen, b, s, h, d) for _ in range(3))
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q.float(), k.float(), v.float())
        err = (out.float() - ref).abs().max().item()
        check(err, ref.abs().max().item(), f"flash S={s} d={d}")
        row = dict(shape=[b, s, h, d], calls_per_unet_eval=calls,
                   max_abs_err=err)
        bms, by = bound(fa.flops(b, s, h, d), fa.min_bytes(b, s, h, d))
        row.update(bound_ms=bms, bound_by=by)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row["ms"] = time_ms(lambda: fa.flash_attention(q, k, v), 20)
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(
            q.float(), k.float(), v.float()), 3, 1)
        row["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)
        log(f"  flash S={s} d={d}: kernel {row['ms']:.4f} ms  plain "
            f"{row['plain_ms']:.4f}  sdpa {row['library_ms']:.4f}  "
            f"bound {bms:.4f} ({by})")
        rows.append(row)
        del q, k, v, ref, out
    return _record("flash_attention", "csrc/flash_attention.cu",
                   "theatergen_tpu/ops/flash_attention.py:283",
                   "flash_attention_packed (_flat_call)", rows)


def ff_phase(gen) -> dict:
    rows = []
    for (m, d, k), calls in FF_SHAPES:
        x = randn(gen, m, d)
        w1 = randn(gen, 2 * k, d, scale=d ** -0.5)
        b1 = randn(gen, 2 * k, scale=0.1)
        w2 = randn(gen, d, k, scale=k ** -0.5)
        out = gg.ff_matmul(x, w1, b1, w2)
        torch.cuda.synchronize()
        ref = gg.ff_matmul_plain(x.float(), w1.float(), b1.float(),
                                 w2.float())
        err = (out.float() - ref).abs().max().item()
        check(err, ref.abs().max().item(), f"ff M={m} D={d} K={k}")
        row = dict(shape=[m, d, k], calls_per_unet_eval=calls,
                   max_abs_err=err)
        bms, by = bound(gg.flops(m, d, k), gg.min_bytes(m, d, k))
        row.update(bound_ms=bms, bound_by=by)

        def library():
            val, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
            return torch.matmul(val * F.gelu(gate), w2.t())

        row["ms"] = time_ms(lambda: gg.ff_matmul(x, w1, b1, w2), 20)
        row["plain_ms"] = time_ms(lambda: gg.ff_matmul_plain(
            x.float(), w1.float(), b1.float(), w2.float()), 5, 1)
        row["library_ms"] = time_ms(library, 20)
        log(f"  ff M={m} D={d} K={k}: kernel {row['ms']:.4f} ms  plain "
            f"{row['plain_ms']:.4f}  torch {row['library_ms']:.4f}  "
            f"bound {bms:.4f} ({by})")
        rows.append(row)
    return _record("ff_geglu", "csrc/ff_geglu.cu",
                   "theatergen_tpu/ops/geglu_matmul.py:471",
                   "ff_matmul (_ff_matmul_2d)", rows)


def _record(name, source, replaces, tpu_function, rows) -> dict:
    """One kernel's record; times are summed over one UNet evaluation
    (each shape times its calls per evaluation)."""
    def per_eval(key):
        return sum(r[key] * r["calls_per_unet_eval"] for r in rows)

    b_ms = sum(r["bound_ms"] * r["calls_per_unet_eval"] for r in rows)
    err = max(r["max_abs_err"] for r in rows)
    return dict(
        name=name, route="cuda", source=f"theatergen_tpu_torch/{source}",
        replaces=replaces, tpu_function=tpu_function, launches=0,
        max_abs_err=err, max_err=err,
        ms=per_eval("ms"), kernel_ms=per_eval("ms"),
        plain_ms=per_eval("plain_ms"), library_ms=per_eval("library_ms"),
        bound_ms=b_ms, bound_us=b_ms * 1e3,
        bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"],
        per="one UNet evaluation, SD1.5 512 px, batch 1 with CFG",
        shapes=rows)


def set_kernels(unet, on: bool) -> None:
    for m in unet.modules():
        if isinstance(m, CrossAttention):
            m.use_flash = on
        elif isinstance(m, FeedForward):
            m.fused_ff = on


def unet_reference_phase(bundle) -> float:
    """One full-size UNet eval with the kernels vs the plain path."""
    cfg = bundle.cfg
    g = torch.Generator(device="cuda").manual_seed(1)
    h, w = cfg.pipeline.latent_height, cfg.pipeline.latent_width
    x = torch.randn(2, 4, h, w, device="cuda", generator=g)
    ctx = torch.randn(2, cfg.text.max_length, cfg.unet.cross_attention_dim,
                      device="cuda", generator=g)
    t = torch.full((2,), 981, device="cuda", dtype=torch.long)
    with torch.no_grad():
        fast = bundle.unet(x, t, ctx).float()
        set_kernels(bundle.unet, False)
        plain = bundle.unet(x, t, ctx).float()
        set_kernels(bundle.unet, True)
    rel = ((fast - plain).abs().max() / plain.abs().max()).item()
    ok = torch.isfinite(fast).all().item() and rel <= 5e-2
    # bf16 activations through 16 transformer blocks: the two paths round
    # differently (fp32 vs bf16 GEGLU up-projection, fp32 logits)
    log(f"  UNet eps, kernels vs plain path: max|diff|/max|ref| {rel:.3e} "
        f"(bound 5e-2)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("UNet with kernels disagrees with its plain path")
    return rel


def main_path(records) -> dict:
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = init_bundle(sd15_config(), seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"  init_bundle(sd15_config()): {time.perf_counter() - t0:.3f} s, "
        f"UNet {sum(p.numel() for p in bundle.unet.parameters()) / 1e6:.1f} M "
        f"params")
    unet_rel = unet_reference_phase(bundle)
    pipe = sd.Text2Img(bundle, num_steps=STEPS)
    want = {"flash_attention": 10 * STEPS, "ff_geglu": 16 * STEPS}
    seconds = []
    for i, prompt in enumerate(PROMPTS):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        fa.launches = 0
        gg.launches = 0
        t0 = time.perf_counter()
        img = pipe(gen, prompt)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        got = {"flash_attention": fa.launches, "ff_geglu": gg.launches}
        for r in records:
            r["launches"] += got[r["name"]]
        finite = bool(torch.isfinite(img).all())
        in_range = bool(img.min() >= 0.0 and img.max() <= 1.0)
        log(f"  request {i}: {seconds[-1]:.3f} s  launches {got}  shape "
            f"{tuple(img.shape)}  finite {finite}  range [{img.min():.4f}, "
            f"{img.max():.4f}]  std {img.std():.4f}")
        if (tuple(img.shape) != (1, 512, 512, 3) or not finite
                or not in_range):
            raise SystemExit(f"request {i}: bad image")
        if got != want:
            raise SystemExit(f"request {i}: launches {got}, want {want}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  seconds per request {seconds}; peak memory "
        f"{peak / 2 ** 30:.3f} GiB")
    return dict(seconds_per_request=seconds, peak_bytes=peak,
                unet_kernels_vs_plain_rel=unet_rel, bundle=bundle)


def profile(bundle) -> None:
    """Device time by kernel name over one UNet evaluation (batch 2)."""
    from torch.profiler import ProfilerActivity, profile as prof
    cfg = bundle.cfg
    x = torch.randn(2, 4, cfg.pipeline.latent_height,
                    cfg.pipeline.latent_width, device="cuda")
    ctx = torch.randn(2, cfg.text.max_length, cfg.unet.cross_attention_dim,
                      device="cuda")
    t = torch.full((2,), 501, device="cuda", dtype=torch.long)
    with torch.no_grad():
        bundle.unet(x, t, ctx)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            bundle.unet(x, t, ctx)
            torch.cuda.synchronize()
    log(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="print device time by kernel for one UNet eval")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        print(f"chip_smoke: nvidia-smi failed: {smi.stderr}", file=sys.stderr)
        return 1
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__} "
        f"cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s for "
        f"{_build.kernel_names()} into {_build.BUILD_DIR}")
    for name, info in sorted(_build.build_log.items()):
        log(f"  {name}.cu: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line) \
                    or "spill" in line:
                log(f"    {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    log("[check+time] kernels vs plain versions at the main path's shapes")
    records = [flash_phase(gen), ff_phase(gen)]
    torch.cuda.synchronize()

    log("[main path] SD1.5 Text2Img, 512 px, 50 DDIM steps, CFG 7.5, bf16")
    result = main_path(records)
    if args.profile:
        profile(result["bundle"])
    summary = {k: v for k, v in result.items() if k != "bundle"}
    log(json.dumps({"main_path": summary, "card": card}))
    log(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
