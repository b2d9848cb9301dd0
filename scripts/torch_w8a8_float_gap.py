"""How far the port's W8A8 UNets lie from their float twins, and how much
of that the kernels add (on a CUDA card).

    python3 scripts/torch_w8a8_float_gap.py

For SD1.5 at 512 px and SDXL at 1024 px: the seed-0 bundle's bf16 UNet,
the same UNet quantized (``ops/quant.quantize_state_dict``) and an fp32
copy, each evaluated on three CFG-batch inputs (seed, timestep) under
both ``THEATERGEN_FUSED_INT8`` routes, with the kernels and under
``plain_path()``.  Prints one JSON line per model and input with
``max|a - b| / max|b|`` of: the W8A8 UNet against the float one with the
kernels and under the plain path, the W8A8 UNet's kernels against its
plain path, and each W8A8 path against the fp32 UNet; then the float
UNet's kernels against its plain path and both against fp32.  The gap of
the plain path is the W8A8 recipe's own error: no kernel runs there.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from theatergen_tpu_torch import _build  # noqa: E402
from theatergen_tpu_torch.models.layers import plain_path  # noqa: E402
from theatergen_tpu_torch.models.unet import UNet2DCondition  # noqa: E402
from theatergen_tpu_torch.ops import quant as qz  # noqa: E402
from theatergen_tpu_torch.pipelines.bundle import build_module  # noqa: E402

# (seed, timestep) of each input; the first is chip_smoke.py's UNet check
INPUTS = ((1, 981), (5, 501), (7, 101))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def model_gaps(name: str, cfg) -> dict:
    bundle = cs.build_bundle(cfg, name)
    quantized = build_module(
        UNet2DCondition, dataclasses.replace(cfg.unet, quantized=True),
        bundle.unet.dtype, "cuda")
    quantized.load_state_dict(qz.quantize_state_dict(bundle.unet.state_dict()))
    fp32 = build_module(UNet2DCondition, cfg.unet, torch.float32, "cuda")
    fp32.load_state_dict({k: v.float()
                          for k, v in bundle.unet.state_dict().items()})
    out = {}
    for seed, t_value in INPUTS:
        x, t, ctx, cond = cs.unet_inputs(bundle, seed, t_value)
        row = {}
        with torch.no_grad():
            float_k = bundle.unet(x, t, ctx, **cond).float()
            with plain_path():
                float_p = bundle.unet(x, t, ctx, **cond).float()
                ref32 = fp32(x, t, ctx, **cond).float()
            for mode in ("1", "0"):
                qz.FUSED_MODE = mode
                w8_k = quantized(x, t, ctx, **cond).float()
                with plain_path():
                    w8_p = quantized(x, t, ctx, **cond).float()
                row[f"route_{mode}"] = dict(
                    kernels_w8a8_vs_float=rel(w8_k, float_k),
                    plain_w8a8_vs_float=rel(w8_p, float_p),
                    kernels_vs_plain_w8a8=rel(w8_k, w8_p),
                    kernels_w8a8_vs_fp32=rel(w8_k, ref32),
                    plain_w8a8_vs_fp32=rel(w8_p, ref32))
            qz.FUSED_MODE = "0"
        row["float"] = dict(kernels_vs_plain=rel(float_k, float_p),
                            kernels_vs_fp32=rel(float_k, ref32),
                            plain_vs_fp32=rel(float_p, ref32))
        out[f"seed{seed}_t{t_value}"] = row
        print(json.dumps({"model": name, "seed": seed, "t": t_value, **row}),
              flush=True)
    del bundle, quantized, fp32
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_w8a8_float_gap: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    _build.build()
    for name, cfg in (("sd15_512", cs.sd15_config()),
                      ("sdxl_1024", cs.sdxl_config())):
        model_gaps(name, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
