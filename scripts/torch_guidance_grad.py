"""How far the guidance energy's latent gradient through the SD1.5 IP UNet
may move with rounding, and what chip_smoke.py's gradient gate sees when
a kernel's branch falls off the graph.

    python3 scripts/torch_guidance_grad.py

On the card, for three seeded inputs (the energy of chip_smoke.py's
``energy_grad_phase``: batch 1, cond-only, two layout boxes with
step-aggregated reference maps): the gradient with the kernels, under
``plain_path()`` (bf16), and through an fp32 copy of the UNet (plain),
with each pair's max|diff|/max|ref|, relative L2 distance and cosine.
Then, for the first input, each kernel's autograd Function replaced in
this process by its launch on detached inputs (what a wrapper without a
gradient would return), one kernel at a time, and the same statistics
against the plain and the fp32 gradients.  Nothing is written.  Needs a
CUDA device and nvcc; imports no JAX.
"""

from __future__ import annotations

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from theatergen_tpu_torch import _build  # noqa: E402
from theatergen_tpu_torch.config import sd15_config  # noqa: E402
from theatergen_tpu_torch.models.layers import plain_path  # noqa: E402
from theatergen_tpu_torch.ops import flash_attention as fa  # noqa: E402
from theatergen_tpu_torch.ops import geglu_matmul as gg  # noqa: E402
from theatergen_tpu_torch.ops import groupnorm as gn  # noqa: E402
from theatergen_tpu_torch.pipelines import guidance  # noqa: E402
from theatergen_tpu_torch.pipelines.bundle import init_bundle  # noqa: E402

# (seed, timestep) of each input
INPUTS = ((41, 801), (42, 501), (43, 201))
# each Function, and its launch on detached inputs
DETACHED = {
    "flash_attention": (fa.FlashAttentionFn, lambda q, k, v, route: fa._launch(
        q.detach(), k.detach(), v.detach(), route)),
    "ff_geglu": (gg.FFMatmulFn, lambda x, w1, b1, w2: gg._ff_launch(
        x.detach(), w1, b1, w2)),
    "group_norm": (gn.FusedGroupNormFn, lambda x, s, b, g, e, a: gn._launch(
        x.detach(), s, b, g, e, a)),
}


def stats(a: torch.Tensor, ref: torch.Tensor) -> dict:
    d = a - ref
    return dict(max=(d.abs().max() / ref.abs().max()).item(),
                l2=(d.norm() / ref.norm()).item(),
                cos=F.cosine_similarity(a.flatten(), ref.flatten(),
                                        dim=0).item())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_guidance_grad: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    cfg = sd15_config()
    keys = cfg.guidance.attn_keys
    unet = init_bundle(cfg, seed=0, device="cuda", with_ip=True).unet_ip
    unet32 = copy.deepcopy(unet).float()
    ip_scale = torch.tensor(0.4, device="cuda")
    energy = guidance.unet_energy_fn(unet, cfg, ip_scale=ip_scale)
    energy32 = guidance.unet_energy_fn(unet32, cfg, ip_scale=ip_scale)
    side = cfg.pipeline.latent_height
    out = {}
    for n, (seed, t_value) in enumerate(INPUTS):
        g = torch.Generator(device="cuda").manual_seed(seed)
        lat = torch.randn(1, 4, side, side, device="cuda", generator=g)
        ctx = torch.randn(1, 77 + 4, cfg.unet.cross_attention_dim,
                          device="cuda", generator=g)
        t = torch.tensor(t_value, device="cuda")
        with torch.no_grad():
            _, cap = unet(lat, t.expand(1), ctx, capture_keys=keys,
                          ip_scale=ip_scale)
        refs = tuple(torch.rand((cfg.pipeline.max_objects,)
                                + tuple(cap[tuple(k)].shape[1:3]),
                                device="cuda", generator=g) for k in keys)
        gin = cs.guided_inputs(2, cfg, refs=refs)

        def grad(fn):
            leaf = lat.clone().requires_grad_(True)
            e = fn(leaf, t, ctx, gin) * cfg.guidance.loss_scale
            return torch.autograd.grad(e, leaf)[0]

        g_k = grad(energy)
        with plain_path():
            g_p, g_32 = grad(energy), grad(energy32)
        row = {"kernels vs plain": stats(g_k, g_p),
               "kernels vs fp32": stats(g_k, g_32),
               "plain vs fp32": stats(g_p, g_32)}
        if n == 0:
            for name, (fn, detached) in DETACHED.items():
                real = fn.apply
                fn.apply = staticmethod(detached)
                try:
                    g_m = grad(energy)
                    row[f"{name} detached vs plain"] = stats(g_m, g_p)
                    row[f"{name} detached vs fp32"] = stats(g_m, g_32)
                except RuntimeError as e:
                    row[f"{name} detached"] = f"no gradient ({e})"
                finally:
                    fn.apply = real
        out[f"seed {seed}, t {t_value}"] = row
        for what, v in row.items():
            print(f"seed {seed} t {t_value}  {what}: "
                  + (v if isinstance(v, str) else
                     f"max {v['max']:.4e}  L2 {v['l2']:.4e}  "
                     f"cosine {v['cos']:.6f}"), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
