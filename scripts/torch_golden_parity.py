"""The PyTorch port's consumer of golden cases: latent-for-latent parity
verdicts of ``theatergen_tpu_torch/eval/goldens.py`` (the port's
counterpart of ``scripts/golden_parity.py``).

Two modes:

``--goldens DIR --weights WEIGHTS_DIR``
    The real measurement.  Loads the checkpoints (``models/weights.py::
    load_bundle``: SD1.5 for the SD1.5 kinds, SDXL for the SDXL kinds,
    only the stacks the cases need), then for every case in DIR runs the
    kind's pipeline on the case's injected inputs and prints one JSON line
    per row (per-step latent MSE, final relative MSE, image PSNR, verdict).
    ``text2img`` runs twice (injected context, then the port's own text
    encoder), ``character_ip`` twice where the case has ``image_embeds``
    (injected IP tokens, then the port's own projector).  Exit code 1 if
    any row fails.

``--self``
    Exports one case PER KIND from the port's own tiny random-weight
    pipelines (``goldens.export_self_case``) into a temporary directory in
    the on-disk format the reference exporter writes, then consumes them:
    each must reproduce its recorded trajectory (final MSE below 1e-9) and
    image (PSNR above 50 dB, the bound of a PNG's 8-bit round trip), and
    each negative control (``goldens.NEGATIVE_CONTROLS``, a bug planted by
    ``goldens.plant_bug``) must fail the verdict.

The pipelines run on the card unless ``--device cpu``.  Usage::

    python scripts/torch_golden_parity.py --self --device cpu
    python scripts/torch_golden_parity.py --goldens /g --weights /w
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def self_test(device: str, out_json: str | None = None) -> int:
    from theatergen_tpu_torch.config import tiny_config, tiny_xl_config
    from theatergen_tpu_torch.eval import goldens as GD
    from theatergen_tpu_torch.pipelines.bundle import init_bundle

    bundle = init_bundle(tiny_config(), 0, device=device, with_ip=True,
                         with_controlnet=True, with_vision=True)
    xl_bundle = init_bundle(tiny_xl_config(), 1, device=device)
    rows = []
    with tempfile.TemporaryDirectory() as tdir:
        for seed, (kind, steps) in enumerate((
                ("text2img", 4), ("character_ip", 3), ("final_cn", 3),
                ("sdxl", 3), ("sdxl_ea", 3))):
            GD.export_self_case(xl_bundle if kind.startswith("sdxl")
                                else bundle, tdir, kind, num_steps=steps,
                                seed=seed + 7)
        for name in GD.list_cases(tdir):
            case = GD.load_case(tdir, name)
            b = xl_bundle if case.kind.startswith("sdxl") else bundle
            res = GD.run_case(b, case)
            res["pass"] = bool(res["final_mse"] < 1e-9
                               and res.get("image_psnr_db", 0) > 50.0)
            rows.append(res)
            print(json.dumps(res), flush=True)
        for kind, bug in GD.NEGATIVE_CONTROLS:
            case, b = GD.plant_bug(GD.load_case(tdir, f"self_{kind}"),
                                   xl_bundle if kind.startswith("sdxl")
                                   else bundle, bug)
            res = GD.run_case(b, case)
            res.update(bug=bug, **{"pass": not GD.verdict(res)})
            rows.append(res)
            print(json.dumps(res), flush=True)
    table = {"rows": rows, "kinds": sorted({r["kind"] for r in rows}),
             "all_pass": all(r["pass"] for r in rows),
             "mode": "self-test (tiny random weights)"}
    print(json.dumps({"all_pass": table["all_pass"],
                      "kinds": table["kinds"], "n_rows": len(rows)}))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(table, f, indent=1)
    return 0 if table["all_pass"] else 1


def real_run(goldens_dir: str, weights_dir: str, device: str,
             out_json: str | None = None) -> int:
    from theatergen_tpu_torch.config import sd15_config, sdxl_config
    from theatergen_tpu_torch.eval import goldens as GD
    from theatergen_tpu_torch.models.weights import load_bundle

    names = GD.list_cases(goldens_dir)
    # the kinds from meta.json alone, so the bundle choice reads no arrays
    kinds = {}
    for n in names:
        with open(os.path.join(goldens_dir, n, "meta.json")) as f:
            kinds[n] = json.load(f).get("kind", "text2img")
    need_sd15 = any(not k.startswith("sdxl") for k in kinds.values())
    need_xl = any(k.startswith("sdxl") for k in kinds.values())
    bundle = (load_bundle(sd15_config(), weights_dir, device=device)
              if need_sd15 else None)
    xl_bundle = (load_bundle(sdxl_config(), weights_dir, device=device)
                 if need_xl else None)
    rows = []
    for name in names:
        case = GD.load_case(goldens_dir, name)
        b = xl_bundle if case.kind.startswith("sdxl") else bundle
        modes = [{}]
        if case.kind == "text2img":
            modes.append({"use_own_text_encoder": True})
        elif case.kind == "character_ip" and case.image_embeds is not None:
            modes.append({"use_own_projector": True})
        for kw in modes:
            r = GD.run_case(b, case, **kw)
            r["pass"] = GD.verdict(r)
            rows.append(r)
            print(json.dumps(r), flush=True)
    table = {"rows": rows, "all_pass": all(r["pass"] for r in rows)}
    print(json.dumps({"all_pass": table["all_pass"], "n_rows": len(rows)}))
    if out_json:
        with open(out_json, "w") as f:
            json.dump(table, f, indent=1)
    return 0 if table["all_pass"] else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--goldens", default=None)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--self", action="store_true", dest="self_mode")
    ap.add_argument("--device", default="cuda",
                    help="where the pipelines run (default the card; pass "
                         "cpu to ask for the CPU)")
    ap.add_argument("--out_json", default=None)
    args = ap.parse_args(argv)
    if args.self_mode:
        return self_test(args.device, args.out_json)
    if not (args.goldens and args.weights):
        ap.error("--goldens and --weights required (or --self)")
    return real_run(args.goldens, args.weights, args.device, args.out_json)


if __name__ == "__main__":
    raise SystemExit(main())
