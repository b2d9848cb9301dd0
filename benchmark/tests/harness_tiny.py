"""A benchmark root with tiny cells, for the CPU tests.

``make_root(tmp)`` copies ``benchmark/`` under ``tmp`` and adds files
only: two tiny configurations (the port's ``tiny_config`` and
``tiny_xl_config``), two small traffic mixes and their limits, and a
``BENCHMARK.json`` that names them, so the harness runs them as it runs
the real cells.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for _p in (str(BENCH), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY_CELLS = ("tiny_serve4", "tiny_xl_serial")


def _config(name: str, cfg, flags: dict) -> dict:
    return dict(name=name, source="tests", reduced=[], bundle=flags,
                box_canvas=512,
                model=json.loads(json.dumps(dataclasses.asdict(cfg))))


def make_root(tmp: Path, limits=None, dtype: str = "float32") -> Path:
    """The root; ``dtype`` is the tiny models' (the UNets', VAE's,
    ControlNet's and adapter's)."""
    from theatergen_tpu_torch.config import tiny_config, tiny_xl_config

    root = Path(tmp)
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    sd, xl = (_with_dtype(c, dtype) for c in (tiny_config(),
                                                tiny_xl_config()))
    flags_sd = dict(with_ip=True, with_vision=True, with_controlnet=True,
                    with_t2i_adapter=False)
    flags_xl = dict(with_ip=True, with_vision=True, with_controlnet=False,
                    with_t2i_adapter=True)
    for name, cfg, flags in (("tiny_sd", sd, flags_sd),
                             ("tiny_xl", xl, flags_xl)):
        (b / "configs" / f"{name}.json").write_text(
            json.dumps(_config(name, cfg, flags)))
    serve = json.loads((b / "traffic" / "story_serve8.json").read_text())
    serve.update(sessions=4, check_turns=2)
    serial = json.loads((b / "traffic" / "story_serial.json").read_text())
    (b / "traffic" / "tiny_serve4.json").write_text(json.dumps(serve))
    (b / "traffic" / "tiny_serial.json").write_text(json.dumps(serial))
    lim = limits or dict(char_gap=1e-3, final_gap=1e-3)
    for cell in TINY_CELLS:
        (b / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = copy.deepcopy(spec)
    spec["configs"] = [
        dict(name="tiny_sd", source="tests", reduced=[],
             file="benchmark/configs/tiny_sd.json", why="tests"),
        dict(name="tiny_xl", source="tests", reduced=[],
             file="benchmark/configs/tiny_xl.json", why="tests")]
    spec["workloads"] = [
        dict(name="tiny_serve4", config="tiny_sd", traffic="tiny_serve4",
             chips=1, why="tests"),
        dict(name="tiny_xl_serial", config="tiny_xl",
             traffic="tiny_serial", chips=1, why="tests")]
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = list(TINY_CELLS)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _with_dtype(cfg, dtype: str):
    unet = dataclasses.replace(cfg.unet, dtype=dtype)
    return dataclasses.replace(
        cfg, unet=unet, vae=dataclasses.replace(cfg.vae, dtype=dtype),
        controlnet=dataclasses.replace(cfg.controlnet, unet=dataclasses.replace(
            cfg.controlnet.unet, dtype=dtype)))
