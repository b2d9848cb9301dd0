"""What a run reads: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell
or one per-layer metric sits in a file of its own, found by its name:

- ``configs/<config>.json``: the model and pipeline configuration tree
  (``model``), the bundle's parts (``bundle``), the boxes' canvas;
- ``traffic/<mix>.json``: the sessions, the turn shapes and the content
  the generator draws from (``harness/traffic.py``);
- ``limits/<cell>.json``: the limits of the numbers the check compares;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import typing
from pathlib import Path
from typing import Any, Callable, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Optional[dict]
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``; its files lie
    under the benchmark directory beside ``root``'s ``benchmark/``."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    limits_path = bench / "limits" / f"{workload}.json"

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(limits_path) if limits_path.exists() else None,
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def build_config(cls, tree: Optional[dict]):
    """The dataclass ``cls`` (a package's ``TheaterConfig``) from a JSON
    tree: nested dataclasses by their fields' types, lists as tuples;
    fields the tree leaves out keep their defaults."""
    if tree is None:
        return None
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in tree:
            continue
        kwargs[f.name] = _value(hints[f.name], tree[f.name])
    return cls(**kwargs)


def _value(hint, value):
    if value is None:
        return None
    sub = _dataclass_of(hint)
    if sub is not None and isinstance(value, dict):
        return build_config(sub, value)
    return _tuples(value)


def _dataclass_of(hint):
    if dataclasses.is_dataclass(hint):
        return hint
    for arg in typing.get_args(hint):
        if dataclasses.is_dataclass(arg):
            return arg
    return None


def _tuples(value):
    if isinstance(value, list):
        return tuple(_tuples(v) for v in value)
    return value


def program_config(cell: Cell):
    """The port's ``TheaterConfig`` of the cell."""
    from theatergen_tpu_torch.config import TheaterConfig

    return build_config(TheaterConfig, cell.config["model"])


def reference_config(cell: Cell):
    """The plain reference's ``TheaterConfig`` of the cell."""
    from reference.config import TheaterConfig

    return build_config(TheaterConfig, cell.config["model"])
