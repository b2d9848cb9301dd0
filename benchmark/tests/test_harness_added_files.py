"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files (and entries of BENCHMARK.json) only: the
harness finds them by name and runs them, no existing file edited."""

import hashlib
import json

import torch

from harness_tiny import make_root

from harness import bench
from harness.main import run_cell

METRIC = '''"""Turns of the window per round (a test metric)."""


def read(run):
    rounds = {t["n"] for t in run.turns}
    return len(run.turns) / len(rounds)
'''


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_cell_and_metric_run(tmp_path):
    torch.set_num_threads(2)
    root = make_root(tmp_path)
    before = _digests(root)
    b = root / "benchmark"
    mix = json.loads((b / "traffic" / "tiny_serve4.json").read_text())
    mix.update(sessions=2, stagger=2, check_turns=1)
    (b / "traffic" / "tiny_pairs.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny_pairs_cell.json").write_text(
        json.dumps(dict(char_gap=1e-3, final_gap=1e-3)))
    (b / "metrics" / "turns_per_round.py").write_text(METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name="tiny_pairs_cell", config="tiny_sd",
                                  traffic="tiny_pairs", chips=1,
                                  why="tests"))
    spec["per_layer"].append(dict(
        name="turns_per_round", unit="turns", better="higher",
        source="program_counter", layer="server (serve.py)",
        moves="turns_per_s", workloads=["tiny_pairs_cell"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())

    cell = bench.load_cell("tiny_pairs_cell", root)
    assert cell.traffic["sessions"] == 2
    assert "turns_per_round" in [m["name"] for m in cell.per_layer]
    res = run_cell("tiny_pairs_cell", 5, 0.0, True, device="cpu", root=root)
    assert res["correct"], res["check"]
    assert res["metrics"]["turns_per_round"]["value"] == 2.0
    other = bench.load_cell("tiny_serve4", root)
    assert "turns_per_round" not in [m["name"] for m in other.per_layer]
