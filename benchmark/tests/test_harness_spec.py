"""BENCHMARK.json and every file it names: present, parsed, within the
benchmark's rules of names, units, keys and budget."""

import json
import re

import pytest

from harness_tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_names(spec):
    assert set(spec) == KEYS["top"]
    for kind, group in (("config", "configs"), ("workload", "workloads"),
                        ("end_to_end", "end_to_end"),
                        ("per_layer", "per_layer")):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names)), group
        for e in spec[group]:
            assert set(e) - {"workloads"} == KEYS[kind], e["name"]
            assert NAME.match(e["name"]), e["name"]
    for e in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    assert all(_line(w) for w in spec["command"])
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in spec["paths"])


def test_files_named_exist_and_parse(spec):
    for c in spec["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("benchmark/") and path.is_file()
        cfg = json.loads(path.read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert _line(c["source"]) and _line(c["why"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert _line(w["why"])
        json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        json.loads((BENCH / "limits" / f"{w['name']}.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_metrics_rules(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
    for w in cells:
        per = [m for m in spec["per_layer"] if w in m.get("workloads", cells)]
        assert per and any("mfu" in m["name"] for m in per)


def test_run_seconds_fit_the_check(spec):
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
