"""A run fails rather than report a device number: without a card, and in
a directory that holds only the benchmark's files."""

import shutil
import subprocess
import sys

import pytest
import torch

from harness_tiny import BENCH, ROOT

CMD = ["benchmark/run.py", "--workload", "sd15_story_serve8", "--seed",
       "3000000001", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run([sys.executable] + CMD, cwd=cwd,
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_only_the_benchmark_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_card_run_prints_one_result_line():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json

    out = subprocess.run([sys.executable] + CMD, cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["device"]["platform"] == "gpu"
