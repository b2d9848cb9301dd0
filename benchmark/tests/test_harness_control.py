"""The control, at a size a test run holds: the plain reference computed
with float8 linears and convolutions (the precision below the bf16 the
configuration states) must come out not correct under the cell's
limits, where the served program, in bf16, comes out correct.  The tiny
configuration runs its UNets, VAE and ControlNet in bf16 here, so the
control has a bf16 module to lower; on the card the same control runs at
the cell's own size (benchmark/readings.py)."""

import json

import pytest
import torch

from harness_tiny import BENCH, make_root

from readings import readings

SEEDS = (3, 2 ** 31 + 5, 77777777777)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("bench"), dtype="bfloat16")


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_where_the_program_passes(root, seed):
    limits = json.loads(
        (BENCH / "limits" / "sd15_story_serve8.json").read_text())
    r = readings("tiny_serve4", seed, True, True, device="cpu", root=root)
    for n, limit in limits.items():
        assert r["program"][n] <= limit, (n, r)
    assert any(r["control"][n] > limit for n, limit in limits.items()), r
    assert all(r["control"][n] > 3 * r["program"][n] for n in limits), r
