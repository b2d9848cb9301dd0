"""The mesh through the port's entry points on the CPU: ``python -m
theatergen_tpu_torch.cli.generate --mesh dp=2`` (which spawns its two
gloo ranks itself) and ``TheaterServer(mesh=)`` on rank 0 of two ranks
(``tests/torch_mesh_ranks.py``), against the same runs on one process.

Covered: ``--mesh dp=2`` over the tiny dialogues writes the output tree
and run log of ``--batch_chars`` (the same files, rank 0 alone writing;
images within MESH_TOL, since a lone character runs as a padded batch of
two over the mesh), ``--mesh dp=2 --dp_dialogues 2`` the tree of
``--dp_dialogues 2``, ``--mesh dp=1`` the ``--batch_chars`` images bit for
bit (one rank is the same program), and the server answering two
dialogues' first turns as one wave over the mesh.
"""

import json
import os

import numpy as np
import pytest
import torch

from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.config import tiny_config
from theatergen_tpu_torch.pipelines.bundle import init_bundle
from theatergen_tpu_torch.serve import TheaterServer
from theatergen_tpu_torch.utils import png

import torch_mesh_ranks as ranks

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                    "sample")
# uint8 images of the mesh run against the one-process run: a batch of
# two (the lone character padded for dp = 2) reorders the tiny UNet's fp32
# sums, which 3 DDIM steps at CFG 7.5 and the decode carry to a few levels
MESH_TOL = 8
JOIN_S = 2 * ranks.TIMEOUT_S
# every mesh run's process groups wait TIMEOUT_S for a peer and its ranks
# are killed past JOIN_S, so a deadlock fails the test
LIMITS = dict(timeout_s=ranks.TIMEOUT_S, join_s=JOIN_S)


@pytest.fixture(autouse=True)
def _one_thread_per_rank(monkeypatch):
    """The spawned ranks take one thread each, as this process does."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _cli(root, *flags):
    return ["--tiny", "--device", "cpu", "--dataset_path", DATA,
            "--max_dialogues", "2", "--num_steps", "3",
            "--base_save_dir", str(root / "out"),
            "--database_path_base", str(root / "db"), *flags]


def _tree(root):
    out = {}
    for d, _, files in os.walk(root / "out"):
        for f in files:
            if f.endswith(".png"):
                rel = os.path.relpath(os.path.join(d, f), root / "out")
                out[rel] = png.read_png(os.path.join(d, f))
    return out


def _events(root):
    with open(root / "out" / "story" / "run0" / "run_log.jsonl") as f:
        return [json.loads(line) for line in f]


def _same_tree(a, b, tol):
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb) and ta
    worst = max(int(np.abs(ta[k].astype(int) - tb[k].astype(int)).max())
                for k in ta)
    assert worst <= tol, worst
    ea, eb = _events(a), _events(b)
    key = lambda e: (e["event"], e.get("dialogue"), e.get("turn"),  # noqa
                     e.get("seed"), e.get("characters"))
    assert [key(e) for e in ea if e["event"] == "turn"] == \
        [key(e) for e in eb if e["event"] == "turn"]
    assert sorted(os.listdir(a / "db" / "story")) == \
        sorted(os.listdir(b / "db" / "story"))
    return worst


@pytest.fixture(scope="module")
def batch_chars_run(tmp_path_factory):
    """The one-process ``--batch_chars`` run both mesh runs without waves
    are held to."""
    one = tmp_path_factory.mktemp("batch_chars")
    tgen.main(_cli(one, "--batch_chars"))
    return one


@pytest.mark.parametrize("flags", [[], ["--dp_dialogues", "2"]])
def test_cli_mesh_dp2_writes_the_batched_tree(tmp_path, batch_chars_run,
                                              flags):
    """``--mesh dp=2`` (with and without dialogue waves) writes the tree,
    turn events and DB entries of the one-process run (``--batch_chars``,
    resp. ``--dp_dialogues 2``), its images within MESH_TOL."""
    one, mesh = batch_chars_run, tmp_path / "mesh"
    if flags:
        one = tmp_path / "one"
        tgen.main(_cli(one, *flags))
    tgen.main(_cli(mesh, "--mesh", "dp=2", *flags), **LIMITS)
    _same_tree(one, mesh, MESH_TOL)


def test_cli_mesh_dp1_is_batch_chars_bit_for_bit(tmp_path, batch_chars_run):
    """One rank over a one-rank process group is ``--batch_chars``: the
    same images, bit for bit."""
    mesh = tmp_path / "mesh"
    tgen.main(_cli(mesh, "--mesh", "dp=1"), **LIMITS)
    assert _same_tree(batch_chars_run, mesh, 0) == 0


def test_server_over_a_mesh_answers_two_dialogues(tmp_path):
    """``TheaterServer(mesh=)`` on rank 0 of two ranks: two sessions' first
    turns (dialogue_0 and dialogue_1) as one wave over the mesh, each
    image within MESH_TOL/255 of the one-process server's."""
    with open(os.path.join(DATA, "story.json")) as f:
        data = json.load(f)
    specs = [tgen.build_spec(data[d]["turn 1"])
             for d in ("dialogue_0", "dialogue_1")]
    for s in specs:
        s["canvas_height"] = s["canvas_width"] = 512
    bundle = init_bundle(tiny_config(), 0, device="cpu", with_ip=True,
                         with_vision=True, with_controlnet=True)
    seeds = [3, 4]
    torch.save(dict(bundle=bundle, specs=specs, seeds=seeds, steps=3),
               os.path.join(tmp_path, "inputs.pt"))
    from theatergen_tpu_torch.parallel import worker

    worker.spawn(ranks.server, 2, (str(tmp_path), 2), timeout_s=JOIN_S)
    res = torch.load(os.path.join(tmp_path, "results.pt"),
                     weights_only=False)
    assert res["waves"] == 1
    srv = TheaterServer(bundle, str(tmp_path / "db1"), wave_policy="always",
                        batch_window_s=2.0, num_steps=3)
    try:
        futs = []
        for i, s in enumerate(specs):
            srv.open_session(f"s{i}")
            futs.append(srv.submit(f"s{i}", s, seed=seeds[i]))
        ref = [f.result(ranks.TIMEOUT_S).image for f in futs]
    finally:
        srv.close()
    for got, want in zip(res["images"], ref):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=MESH_TOL / 255)
