"""The five per-layer metrics that read the program's own spans and
counts (``serve.queue``, ``serve.reply``, ``db.save``, ``char.jobs`` /
``char.attempts``, ``char.loop`` / ``final.loop`` / ``loop.steps``): a
tiny traced cell reports each, and running it leaves every file of the
benchmark as it was."""

import hashlib

import torch

from harness_tiny import make_root

from harness.main import run_cell

NEW = ("queue_wait_ms", "serve_reply_ms_per_wave", "db_write_ms_per_turn",
       "char_attempts_per_job", "step_host_ms")


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_program_span_metrics_in_a_traced_run(tmp_path):
    """A traced run of the tiny four-session cell: the queue wait and the
    reply time of its waves, its DB writes (the mix's first turns miss),
    one pass per job, and the loops' host time per step, each a value."""
    torch.set_num_threads(2)
    root = make_root(tmp_path)
    before = _digests(root)
    res = run_cell("tiny_serve4", 2 ** 31 + 12345, 0.0, True, device="cpu",
                   root=root)
    assert _digests(root) == before
    assert res["correct"], res["check"]
    got = {n: res["metrics"][n]["value"] for n in NEW}
    assert got["queue_wait_ms"] >= 0.0
    assert got["serve_reply_ms_per_wave"] > 0.0
    assert got["db_write_ms_per_turn"] > 0.0
    assert got["char_attempts_per_job"] >= 1.0
    assert got["step_host_ms"] > 0.0
    assert res["metrics"]["queue_wait_ms"]["unit"] == "ms"
    assert res["metrics"]["char_attempts_per_job"]["unit"] == "passes"
