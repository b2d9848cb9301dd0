"""The batched turn (``Theater(batch_characters=True)``), dialogue waves
(``run_turn_wave``) and the CLI's ``--batch_chars`` and ``--dp_dialogues``
on the CPU: the port against the JAX package (tests/test_theater.py:386-655
and tests/test_sdxl.py:176 hold the JAX package's batched paths to its
serial one) and against its own serial turn.

Against the JAX package both sides run the tiny bundles of
``test_torch_port_turn.py`` (fp32, 4 DDIM steps) and take their starting
latents from one numpy stream per side, drawn in the JAX package's order:
the JAX Theaters' ``_char_lat_fn`` and ``sd.seeded_latents``, the port's
``_char_input_latents`` and ``_bg_latents``.  Against the port's own
serial turn nothing is injected: the port's per-character streams make
the batched turn draw what the serial one draws, under DDIM and
Euler-Ancestral, guided and not, on SD1.5 and the tiny SDXL bundle.  The
failure cases mirror the JAX package's: a wave that dies leaves no DB
write behind, hands over the turns its serial fallback finished, and the
serial rerun equals a clean run.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import db as jdb
from theatergen_tpu import theater as jth
from theatergen_tpu.ops import latents as JL
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu_torch import db as tdb
from theatergen_tpu_torch import theater as tth
from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.ops import latents as TL
from theatergen_tpu_torch.utils import png

import test_torch_port_turn as turn_tests

torch.set_num_threads(1)

CFG = turn_tests.CFG
PL = CFG.pipeline
h = w = PL.latent_height
STEPS = turn_tests.STEPS
# against the JAX package: test_torch_port_turn.py's image bound (fp32
# through both passes, the same injected noise)
IMG_TOL = turn_tests.IMG_TOL
# batched against serial, as the JAX tests hold the JAX package: the
# batch changes the UNet's summation order only
BATCH_TOL = 2e-3
SPEC_DUP = {
    "prompt": "a cat sits beside a sleeping cat",
    "gen_boxes": [("a cat", (50, 100, 120, 120)),
                  ("a sleeping cat", (300, 100, 120, 120))],
    "bg_prompt": "a sunny room", "extra_neg_prompt": "",
    "obj_ids": [7, 7], "canvas_height": 512, "canvas_width": 512,
}


@pytest.fixture(autouse=True)
def _jax_align_shifts_hw(monkeypatch):
    monkeypatch.setattr(JL, "align_with_boxes",
                        turn_tests._align_hw(JL.align_with_boxes))


def _specs(dialogue: str):
    data = json.loads((turn_tests.DATA / "story.json").read_text())[dialogue]
    out = []
    for t_idx in range(4):
        spec = tgen.build_spec(data[f"turn {t_idx + 1}"])
        spec["canvas_height"] = spec["canvas_width"] = 512
        out.append(spec)
    return out


D0, D1 = _specs("dialogue_0"), _specs("dialogue_1")


def _sampler_bundle(tb, kind: str):
    return dataclasses.replace(tb, cfg=dataclasses.replace(
        tb.cfg, pipeline=dataclasses.replace(tb.cfg.pipeline,
                                             scheduler_type=kind)))


def _injected(tmp_path, monkeypatch, n: int, **kw):
    """``n`` JAX Theaters and ``n`` port Theaters (settings ``kw``) on
    fresh DBs, each side drawing its starting latents from one numpy
    stream (test_torch_port_turn.py's ``Noise``), the JAX composition
    eager (that file's note on the jitted collage)."""
    jb, tb = turn_tests._bundles()
    jn, tn = turn_tests.Noise(), turn_tests.Noise()

    def jlat(r0, r1, bx):
        return JL.input_latents_for_boxes(
            None, None, bx, h, w, fg_blending_ratio=PL.fg_blending_ratio,
            init_noise_sigma=1.0, bg_noise=jn.draw((1, h, w, 4)),
            fg_noise=jn.draw((1, 1, h, w, 4)))[0][0]

    def tlat(gen, centered):
        return TL.input_latents_for_boxes(
            None, centered[None], h, w,
            fg_blending_ratio=PL.fg_blending_ratio, init_noise_sigma=1.0,
            bg_noise=torch.from_numpy(tn.draw((1, h, w, 4))),
            fg_noise=torch.from_numpy(tn.draw((1, 1, h, w, 4))))[0][0]

    def compose_eager(*a):
        with jax.disable_jit():
            return jth._compose_program(jb.lineart)(*a)

    monkeypatch.setitem(jb._jits, f"theater_compose_{id(jb.lineart)}",
                        compose_eager)
    monkeypatch.setattr(jsd, "seeded_latents",
                        lambda rng, b, hh, ww, c=4, dtype=None: jnp.asarray(
                            jn.draw((b, hh, ww, c))))
    jts, tts = [], []
    for i in range(n):
        jt = jth.Theater(jb, jdb.CharacterDB(str(tmp_path / f"j{i}")),
                         num_steps=STEPS, **kw)
        jt._char_lat_fn = lambda: jlat
        tt = tth.Theater(tb, tdb.CharacterDB(str(tmp_path / f"t{i}")),
                         num_steps=STEPS, **kw)
        tt._char_input_latents = tlat
        tt._bg_latents = lambda gen: torch.from_numpy(tn.draw((1, h, w, 4)))
        jts.append(jt)
        tts.append(tt)
    return jts, tts, (jn, tn)


def _same_turn(tr, jr, tol: float):
    """Image, character images, collage within ``tol``; detections equal."""
    assert tr.detections == list(jr.detections)
    np.testing.assert_allclose(tr.image, np.asarray(jr.image), atol=tol)
    np.testing.assert_allclose(tr.collage, np.asarray(jr.collage), atol=tol)
    assert len(tr.so_images) == len(jr.so_images)
    for a, b in zip(tr.so_images, jr.so_images):
        np.testing.assert_allclose(a, np.asarray(b), atol=tol)


def _same_db(tdir, jdir):
    """The same ids, images within one 8-bit step, features 1e-4."""
    def ids(d):
        return sorted(int(f[:-4]) for f in os.listdir(d) if f.endswith(".png"))
    assert ids(tdir) == ids(jdir)
    for oid in ids(jdir):
        ji, je, _ = jdb.CharacterDB(jdir).lookup(oid)
        ti, te, _ = tdb.CharacterDB(tdir).lookup(oid)
        np.testing.assert_allclose(ti, ji, atol=1 / 255 + 1e-6)
        np.testing.assert_allclose(np.ravel(te), np.ravel(je), atol=1e-4)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


def test_batched_turn_matches_jax(tmp_path, monkeypatch):
    """dialogue_0's turns 1 and 4 (two characters each: two misses, then a
    hit beside a miss) through both Theaters with ``batch_characters``:
    images within IMG_TOL, detections, DB hits and DB entries as the JAX
    Theater's, one batched character pass per turn, the same draws on both
    sides.  (The guided batch is held to the JAX package at the runner,
    test_torch_port_batched.py, and to the serial turn below.)"""
    jts, tts, noise = _injected(tmp_path, monkeypatch, 1,
                                batch_characters=True)
    (jt,), (tt,) = jts, tts
    ratio = 0.5
    for t_idx, hits in ((0, [False, False]), (3, [True, False])):
        seed = tgen.turn_seed(0, 0, t_idx, 0)
        before = tt.timer.counts().get("char.denoise_decode", 0)
        jr = jt.run_turn(D0[t_idx], seed, frozen_step_ratio=ratio)
        tr = tt.run_turn(D0[t_idx], seed, frozen_step_ratio=ratio)
        assert tr.db_hits == hits
        assert tt.timer.counts()["char.denoise_decode"] - before == 1
        _same_turn(tr, jr, IMG_TOL)
        assert noise[0].n == noise[1].n
    assert turn_tests._jax_counts(tt.timer) == {
        k: len(v) for k, v in jt.timer.samples.items()}
    # two turns of two jobs, each one batched pass (no rerun) and one
    # final pass; three DB misses
    steps = 2 * (tt.char_sched.num_steps + tt.final_sched.num_steps)
    assert turn_tests._port_counts(tt.timer) == {
        "char.jobs": 4, "char.attempts": 4, "char.loop": 2,
        "char.decode": 2, "final.loop": 2, "db.save": 3, "loop.steps": steps}
    _same_db(tt.db.root, jt.db.root)


def test_run_turn_wave_matches_jax(tmp_path, monkeypatch):
    """A wave of three dialogues (dialogue_0 turn 1, dialogue_1 turn 1 and
    a repeated-id turn that runs serially inside the wave) and then their
    second turns (hits), through both packages' run_turn_wave: each turn
    within IMG_TOL of the JAX wave's, DB entries alike, the same draws."""
    jts, tts, noise = _injected(tmp_path, monkeypatch, 3)
    for t_idx in range(2):
        specs = [D0[t_idx], D1[t_idx], SPEC_DUP]
        seeds = [tgen.turn_seed(0, d, t_idx, 0) for d in range(3)]
        jw = jth.run_turn_wave(jts, specs, seeds, frozen_step_ratio=0.5)
        tw = tth.run_turn_wave(tts, specs, seeds, frozen_step_ratio=0.5)
        assert len(tw) == 3
        for tr, jr in zip(tw, jw):
            _same_turn(tr, jr, IMG_TOL)
        assert noise[0].n == noise[1].n
    assert [r.db_hits for r in tw] == [[True], [False, True], [True, True]]
    for tt, jt in zip(tts, jts):
        _same_db(tt.db.root, jt.db.root)


# ---------------------------------------------------------------------------
# against the port's serial turn
# ---------------------------------------------------------------------------


def _xl_bundle():
    import test_torch_port_xl_turn as xl_tests
    return xl_tests._bundles()[1]


CASES = {"ddim": dict(), "euler_ancestral": dict(kind="euler_ancestral"),
         "guided": dict(guided=True), "xl": dict(xl=True)}


def _theater(tmp_path, name, kind=None, xl=False, **kw):
    tb = _xl_bundle() if xl else turn_tests._bundles()[1]
    if kind:
        tb = _sampler_bundle(tb, kind)
    return tth.Theater(tb, tdb.CharacterDB(str(tmp_path / name)),
                       num_steps=STEPS, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_batched_turn_and_wave_match_serial(tmp_path, case):
    """The port's batched turn (dialogue_0 turn 1: two characters) and a
    wave of dialogue_0 and dialogue_1's first turns against the serial
    turns of the same seeds, with the port's own streams: images and
    character images within BATCH_TOL, detections and DB hits equal.
    Cases: DDIM, Euler-Ancestral (per-element noise streams), guided
    (frozen_step_ratio 0) and the tiny SDXL bundle (micro-conditioning
    and the T2I-Adapter batched, Euler-Ancestral)."""
    kw = CASES[case]
    guided = kw.get("guided", False)
    ratio = 0.0 if guided else 0.5
    seeds = [tgen.turn_seed(0, d, 0, 0) for d in range(2)]
    serial = [_theater(tmp_path, f"s{d}", **kw).run_turn(
        spec, seeds[d], frozen_step_ratio=ratio)
        for d, spec in enumerate((D0[0], D1[0]))]
    batched = _theater(tmp_path, "b", batch_characters=True, **kw)
    got = batched.run_turn(D0[0], seeds[0], frozen_step_ratio=ratio)
    assert batched.timer.counts()["char.denoise_decode"] == 1
    ths = [_theater(tmp_path, f"w{d}", **kw) for d in range(2)]
    wave = tth.run_turn_wave(ths, [D0[0], D1[0]], seeds,
                             frozen_step_ratio=ratio)
    for tr, ref in ((got, serial[0]), (wave[0], serial[0]),
                    (wave[1], serial[1])):
        _same_turn(tr, ref, BATCH_TOL)
        assert tr.db_hits == ref.db_hits
    assert ths[0].timer.counts()["final"] == 1
    assert "final" not in ths[1].timer.counts()


def test_batch_rejoins_the_serial_loop_on_a_failed_detection(tmp_path,
                                                             monkeypatch):
    """A batched character whose detection fails reruns in the serial loop
    from attempt 0 of its own streams: with the batch's verdict for the
    first character forced to fail, the turn equals the serial turn within
    BATCH_TOL and ran two character passes (the batch, then that
    character's attempt 0 in the loop)."""
    real = tth.det.attention_detect_batch

    def first_fails(maps):
        d = real(maps)
        d.ok = d.ok.clone()
        d.ok[0] = False
        return d

    seed = tgen.turn_seed(0, 0, 0, 0)
    ref = _theater(tmp_path, "s").run_turn(D0[0], seed)
    monkeypatch.setattr(tth.det, "attention_detect_batch", first_fails)
    th = _theater(tmp_path, "b", batch_characters=True)
    got = th.run_turn(D0[0], seed)
    assert th.timer.counts()["char.denoise_decode"] == 2
    _same_turn(got, ref, BATCH_TOL)


def test_repeated_ids_and_lone_characters_run_serially(tmp_path):
    """The batched mode takes two or more unique characters of distinct
    ids: a turn of one character, and a turn whose two characters share an
    id (the second is the first's DB hit), run the serial loop."""
    th = _theater(tmp_path, "b", batch_characters=True)
    th.run_turn(D0[1], 1)
    res = th.run_turn(SPEC_DUP, 2)
    assert res.db_hits == [False, True]
    assert th.timer.counts()["char.denoise_decode"] == 3


# ---------------------------------------------------------------------------
# failures (tests/test_theater.py's wave failure cases)
# ---------------------------------------------------------------------------


def _clean_run(tmp_path, name, spec, seed):
    return _theater(tmp_path, name).run_turn(spec, seed)


def test_wave_failure_clears_pending_saves(tmp_path, monkeypatch):
    """A wave that dies after its character batch (in the batched final
    pass) leaves no deferred and no flushed DB write, and raises a
    WaveFailure with no finished turn; the serial rerun then equals a
    clean run."""
    def boom(_th):
        raise RuntimeError("injected final-pass failure")

    monkeypatch.setattr(tth, "_wave_final_runner", boom)
    ths = [_theater(tmp_path, f"f{i}") for i in range(2)]
    with pytest.raises(tth.WaveFailure, match="injected") as ei:
        tth.run_turn_wave(ths, [D0[0], D0[1]], [0, 1])
    assert ei.value.results == {}
    for th, sp in zip(ths, [D0[0], D0[1]]):
        assert not th._pending_saves
        assert not any(th.db.has(i) for i in sp["obj_ids"])
    monkeypatch.undo()
    rerun = ths[0].run_turn(D0[0], 0)
    np.testing.assert_array_equal(rerun.image,
                                  _clean_run(tmp_path, "c", D0[0], 0).image)


def test_wave_failure_carries_serial_fallback_results(tmp_path, monkeypatch):
    """A dialogue that finished through the wave's serial fallback (repeated
    ids) survives a failure of the batch: WaveFailure carries its result,
    its DB writes stay, and the batched dialogue's are rolled back."""
    def boom(_th):
        raise RuntimeError("injected batch failure")

    monkeypatch.setattr(tth, "_wave_final_runner", boom)
    ths = [_theater(tmp_path, f"p{i}") for i in range(2)]
    with pytest.raises(tth.WaveFailure) as ei:
        tth.run_turn_wave(ths, [SPEC_DUP, D0[0]], [0, 1])
    assert list(ei.value.results) == [0]
    assert np.isfinite(ei.value.results[0].image).all()
    assert not ths[1]._pending_saves
    assert not any(ths[1].db.has(i) for i in D0[0]["obj_ids"])
    assert ths[0].db.has(7)


def test_wave_serial_fallback_failure_rolls_back_db(tmp_path):
    """The wave's serial fallback failing after run_turn's ``finally``
    flushed its DB writes: those first appearances are deleted (they never
    enter the batch's jobs), and the rerun equals a clean run."""
    ths = [_theater(tmp_path, f"g{i}") for i in range(2)]

    def boom(*a, **k):
        assert ths[0]._pending_saves
        raise RuntimeError("injected fallback failure")

    ths[0]._final_stage = boom
    with pytest.raises(tth.WaveFailure) as ei:
        tth.run_turn_wave(ths, [SPEC_DUP, D0[0]], [0, 1])
    assert not ei.value.results
    assert not ths[0].db.has(7)
    del ths[0].__dict__["_final_stage"]
    rerun = ths[0].run_turn(SPEC_DUP, 0)
    np.testing.assert_array_equal(
        rerun.image, _clean_run(tmp_path, "gc", SPEC_DUP, 0).image)


def test_wave_failure_after_db_flush_rolls_back(tmp_path, monkeypatch):
    """A device fault of the batched final pass surfaces when its images
    are fetched, after the deferred DB writes were flushed: those writes
    are deleted, and the rerun equals a clean run."""
    ths = [_theater(tmp_path, f"h{i}") for i in range(2)]
    real = tth._to_host

    def boom_after_flush(images):
        if ths[0].db.has(D0[0]["obj_ids"][0]):
            raise RuntimeError("injected post-flush failure")
        return real(images)

    monkeypatch.setattr(tth, "_to_host", boom_after_flush)
    with pytest.raises(tth.WaveFailure, match="post-flush"):
        tth.run_turn_wave(ths, [D0[0], D0[1]], [0, 1])
    monkeypatch.undo()
    for th, sp in zip(ths, [D0[0], D0[1]]):
        assert not th._pending_saves
        assert not any(th.db.has(i) for i in sp["obj_ids"])
    rerun = ths[0].run_turn(D0[0], 0)
    np.testing.assert_array_equal(rerun.image,
                                  _clean_run(tmp_path, "hc", D0[0], 0).image)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(root, *extra):
    return ["--tiny", "--device", "cpu", "--dataset_path",
            str(turn_tests.DATA), "--num_steps", "2",
            "--base_save_dir", str(root / "out"),
            "--database_path_base", str(root / "db"), *extra]


def _events(root):
    path = root / "out" / "story" / "run0" / "run_log.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def _pngs(root):
    return {str(p.relative_to(root / "out")): png.read_png(str(p))
            for p in sorted((root / "out").rglob("*.png"))}


def test_cli_batch_chars_and_waves_match_serial(tmp_path):
    """Both dialogues of data/sample through the CLI serially, with
    ``--batch_chars`` and with ``--dp_dialogues 2``: the same output tree,
    the same seeds, DB hits and detections in the log, every PNG within
    one 8-bit step (plus BATCH_TOL) of the serial run's; the wave run logs
    a ``wave`` event and a summary of two dialogues; a second wave run
    writes nothing (resume by existence)."""
    runs = {}
    for name, flags in (("serial", []), ("batch", ["--batch_chars"]),
                        ("wave", ["--dp_dialogues", "2"])):
        tgen.main(_cli(tmp_path / name, *flags))
        runs[name] = _pngs(tmp_path / name)
    # per dialogue 4 turn images and 6 character images
    assert len(runs["serial"]) == 20
    for name in ("batch", "wave"):
        assert runs[name].keys() == runs["serial"].keys()
        for key, img in runs[name].items():
            diff = np.abs(img.astype(int) - runs["serial"][key].astype(int))
            assert diff.max() <= 1 + 255 * BATCH_TOL, key

    def turns(name):
        return sorted((e["dialogue"], e["turn"], e["seed"], e["db_hits"],
                       tuple(e["detections"]))
                      for e in _events(tmp_path / name)
                      if e["event"] == "turn")
    assert turns("batch") == turns("serial") == turns("wave")
    events = _events(tmp_path / "wave")
    (wave,) = [e for e in events if e["event"] == "wave"]
    assert wave["dialogues"] == ["dialogue_0", "dialogue_1"]
    assert events[-1]["event"] == "summary"
    assert events[-1]["dialogues"] == 2
    mtimes = {p: p.stat().st_mtime_ns
              for p in (tmp_path / "wave" / "out").rglob("*.png")}
    tgen.main(_cli(tmp_path / "wave", "--dp_dialogues", "2"))
    assert {p: p.stat().st_mtime_ns
            for p in (tmp_path / "wave" / "out").rglob("*.png")} == mtimes
    assert [e["event"] for e in _events(tmp_path / "wave")[len(events):]] \
        == ["wave", "summary"]


def test_cli_wave_quarantine(tmp_path, monkeypatch):
    """A wave whose batch fails reruns its turns serially with the same
    seeds; a turn that fails there too is logged as quarantined and leaves
    no directory, and the other dialogue's turn and the next turns run."""
    real_wave, real_turn = tth.run_turn_wave, tth.Theater.run_turn

    def wave(theaters, specs, *a, **k):
        if any(sp["prompt"].startswith("the red knight") for sp in specs):
            raise tth.WaveFailure({}, RuntimeError("injected wave failure"))
        return real_wave(theaters, specs, *a, **k)

    def run_turn(self, spec, seed, **kw):
        if spec["prompt"].startswith("the red knight"):
            raise RuntimeError("boom")
        return real_turn(self, spec, seed, **kw)

    monkeypatch.setattr(tth, "run_turn_wave", wave)
    monkeypatch.setattr(tth.Theater, "run_turn", run_turn)
    tgen.main(_cli(tmp_path, "--dp_dialogues", "2"))
    run = tmp_path / "out" / "story" / "run0"
    assert not (run / "dialogue_0" / "turn 2").exists()
    assert (run / "dialogue_1" / "turn 2").exists()
    assert (run / "dialogue_0" / "turn 3").exists()
    events = _events(tmp_path)
    (q,) = [e for e in events if e["event"] == "quarantine"]
    assert q["dialogue"] == "dialogue_0" and q["turn"] == "turn 2"
    assert "boom" in q["error"]
    assert len([e for e in events if e["event"] == "turn"]) == 7


def test_cli_mesh_still_raises(tmp_path):
    """Waves over a mesh run (``test_torch_port_mesh_cli.py``); a mesh
    larger than the host can start still raises, with the JAX CLI's
    message, before anything is written."""
    with pytest.raises(SystemExit, match="needs 100000 devices"):
        tgen.main(_cli(tmp_path, "--dp_dialogues", "2", "--mesh",
                       "dp=100000"))
    assert not (tmp_path / "out").exists()
