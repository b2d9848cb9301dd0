"""GroundingDINO as the story turn's detector, on the CPU: the port's
``run_turn`` (serial, batched, and ``run_turn_wave``) with a tiny
``GroundingDinoBackend`` against the JAX package's with its backend on the
same tree; ``Bundle.detector`` read once per attempt, with no fallback to
attention detection; ``load_bundle`` of ``gdino.safetensors`` +
``gdino_vocab.txt`` against the JAX package's; a snapshot carries no
detector.

The turns are those of ``test_torch_port_turn.py`` and
``test_torch_port_wave.py`` (tiny SD1.5 bundles, 4 DDIM steps, numpy noise
injected at the method level in the JAX package's order) with a detector
added to both bundles, so they are held to the same bounds: images within
``IMG_TOL``, masks and detections equal.  Each detection's confidence is
asserted to lie 1e-3 or more from the 0.3 threshold, so that the verdicts
cannot flip on rounding.
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import theater as jth
from theatergen_tpu.perception import detector as jdet
from theatergen_tpu.perception import gdino as jgd
from theatergen_tpu_torch import db as tdb
from theatergen_tpu_torch import theater as tth
from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.models import export as TE
from theatergen_tpu_torch.models import snapshot as TS
from theatergen_tpu_torch.models import weights as TW
from theatergen_tpu_torch.perception import detector as tdet
from theatergen_tpu_torch.perception import gdino as tgd
from theatergen_tpu_torch.pipelines.bundle import init_bundle

import chip_smoke
import test_torch_port_turn as turn_tests
import test_torch_port_wave as wave_tests
import test_torch_port_weights as weight_tests
from test_torch_port_models import random_params

torch.set_num_threads(1)

IMG_TOL = turn_tests.IMG_TOL
BATCH_TOL = wave_tests.BATCH_TOL
THRESHOLD_MARGIN = 1e-3
D0, D1 = wave_tests.D0, wave_tests.D1
PHRASE_WORDS = ("a", "an", "red", "knight", "green", "dragon", "orange",
                "cat", "white", "dog", "sleeping")
DETECTOR_SEED = 30


@pytest.fixture(autouse=True)
def _jax_align_shifts_hw(monkeypatch):
    """test_torch_port_turn.py's patch of the JAX alignment (ROADMAP §3)."""
    monkeypatch.setattr(turn_tests.JL, "align_with_boxes",
                        turn_tests._align_hw(turn_tests.JL.align_with_boxes))


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vocab") / "gdino_vocab.txt")
    chip_smoke.synthetic_vocab(path, PHRASE_WORDS,
                               tgd.tiny_gdino_config().bert.vocab_size)
    return path


@functools.lru_cache(maxsize=None)
def _detectors(vocab: str):
    """The JAX backend and the port's on one seeded tiny tree."""
    jcfg = jgd.tiny_gdino_config()
    ids = np.array([[101, 1030, 102]], np.int64)
    mask, pos = jgd.prepare_text_inputs(ids)
    tree = random_params(jgd.GroundingDinoForDetection(jcfg), DETECTOR_SEED,
                         jnp.zeros((1, 64, 64, 3)), ids, mask, pos)
    jback = jgd.GroundingDinoBackend(jcfg, tree, jgd.WordPieceTokenizer(vocab))
    tback = tgd.GroundingDinoBackend(
        tgd.tiny_gdino_config(), TW.from_flax("gdino", tree),
        tgd.WordPieceTokenizer(vocab), device="cpu")
    return jback, tback


class Recorder:
    """Wraps a backend: counts calls and batches, records confidences."""

    def __init__(self, inner, batched: bool = True):
        self.inner, self.calls, self.batches, self.conf = inner, 0, 0, []
        if batched:
            self.detect_batch = self._detect_batch

    def __call__(self, image, phrase):
        self.calls += 1
        d = self.inner(image, phrase)
        self.conf.append(float(np.asarray(d.confidence)))
        return d

    def _detect_batch(self, images, phrases):
        self.batches += 1
        d = self.inner.detect_batch(images, phrases)
        self.conf += [float(c) for c in np.asarray(
            d.confidence.cpu() if torch.is_tensor(d.confidence)
            else d.confidence)]
        return d


def _with_detectors(monkeypatch, vocab, batched: bool = True):
    """Route test_torch_port_turn's bundles through recorders of the two
    backends; returns (JAX recorder, port recorder)."""
    jback, tback = _detectors(vocab)
    jrec, trec = Recorder(jback, batched), Recorder(tback, batched)
    jb, tb = turn_tests._bundles()
    pair = (dataclasses.replace(jb, detector=jrec),
            dataclasses.replace(tb, detector=trec))
    monkeypatch.setattr(turn_tests, "_bundles", lambda perception="": pair)
    return jrec, trec


def _no_attention_detection(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("attention detection ran beside a detector")

    monkeypatch.setattr(tth.det, "attention_detect", boom)
    monkeypatch.setattr(tth.det, "attention_detect_batch", boom)


def _margins_ok(*recs):
    for rec in recs:
        assert rec.conf and all(abs(c - 0.3) > THRESHOLD_MARGIN
                                for c in rec.conf), rec.conf


# -------------------------------------------------- against the JAX package


def test_serial_turn_with_the_detector_matches_jax(tmp_path, monkeypatch,
                                                   vocab):
    """dialogue_0's turn 1 (two characters) through both Theaters with a
    GroundingDINO detector: images, masks and detections as
    test_torch_port_turn.py holds them, the detector called once per
    character attempt on both sides, attention detection never."""
    jrec, trec = _with_detectors(monkeypatch, vocab)
    jt, tt, rec, noise = turn_tests._theaters(tmp_path, monkeypatch)
    _no_attention_detection(monkeypatch)
    seed = tgen.turn_seed(0, 0, 0, 0)
    jr = jt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    tr = tt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    turn_tests._compare(jr, tr, rec, noise, jt, tt, 2)
    counts = tt.timer.counts()
    assert trec.calls == jrec.calls == counts["char.detect"] \
        == counts["char.denoise_decode"]
    assert trec.batches == jrec.batches == 0
    np.testing.assert_allclose(trec.conf, jrec.conf, atol=1e-5)
    _margins_ok(trec)


def test_batched_turn_with_the_detector_matches_jax(tmp_path, monkeypatch,
                                                    vocab):
    """dialogue_0's turn 1 with ``batch_characters``: one ``detect_batch``
    for the character batch, images within IMG_TOL of the JAX Theater's
    and detections equal; a character that is not found rejoins the serial
    loop, whose attempts call the detector one image at a time."""
    jrec, trec = _with_detectors(monkeypatch, vocab)
    (jt,), (tt,), noise = wave_tests._injected(tmp_path, monkeypatch, 1,
                                               batch_characters=True)
    _no_attention_detection(monkeypatch)
    seed = tgen.turn_seed(0, 0, 0, 0)
    jr = jt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    tr = tt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    wave_tests._same_turn(tr, jr, IMG_TOL)
    assert noise[0].n == noise[1].n
    assert trec.batches == jrec.batches == 1
    assert trec.calls == jrec.calls
    assert turn_tests._jax_counts(tt.timer) == {
        k: len(v) for k, v in jt.timer.samples.items()}
    assert turn_tests._port_counts(tt.timer) == turn_tests._port_want(
        jt, tt, jobs=2, batches=1)
    np.testing.assert_allclose(trec.conf, jrec.conf, atol=1e-5)
    _margins_ok(trec)
    wave_tests._same_db(tt.db.root, jt.db.root)


def test_wave_with_the_detector(tmp_path, monkeypatch, vocab):
    """One run_turn_wave of dialogue_0's turn 2 and dialogue_1's turn 1
    (one character each, on fresh DBs) with the detector: against the JAX package's wave (injected noise, IMG_TOL) and
    against the port's own serial turns (BATCH_TOL, the batch changing the
    UNet's summation order only); the wave detects its characters with
    one detect_batch and keeps its DB writes."""
    jrec, trec = _with_detectors(monkeypatch, vocab)
    jts, tts, noise = wave_tests._injected(tmp_path / "inj", monkeypatch, 2)
    specs = [D0[1], D1[0]]
    seeds = [tgen.turn_seed(0, 0, 1, 0), tgen.turn_seed(0, 1, 0, 0)]
    jw = jth.run_turn_wave(jts, specs, seeds, frozen_step_ratio=0.5)
    tw = tth.run_turn_wave(tts, specs, seeds, frozen_step_ratio=0.5)
    for tr, jr in zip(tw, jw):
        wave_tests._same_turn(tr, jr, IMG_TOL)
    assert trec.batches == jrec.batches >= 1
    for tt, jt in zip(tts, jts):
        wave_tests._same_db(tt.db.root, jt.db.root)
    _margins_ok(trec)

    # the port's wave against its own serial turns, nothing injected
    monkeypatch.undo()
    _with_detectors(monkeypatch, vocab)
    _, tb = turn_tests._bundles()
    waves = [tth.Theater(tb, tdb.CharacterDB(str(tmp_path / f"w{i}")),
                         num_steps=turn_tests.STEPS) for i in range(2)]
    serial = [tth.Theater(tb, tdb.CharacterDB(str(tmp_path / f"s{i}")),
                          num_steps=turn_tests.STEPS) for i in range(2)]
    tw = tth.run_turn_wave(waves, specs, seeds, frozen_step_ratio=0.5)
    for th, sp, sd, wr in zip(serial, specs, seeds, tw):
        wave_tests._same_turn(wr, th.run_turn(sp, sd, frozen_step_ratio=0.5),
                              BATCH_TOL)
        assert all(th.db.has(i) for i in sp["obj_ids"])


# ------------------------------------------------ Bundle.detector, stubbed


class StubDetector:
    """Answers from ``verdicts`` in turn (True: found), counting calls."""

    def __init__(self, verdicts, raises=None):
        self.verdicts, self.raises, self.calls = list(verdicts), raises, []

    def __call__(self, image, phrase):
        self.calls.append(phrase)
        if self.raises is not None:
            raise self.raises
        ok = self.verdicts.pop(0)
        return tdet.Detection(box=torch.tensor([0.1, 0.2, 0.6, 0.9]),
                              confidence=torch.tensor(0.9 if ok else 0.1),
                              ok=torch.tensor(ok))


def _stub_theater(tmp_path, detector, **kw):
    _, tb = turn_tests._bundles()
    return tth.Theater(dataclasses.replace(tb, detector=detector),
                       tdb.CharacterDB(str(tmp_path / "db")),
                       num_steps=turn_tests.STEPS, **kw)


def test_the_turn_reads_bundle_detector(tmp_path, monkeypatch):
    """Turn 2 of dialogue_0 (one character): a stub that answers "not
    found" twice, then "found", is called once per attempt, three
    attempts, with the character's phrase, and attention detection never
    runs."""
    stub = StubDetector([False, False, True])
    th = _stub_theater(tmp_path, stub)
    _no_attention_detection(monkeypatch)
    res = th.run_turn(D0[1], 5)
    counts = th.timer.counts()
    assert stub.calls == ["a red knight"] * 3
    assert counts["char.denoise_decode"] == counts["char.detect"] == 3
    assert res.detections == [True]


def test_a_failing_detector_fails_the_turn(tmp_path, monkeypatch):
    """A detector that raises, or answers with a malformed Detection, fails
    the turn in the serial and the batched path; nothing falls back to
    attention detection."""
    _no_attention_detection(monkeypatch)
    th = _stub_theater(tmp_path / "a", StubDetector(
        [], raises=RuntimeError("detector down")))
    with pytest.raises(RuntimeError, match="detector down"):
        th.run_turn(D0[1], 5)

    class Malformed(StubDetector):
        def __call__(self, image, phrase):
            d = super().__call__(image, phrase)
            return dataclasses.replace(d, box=d.box[:2])

    th = _stub_theater(tmp_path / "b", Malformed([True]))
    with pytest.raises(ValueError, match="malformed"):
        th.run_turn(D0[1], 5)
    th = _stub_theater(tmp_path / "c", lambda image, phrase: (0.1, True))
    with pytest.raises(TypeError, match="not a Detection"):
        th.run_turn(D0[1], 5)
    th = _stub_theater(tmp_path / "d", StubDetector(
        [], raises=RuntimeError("batch down")), batch_characters=True)
    with pytest.raises(RuntimeError, match="batch down"):
        th.run_turn(D0[0], 5)


def test_batched_turn_without_detect_batch(tmp_path, monkeypatch):
    """A detector without detect_batch sees the batch one image at a time
    (JAX theater.py:629-633): turn 1's two characters, the first found,
    the second not and then found in its serial rejoin (attempt 0 again,
    then attempt 1): four calls, the masks from the stub's box."""
    stub = StubDetector([True, False, False, True])
    th = _stub_theater(tmp_path, stub, batch_characters=True)
    _no_attention_detection(monkeypatch)
    res = th.run_turn(D0[0], 5)
    first, second = stub.calls[:2]
    assert {first, second} == {"a red knight", "a green dragon"}
    assert stub.calls == [first, second, second, second]
    assert res.detections == [True, True]
    assert th.timer.counts()["char.detect"] == 4


def test_wave_rollback_holds_with_the_detector(tmp_path, monkeypatch):
    """A wave whose characters pass the detector's detect_batch and whose
    batched final pass then dies leaves no deferred and no flushed DB
    write (test_torch_port_wave.py's rollback, with a detector)."""
    class Batched(StubDetector):
        def detect_batch(self, images, phrases):
            self.calls += list(phrases)
            n = len(phrases)
            return tdet.Detection(box=torch.tensor([[0.1, 0.2, 0.6, 0.9]] * n),
                                  confidence=torch.full((n,), 0.9),
                                  ok=torch.ones(n, dtype=torch.bool))

    def boom(_th):
        raise RuntimeError("injected final-pass failure")

    stub = Batched([])
    _, tb = turn_tests._bundles()
    bundle = dataclasses.replace(tb, detector=stub)
    ths = [tth.Theater(bundle, tdb.CharacterDB(str(tmp_path / f"d{i}")),
                       num_steps=turn_tests.STEPS) for i in range(2)]
    _no_attention_detection(monkeypatch)
    monkeypatch.setattr(tth, "_wave_final_runner", boom)
    with pytest.raises(tth.WaveFailure, match="injected") as ei:
        tth.run_turn_wave(ths, [D0[0], D1[0]], [0, 1])
    assert ei.value.results == {}
    assert len(stub.calls) == 3          # one batch: the wave's characters
    for th, sp in zip(ths, [D0[0], D1[0]]):
        assert not th._pending_saves
        assert not any(th.db.has(i) for i in sp["obj_ids"])


# ------------------------------------------------------------------ weights


def _detector_dir(tmp_path, vocab, with_vocab=True):
    """A checkpoint directory of ``export_checkpoint_dir`` of a tiny bundle
    with the port's detector, every file but gdino.safetensors
    (transformers' names, with the tied box-head copies and the Swin index
    buffers) and, with ``with_vocab``, gdino_vocab.txt removed."""
    _, tback = _detectors(vocab)
    b = init_bundle(weight_tests.CFG, 0, device="cpu")
    b.detector = tback
    d = tmp_path / "gd"
    sizes = TE.export_checkpoint_dir(b, str(d))
    assert {"gdino.safetensors", "gdino_vocab.txt"} <= set(sizes)
    keep = {"gdino.safetensors"} | ({"gdino_vocab.txt"} if with_vocab
                                    else set())
    for f in set(sizes) - keep:
        os.remove(d / f)
    return str(d), tback


def test_load_bundle_loads_the_detector(tmp_path, capsys, vocab):
    """gdino.safetensors + gdino_vocab.txt: the port's detector is a
    GroundingDinoBackend on the bundle's device whose weights equal
    from_flax of the JAX package's loaded tree and the source, bit for
    bit; its last printed line (the parts left random) equals the JAX
    package's; the loaded detector detects as the source does."""
    d, src = _detector_dir(tmp_path, vocab)
    names = TW.load_safetensors(os.path.join(d, "gdino.safetensors"))
    assert "bbox_embed.1.layers.0.weight" in names
    assert any(k.endswith("relative_position_index") for k in names)
    capsys.readouterr()
    tb = TW.load_bundle(weight_tests.CFG, d, device="cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    jb = weight_tests._jax_load(d)
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line == jax_line
    assert isinstance(tb.detector, tgd.GroundingDinoBackend)
    assert isinstance(jb.detector, jgd.GroundingDinoBackend)
    assert tb.detector.cfg == tgd.tiny_gdino_config()
    assert next(tb.detector.model.parameters()).device == tb.device
    got = tb.detector.model.state_dict()
    weight_tests._equal(got, TW.from_flax("gdino", jb.detector.params))
    weight_tests._equal(got, src.model.state_dict())
    img = np.random.RandomState(0).rand(16, 16, 3).astype(np.float32)
    a, b = tb.detector(img, "a red knight"), src(img, "a red knight")
    assert torch.equal(a.box, b.box) and torch.equal(a.confidence,
                                                     b.confidence)


def test_load_bundle_skips_the_detector_without_its_vocabulary(
        tmp_path, capsys, vocab):
    d, _ = _detector_dir(tmp_path, vocab, with_vocab=False)
    capsys.readouterr()
    tb = TW.load_bundle(weight_tests.CFG, d, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert any("gdino.safetensors without gdino_vocab.txt" in line
               for line in out)
    jb = weight_tests._jax_load(d)
    assert out[-1] == capsys.readouterr().out.strip().splitlines()[-1]
    assert tb.detector is None and jb.detector is None


def test_owl_is_refused_where_the_jax_package_would_load_it(
        tmp_path, monkeypatch, vocab):
    """Beside a loadable GroundingDINO the JAX package ignores
    owl.safetensors, unless THEATERGEN_DETECTOR=owl forces it: the port
    loads GroundingDINO there, and reads the OWL-ViT file where the JAX
    package would load it, refusing one whose shapes are no OWL-ViT's
    (the choice on real OWL-ViT files: test_torch_port_owl.py)."""
    d, _ = _detector_dir(tmp_path, vocab)
    TW.save_safetensors(os.path.join(d, "owl.safetensors"),
                        {"x": torch.zeros(1)})
    monkeypatch.delenv("THEATERGEN_DETECTOR", raising=False)
    tb = TW.load_bundle(weight_tests.CFG, d, device="cpu")
    assert isinstance(tb.detector, tgd.GroundingDinoBackend)
    monkeypatch.setenv("THEATERGEN_DETECTOR", "owl")
    with pytest.raises(ValueError, match=r"owl.safetensors: its shapes"):
        TW.load_bundle(weight_tests.CFG, d, device="cpu")
    os.remove(os.path.join(d, "gdino_vocab.txt"))
    monkeypatch.delenv("THEATERGEN_DETECTOR")
    with pytest.raises(ValueError, match=r"owl.safetensors: its shapes"):
        TW.load_bundle(weight_tests.CFG, d, device="cpu")


def test_cli_weights_with_the_detector(tmp_path, monkeypatch, vocab):
    """dialogue_0 through the CLI with ``--weights`` of a directory holding
    only gdino.safetensors and gdino_vocab.txt (what chip_smoke.py's
    gdino_path runs at full size), serial and with ``--batch_chars``: the
    detector answers every ``char.detect`` of the run log (one
    ``detect_batch`` per turn with two distinct characters), attention
    detection never runs, every turn is written."""
    import json

    d, _ = _detector_dir(tmp_path, vocab)
    seen = {"call": 0, "batch": 0}
    real_call = tgd.GroundingDinoBackend.__call__
    real_batch = tgd.GroundingDinoBackend.detect_batch

    def call(self, image, phrase):
        seen["call"] += 1
        return real_call(self, image, phrase)

    def batch(self, images, phrases):
        seen["batch"] += 1
        return real_batch(self, images, phrases)

    monkeypatch.setattr(tgd.GroundingDinoBackend, "__call__", call)
    monkeypatch.setattr(tgd.GroundingDinoBackend, "detect_batch", batch)
    _no_attention_detection(monkeypatch)
    for flags, want_batches in (([], 0), (["--batch_chars"], 2)):
        seen.update(call=0, batch=0)
        root = tmp_path / ("batch" if flags else "serial")
        tgen.main(["--tiny", "--device", "cpu", "--dataset_path",
                   str(turn_tests.DATA), "--max_dialogues", "1",
                   "--num_steps", "2", "--base_save_dir", str(root / "out"),
                   "--database_path_base", str(root / "db"), "--weights", d,
                   *flags])
        log = root / "out" / "story" / "run0" / "run_log.jsonl"
        events = [json.loads(line) for line in log.read_text().splitlines()]
        (dialogue,) = [e for e in events if e["event"] == "dialogue"]
        assert len([e for e in events if e["event"] == "turn"]) == 4
        detects = dialogue["phase_summary"]["char.detect"]["count"]
        assert seen["batch"] == want_batches
        # one detection per character attempt, or per batch: 6 or 4 at least
        assert seen["call"] + seen["batch"] == detects >= 6 - want_batches


def test_a_snapshot_carries_no_detector(tmp_path, vocab):
    """As in the JAX package (its snapshot's PARAM_FIELDS hold no
    detector): a bundle with GroundingDINO saves and reloads without it."""
    from theatergen_tpu.models import snapshot as JS

    _, tback = _detectors(vocab)
    b = init_bundle(weight_tests.CFG, 0, device="cpu")
    b.detector = tback
    TS.save_bundle_snapshot(b, str(tmp_path / "snap"))
    back = TS.load_bundle_snapshot(weight_tests.CFG, str(tmp_path / "snap"),
                                   device="cpu")
    assert back.detector is None
    assert "detector" not in TS.MODULE_FIELDS
    assert not any("detector" in f for f in JS.PARAM_FIELDS)


def test_detect_from_attention_and_sam_matches_jax():
    """Attention detection refined by a segmenter's box prompt: the box
    the port hands the segmenter, and the detection and mask it returns,
    equal the JAX package's."""
    rng = np.random.RandomState(2)
    maps = [rng.rand(2, 64).astype(np.float32),
            rng.rand(2, 16).astype(np.float32)]
    seen = {}

    def segment(key):
        def fn(image, box):
            seen[key] = np.asarray(box.cpu() if torch.is_tensor(box)
                                   else box)
            m = np.zeros((1, 8, 8), np.float32)
            m[0, 2:5, 1:6] = 1
            return (torch.from_numpy(m) if key == "port" else jnp.asarray(
                m)), None
        return fn

    jd, jm = jdet.detect_from_attention_and_sam(
        [jnp.asarray(m) for m in maps], None, segment("jax"),
        jnp.zeros((8, 8, 3)))
    td, tm = tdet.detect_from_attention_and_sam(
        [torch.from_numpy(m) for m in maps], None, segment("port"),
        torch.zeros(8, 8, 3))
    np.testing.assert_allclose(seen["port"], seen["jax"], atol=1e-6)
    np.testing.assert_allclose(td.box.numpy(), np.asarray(jd.box),
                               atol=1e-6)
    assert bool(td.ok) == bool(jd.ok)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    d, m = tdet.detect_from_attention_and_sam(
        [torch.from_numpy(m) for m in maps], None)
    assert m is None and torch.equal(d.box, td.box)
