"""OWL-ViT, the turn's second detector, on the CPU: the port's
``perception/owl.py`` against the JAX package's on the same weights
(``from_flax("owl")`` of a seeded JAX tree, the tiny config of
``tests/test_owl.py``), ``port_owl`` against transformers'
``OwlViTForObjectDetection``, ``load_bundle``'s choice between the two
detectors against the JAX package's, and the port's turn with OWL-ViT
(serial and batched) against the JAX turn run with a wrapper that turns
OWL's ``(box, confidence, ok)`` tuple into a ``Detection``: the bare JAX
backend makes the JAX turn raise (ROADMAP §3 item 3, pinned here).

Tolerances: the detector's boxes and logits within 1e-5 of the JAX
package's (fp32 on both sides, 2e-6 measured); against transformers 2e-5,
the JAX package's own bound (``tests/test_owl.py``).  The turns are held
to ``test_torch_port_turn.py``'s bounds, each confidence 1e-3 or more
from the 0.3 threshold so that no verdict can flip on rounding.
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.perception import detector as jdet
from theatergen_tpu.perception import owl as jowl
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch.models import export as TE
from theatergen_tpu_torch.models import weights as TW
from theatergen_tpu_torch.perception import gdino as tgd
from theatergen_tpu_torch.perception import owl as towl
from theatergen_tpu_torch.pipelines.bundle import init_bundle
from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.utils import tokenizer as ttok

import chip_smoke
import test_torch_port_gdino_turn as gdino_tests
import test_torch_port_turn as turn_tests
import test_torch_port_wave as wave_tests
import test_torch_port_weights as weight_tests
from test_torch_port_models import random_params

torch.set_num_threads(1)

TOL = 1e-5
CFG = towl.tiny_owl_config()
OWL_SEED = 3
D0 = wave_tests.D0


def _jax_cfgs(cfg=CFG):
    return (jcfg.CLIPVisionConfig(**dataclasses.asdict(cfg.vision)),
            jcfg.CLIPTextConfig(**dataclasses.asdict(cfg.text)))


@functools.lru_cache(maxsize=None)
def _pair():
    """The JAX OwlDetector and its seeded tree, and the port's detector on
    the same weights."""
    jv, jt = _jax_cfgs()
    det = jowl.OwlDetector(jv, jt)
    tree = random_params(det, OWL_SEED, jnp.zeros((1, 32, 32, 3)),
                         jnp.zeros((1, 16), jnp.int32))
    sd = TW.from_flax("owl", tree)
    model = towl.OwlDetector(CFG)
    TW.load_into(model, sd)
    return det, tree, model.eval(), sd


def _inputs(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    pix = rng.randn(batch, 32, 32, 3).astype(np.float32)
    ids = np.zeros((2, 16), np.int64)
    ids[0, :4] = [3, 17, 29, 999]
    ids[1, :6] = [5, 11, 7, 13, 2, 999]
    return pix, ids


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("n", [1, 4, 24])
def test_box_bias_matches(n):
    np.testing.assert_array_equal(towl.box_bias(n), jowl.box_bias(n))


def test_heads_match():
    """The box head (exact GELU) and the class head (the query normalised
    again, ``+1e-6``, the ELU(+1) scale) on the detector's own leaves."""
    det, tree, model, _ = _pair()
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 16, 32).astype(np.float32)
    queries = rng.randn(3, 32).astype(np.float32)
    jbox = jowl.OwlBoxHead().apply({"params": tree["box_head"]},
                                   jnp.asarray(feats))
    jlog, jce = jowl.OwlClassHead(32).apply(
        {"params": tree["class_head"]}, jnp.asarray(feats),
        jnp.asarray(queries))
    with torch.no_grad():
        tbox = model.box_head(_t(feats))
        tlog, tce = model.class_head(_t(feats), _t(queries))
    np.testing.assert_allclose(tbox.numpy(), np.asarray(jbox), atol=TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL)
    np.testing.assert_allclose(tce.numpy(), np.asarray(jce), atol=TOL)


def test_detector_matches_jax():
    """Boxes and logits of two images against two queries; the text
    queries and the class-token-merged image features too."""
    det, tree, model, _ = _pair()
    pix, ids = _inputs()
    jb, jl = det.apply({"params": tree}, jnp.asarray(pix), jnp.asarray(ids))
    jq = det.apply({"params": tree}, jnp.asarray(ids),
                   method=jowl.OwlDetector.text_queries)
    with torch.no_grad():
        tb, tl = model(_t(pix).permute(0, 3, 1, 2), _t(ids))
        tq = model.text_queries(_t(ids))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=TOL)
    assert tb.shape == (2, 16, 4) and tl.shape == (2, 16, 2)


@functools.lru_cache(maxsize=None)
def _backends(threshold: float = 0.3):
    det, tree, _, sd = _pair()
    tok = jtok.HashTokenizer(CFG.text.vocab_size)
    jb = jowl.OwlBackend(det, tree, tok, max_length=16,
                         box_threshold=threshold)
    tb = towl.OwlBackend(CFG, sd, ttok.HashTokenizer(CFG.text.vocab_size),
                         box_threshold=threshold, device="cpu")
    return jb, tb


@pytest.mark.parametrize("side", [32, 64, 48])
def test_backend_matches_jax(side):
    """``__call__`` (box, confidence, ok) and ``count_instances`` against
    the JAX backend's on images of several sides (the resize to 32² is
    ``jax.image.resize``'s antialiased bilinear); the threshold set at a
    quantile of the probabilities so that several boxes pass and NMS has
    work to do."""
    rng = np.random.RandomState(side)
    img = rng.rand(side, side, 3).astype(np.float32)
    jb0, _ = _backends()
    _, probs = jb0._detect(img, "a red knight")
    thr = float(np.quantile(probs, 0.5)) - 1e-3
    jb, tb = _backends(thr)
    for phrase in ("a red knight", "a green dragon"):
        jbox, jconf, jok = jb(img, phrase)
        tbox, tconf, tok = tb(img, phrase)
        np.testing.assert_allclose(tbox, jbox, atol=TOL)
        assert abs(tconf - jconf) <= TOL and tok == jok
        assert isinstance(tconf, float) and isinstance(tok, bool)
        assert tbox.shape == (4,)
        n = tb.count_instances(img, phrase)
        assert n == jb.count_instances(img, phrase) and n >= 1
        assert tb.count_instances(img, phrase, max_n=1) == 1
    _, tprobs = tb._detect(img, "a red knight")
    np.testing.assert_allclose(tprobs, probs, atol=TOL)


def test_backend_takes_a_tensor_and_refuses_a_missing_card():
    _, tb = _backends()
    img = np.random.RandomState(5).rand(40, 40, 3).astype(np.float32)
    a, b = tb(img, "a cat"), tb(torch.from_numpy(img), "a cat")
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            towl.OwlBackend(CFG, _pair()[3], tb.tokenizer)


# ------------------------------------------------------------ checkpoints


def _hf_pair():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.OwlViTConfig(
        text_config=dict(vocab_size=1000, hidden_size=32,
                         intermediate_size=64, num_hidden_layers=2,
                         num_attention_heads=2, max_position_embeddings=16),
        vision_config=dict(image_size=32, patch_size=8, hidden_size=32,
                           intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=2),
        projection_dim=32)
    torch.manual_seed(0)
    hf = transformers.OwlViTForObjectDetection(hf_cfg)
    with torch.no_grad():
        for p in hf.parameters():
            p.uniform_(-0.05, 0.05)
    return hf.eval()


def test_port_owl_against_transformers():
    """A transformers state dict loads strictly after port_owl (which
    drops the contrastive logit scale only), and the detector computes
    transformers' boxes (cxcywh → clipped xyxy) and logits."""
    hf = _hf_pair()
    sd = hf.state_dict()
    ported = TW.port_owl(sd)
    assert set(sd) - set(ported) == {"owlvit.logit_scale"}
    assert TW.owl_config_of(ported) == CFG
    model = TW.load_into(towl.OwlDetector(CFG), ported).eval()
    pix, ids = _inputs(batch=1)
    x = _t(pix).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        out = hf(input_ids=_t(ids), pixel_values=x)
        boxes, logits = model(x, _t(ids))
    cx, cy, w, h = out.pred_boxes.unbind(-1)
    ref = torch.clamp(torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                   cy + h / 2], -1), 0, 1)
    np.testing.assert_allclose(boxes.numpy(), ref.numpy(), atol=2e-5)
    np.testing.assert_allclose(logits.numpy(), out.logits.numpy(), atol=2e-5)


def test_owl_config_of_refuses_other_shapes():
    with pytest.raises(ValueError, match="owl.safetensors: its shapes"):
        TW.owl_config_of({"x": torch.zeros(1)})
    with torch.device("meta"):
        base = towl.OwlDetector(towl.owlvit_base_patch32()).state_dict()
    assert TW.owl_config_of(base) == towl.owlvit_base_patch32()


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vocab") / "gdino_vocab.txt")
    chip_smoke.synthetic_vocab(path, gdino_tests.PHRASE_WORDS,
                               tgd.tiny_gdino_config().bert.vocab_size)
    return path


def _owl_dir(tmp_path, name="owl"):
    """A directory holding only the owl.safetensors that
    ``export_checkpoint_dir`` writes for a tiny bundle with the port's
    OWL backend."""
    b = init_bundle(weight_tests.CFG, 0, device="cpu")
    b.detector = _backends()[1]
    d = tmp_path / name
    sizes = TE.export_checkpoint_dir(b, str(d))
    assert "owl.safetensors" in sizes
    for f in set(sizes) - {"owl.safetensors"}:
        os.remove(d / f)
    return str(d)


def test_load_bundle_loads_owl_as_the_jax_package_does(tmp_path, capsys):
    """owl.safetensors alone: an OwlBackend whose weights equal from_flax
    of the JAX package's loaded tree and the source, bit for bit; the
    file carries transformers' logit scale; the parts left random are
    printed as the JAX package prints them; the loaded detector detects
    as the source does."""
    d = _owl_dir(tmp_path)
    names = TW.load_safetensors(os.path.join(d, "owl.safetensors"))
    assert "owlvit.logit_scale" in names
    capsys.readouterr()
    tb = TW.load_bundle(weight_tests.CFG, d, device="cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    jb = weight_tests._jax_load(d)
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line == jax_line
    assert isinstance(tb.detector, towl.OwlBackend)
    assert isinstance(jb.detector, jowl.OwlBackend)
    assert tb.detector.cfg == CFG and tb.detector.max_length == 16
    got = tb.detector.model.state_dict()
    weight_tests._equal(got, TW.from_flax("owl", jb.detector.params))
    weight_tests._equal(got, _pair()[3])
    img = np.random.RandomState(0).rand(16, 16, 3).astype(np.float32)
    a, b = tb.detector(img, "a red knight"), _backends()[1](img,
                                                            "a red knight")
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]


@pytest.mark.parametrize("case", ["owl_alone", "gdino_wins",
                                  "owl_forced", "gdino_without_vocab"])
def test_load_bundle_chooses_the_detector_as_jax(tmp_path, monkeypatch,
                                                 vocab, case):
    """JAX ``weights.py:1252-1274``: OWL-ViT without a loadable
    GroundingDINO (none, or its file without the vocabulary), GroundingDINO
    beside it, OWL-ViT over it under THEATERGEN_DETECTOR=owl; the JAX
    package's load_bundle of the same directory picks the same kind."""
    d = _owl_dir(tmp_path)
    if case != "owl_alone":
        gd, _ = gdino_tests._detector_dir(tmp_path, vocab,
                                          with_vocab=case != "gdino_"
                                          "without_vocab")
        for f in os.listdir(gd):
            os.replace(os.path.join(gd, f), os.path.join(d, f))
    monkeypatch.delenv("THEATERGEN_DETECTOR", raising=False)
    if case == "owl_forced":
        monkeypatch.setenv("THEATERGEN_DETECTOR", "owl")
    want = towl.OwlBackend if case != "gdino_wins" else tgd.GroundingDinoBackend
    tb = TW.load_bundle(weight_tests.CFG, d, device="cpu")
    jb = weight_tests._jax_load(d)
    assert type(tb.detector) is want
    assert type(jb.detector).__name__ == want.__name__


# ------------------------------------------------------------------- turns


@pytest.fixture
def _jax_align_shifts_hw(monkeypatch):
    """test_torch_port_turn.py's patch of the JAX alignment (ROADMAP §3)."""
    monkeypatch.setattr(turn_tests.JL, "align_with_boxes",
                        turn_tests._align_hw(turn_tests.JL.align_with_boxes))


class JaxAsDetection:
    """The JAX OwlBackend with its tuple turned into a Detection, which
    the JAX turn reads (the bare backend makes it raise)."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, image, phrase):
        box, conf, ok = self.inner(image, phrase)
        return jdet.Detection(box=jnp.asarray(box),
                              confidence=jnp.asarray(conf, jnp.float32),
                              ok=jnp.asarray(ok))


def _with_owl(monkeypatch, jax_detector, record: bool = True):
    """test_torch_port_turn's bundles with the JAX detector ``jax_detector``
    and the port's bare OwlBackend, each wrapped in a recorder unless
    ``record`` is off."""
    jrec = (gdino_tests.Recorder(jax_detector, batched=False) if record
            else jax_detector)
    trec = TupleRecorder(_backends()[1]) if record else _backends()[1]
    jb, tb = turn_tests._bundles()
    pair = (dataclasses.replace(jb, detector=jrec),
            dataclasses.replace(tb, detector=trec))
    monkeypatch.setattr(turn_tests, "_bundles", lambda perception="": pair)
    return jrec, trec


class TupleRecorder:
    """Counts a tuple-answering detector's calls and records its
    confidences (no detect_batch: OWL-ViT sees one image at a time)."""

    def __init__(self, inner):
        self.inner, self.calls, self.conf = inner, 0, []

    def __call__(self, image, phrase):
        self.calls += 1
        out = self.inner(image, phrase)
        self.conf.append(out[1])
        return out


def test_serial_turn_with_owl_matches_jax(tmp_path, monkeypatch,
                                          _jax_align_shifts_hw):
    """dialogue_0's turn 1 (two characters) with OWL-ViT: the port's turn
    reads the bare backend's tuple, the JAX turn the wrapped one; images,
    masks and detections as test_torch_port_turn.py holds them, OWL called
    once per attempt on both sides, attention detection never."""
    jrec, trec = _with_owl(monkeypatch, JaxAsDetection(_backends()[0]))
    jt, tt, rec, noise = turn_tests._theaters(tmp_path, monkeypatch)
    gdino_tests._no_attention_detection(monkeypatch)
    seed = tgen.turn_seed(0, 0, 0, 0)
    jr = jt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    tr = tt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    turn_tests._compare(jr, tr, rec, noise, jt, tt, 2)
    counts = tt.timer.counts()
    assert trec.calls == jrec.calls == counts["char.detect"] \
        == counts["char.denoise_decode"]
    np.testing.assert_allclose(trec.conf, jrec.conf, atol=TOL)
    gdino_tests._margins_ok(trec)


def test_batched_turn_with_owl_matches_jax(tmp_path, monkeypatch,
                                           _jax_align_shifts_hw):
    """dialogue_0's turn 1 with ``batch_characters``: OWL-ViT has no
    detect_batch, so both turns detect one image at a time after the
    batched pass; images within IMG_TOL of the JAX Theater's, detections
    and DBs equal."""
    jrec, trec = _with_owl(monkeypatch, JaxAsDetection(_backends()[0]))
    (jt,), (tt,), noise = wave_tests._injected(tmp_path, monkeypatch, 1,
                                               batch_characters=True)
    gdino_tests._no_attention_detection(monkeypatch)
    seed = tgen.turn_seed(0, 0, 0, 0)
    jr = jt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    tr = tt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    wave_tests._same_turn(tr, jr, turn_tests.IMG_TOL)
    assert noise[0].n == noise[1].n
    assert trec.calls == jrec.calls >= 2
    np.testing.assert_allclose(trec.conf, jrec.conf, atol=TOL)
    gdino_tests._margins_ok(trec)
    wave_tests._same_db(tt.db.root, jt.db.root)


@pytest.mark.parametrize("batched", [False, True])
def test_the_jax_turn_raises_on_the_bare_owl_backend(tmp_path, monkeypatch,
                                                     batched):
    """ROADMAP §3 item 3, pinned: the JAX turn reads ``.ok`` on OWL's
    tuple (``theater.py:497-502`` serially, :632-633 batched) and raises
    AttributeError; the port's turn with the same backend runs."""
    _with_owl(monkeypatch, _backends()[0], record=False)
    if batched:
        (jt,), (tt,), _ = wave_tests._injected(tmp_path, monkeypatch, 1,
                                               batch_characters=True)
    else:
        jt, tt, _, _ = turn_tests._theaters(tmp_path, monkeypatch)
    seed = tgen.turn_seed(0, 0, 0, 0)
    with pytest.raises(AttributeError, match="'tuple' object has no "
                                             "attribute 'ok'"):
        jt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    tr = tt.run_turn(D0[0], seed, frozen_step_ratio=0.5)
    assert len(tr.so_images) == 2


def test_a_malformed_tuple_fails_the_turn(tmp_path, monkeypatch):
    """A tuple whose box is not ``[4]`` (or whose verdict is no bool)
    fails the turn, as a malformed Detection does."""
    for answer, err in (((np.zeros(3), 0.9, True), ValueError),
                        ((np.zeros(4), 0.9, 1.0), ValueError),
                        ((np.zeros(4), 0.9), TypeError)):
        th = gdino_tests._stub_theater(
            tmp_path / str(len(answer)) / str(err.__name__),
            lambda image, phrase, a=answer: a)
        with pytest.raises(err):
            th.run_turn(D0[0], tgen.turn_seed(0, 0, 0, 0),
                        frozen_step_ratio=0.5)
