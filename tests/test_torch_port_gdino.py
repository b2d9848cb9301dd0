"""The port's GroundingDINO (``perception/{bert,swin,gdino}.py``) against the
JAX package's, module by module and whole, on the CPU in fp32.

The JAX side is the JAX package's own modules applied to a tree whose every
leaf is drawn from a numpy seed (``random_params``: the zero-initialised
relative-position bias tables and the fusion layers' 1e-4 layer scales are
drawn too, so they carry values that matter); the port side loads
``from_flax("gdino", tree)`` with ``strict=True``.  Two configs:
``tiny_gdino_config()`` (64 px: patch grid 16, a multiple of window 4) and
``odd`` (68 px: grid 17, padded to 20 under window 4, merged with a pad to
9, extra level 5).  Tolerances: 3e-5 abs for the static geometry and the
single modules (fp32 summation order only); 2e-4 abs and 1e-3 rel for the
whole detector's logits and boxes, with the ``-inf`` mask equal (the bounds
of tests/test_gdino.py's transformers golden); 1e-5 for the backend's box
and confidence.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu.models import weights as JW
from theatergen_tpu.perception import bert as jbert
from theatergen_tpu.perception import gdino as jgd
from theatergen_tpu.perception import swin as jswin
from theatergen_tpu_torch.models import weights as TW
from theatergen_tpu_torch.perception import bert as tbert
from theatergen_tpu_torch.perception import gdino as tgd
from theatergen_tpu_torch.perception import swin as tswin

from test_torch_port_models import random_params

torch.set_num_threads(1)

MODULE_TOL = 3e-5
FWD_ATOL, FWD_RTOL = 2e-4, 1e-3
BACKEND_TOL = 1e-5
# "[CLS] w w . w w w . [SEP]" over the tiny vocabulary, then padding
INPUT_IDS = np.array([[101, 5, 6, 1012, 7, 8, 9, 1012, 102, 0, 0],
                      [101, 11, 12, 13, 1012, 102, 0, 0, 0, 0, 0]], np.int64)


def _variant(mod, **kw):
    """``mod``'s tiny config at ``image_size`` (the Swin's too) and the
    other fields of ``kw``."""
    cfg = mod.tiny_gdino_config()
    if "image_size" in kw:
        kw["swin"] = dataclasses.replace(cfg.swin,
                                         image_size=kw["image_size"])
    return dataclasses.replace(cfg, **kw)


CONFIGS = {"tiny": {}, "odd": dict(image_size=68)}


def _text(ids=INPUT_IDS):
    mask, pos = jgd.prepare_text_inputs(ids)
    return ids, mask, pos, ids != 0


def _pixels(size, seed, b=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, size, size, 3) * 0.5).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@functools.lru_cache(maxsize=None)
def _pair(name: str, seed: int = 0):
    """(JAX config, port config, JAX tree, port module) of a config on the
    same seeded leaves."""
    jcfg, tcfg = _variant(jgd, **CONFIGS[name]), _variant(tgd, **CONFIGS[name])
    ids, mask, pos, tok = _text()
    tree = random_params(jgd.GroundingDinoForDetection(jcfg), seed,
                         jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3)),
                         ids[:1], mask[:1], pos[:1], text_token_mask=tok[:1])
    model = tgd.GroundingDinoForDetection(tcfg).eval()
    TW.load_into(model, TW.from_flax("gdino", tree))
    return jcfg, tcfg, tree, model


def _jax(module, tree, *args, **kw):
    """``module.apply`` of ``tree``, jitted (eager, each op compiles on its
    first shape: several times slower for one call)."""
    return jax.jit(lambda p, a, k: module.apply({"params": p}, *a, **k))(
        tree, args, kw)


def _sub(model, prefix):
    """The submodule of ``model`` at the dotted ``prefix``."""
    return model.get_submodule(prefix)


# ---------------------------------------------------------------- host side


def test_text_inputs_match_jax():
    """prepare_text_inputs exactly, over delimiters at the ends, in the
    middle, twice in a row, and padding."""
    ids = np.array([[101, 5, 1012, 1029, 6, 102, 0, 0],
                    [101, 5, 6, 7, 8, 9, 10, 102],
                    [1012, 5, 6, 1012, 7, 102, 0, 0]], np.int64)
    for a, b in zip(jgd.prepare_text_inputs(ids),
                    tgd.prepare_text_inputs(ids)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_tokenizer_matches_jax(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".", ",", "a", "cat",
             "knight", "drag", "##on", "fore", "##st", "in", "the"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    ours, theirs = tgd.WordPieceTokenizer(str(path)), \
        jgd.WordPieceTokenizer(str(path))
    for text in ["a cat.", "A DRAGON in the forest.", "the knight,",
                 "zebra.", "", "dragonforest"]:
        assert ours.encode(text) == theirs.encode(text), text


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_static_geometry_matches_jax(name):
    """Level shapes, the sine grid, the encoder's reference points and the
    proposals (the same numpy code: equal), and get_sine_pos_embed (torch
    against jnp) within MODULE_TOL."""
    jcfg, tcfg = _variant(jgd, **CONFIGS[name]), _variant(tgd, **CONFIGS[name])
    shapes = tcfg.level_shapes
    assert shapes == jcfg.level_shapes
    assert shapes == {"tiny": ((16, 16), (8, 8), (4, 4)),
                      "odd": ((17, 17), (9, 9), (5, 5))}[name]
    full = tgd.GroundingDinoConfig().level_shapes
    assert full == jgd.GroundingDinoConfig().level_shapes == (
        (100, 100), (50, 50), (25, 25), (13, 13))
    for h, w in shapes + ((3, 5),):
        np.testing.assert_array_equal(
            tgd.sine_position_2d(h, w, 32, 20.0),
            jgd.sine_position_2d(h, w, 32, 20.0))
    np.testing.assert_array_equal(tgd.encoder_reference_points(full),
                                  jgd.encoder_reference_points(full))
    for a, b in zip(tgd.output_proposals(full), jgd.output_proposals(full)):
        np.testing.assert_array_equal(a, b)
    assert not tgd.output_proposals(full)[1].all()   # invalid border rows
    rng = np.random.RandomState(3)
    for shape, feats, xy in (((2, 7, 4), 16, True), ((2, 11, 1), 32, False)):
        pos = rng.rand(*shape).astype(np.float32) * 5
        np.testing.assert_allclose(
            _np(tgd.get_sine_pos_embed(_t(pos), feats, exchange_xy=xy)),
            np.asarray(jgd.get_sine_pos_embed(jnp.asarray(pos), feats,
                                              exchange_xy=xy)),
            atol=MODULE_TOL)


def test_ms_deform_attention_matches_jax():
    """grid_sample against the JAX four-corner gather, with sampling
    locations out of the map on every side (zero padding)."""
    shapes = ((6, 5), (3, 3), (2, 1))
    rng = np.random.RandomState(4)
    b, q, heads, d, points = 2, 7, 3, 4, 4
    value = rng.randn(b, sum(h * w for h, w in shapes), heads, d).astype(
        np.float32)
    locs = rng.uniform(-0.2, 1.2, (b, q, heads, len(shapes), points, 2)
                       ).astype(np.float32)
    aw = rng.rand(b, q, heads, len(shapes), points).astype(np.float32)
    aw /= aw.sum((-1, -2), keepdims=True)
    got = tgd.ms_deform_attention(_t(value), shapes, _t(locs), _t(aw))
    want = jgd.ms_deform_attention(jnp.asarray(value), shapes,
                                   jnp.asarray(locs), jnp.asarray(aw))
    assert tuple(got.shape) == (b, q, heads * d)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODULE_TOL)


def test_multihead_attention_matches_jax():
    """The text enhancer's attention with an additive block mask."""
    jcfg, tcfg, tree, model = _pair("tiny")
    sub = tree["encoder_layers_0"]["text_enhancer_layer"]["self_attn"]
    rng = np.random.RandomState(5)
    x = rng.randn(2, 11, tcfg.d_model).astype(np.float32)
    kv = rng.randn(2, 11, tcfg.d_model).astype(np.float32)
    mask = ((1.0 - _text()[1][:, None].astype(np.float32))
            * np.finfo(np.float32).min)
    want = _jax(jgd.MultiheadAttention(jcfg.d_model, 2), sub, x, x, kv,
                mask)
    got = _sub(model, "model.encoder.layers.0.text_enhancer_layer.self_attn")(
        _t(x), _t(x), _t(kv), _t(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODULE_TOL)


def _bi_inputs(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    d = 32
    vision = rng.randn(2, 40, d).astype(np.float32)
    vision[1] *= scale
    text = rng.randn(2, 11, d).astype(np.float32)
    return vision, text, ~_text()[3]


@pytest.mark.parametrize("case", ["plain", "clamp"])
def test_bimultihead_attention_matches_jax(case):
    """BiMultiHeadAttention, the text padding masked; in ``clamp`` the
    vision projection is scaled by 1e5 and the second image's features by
    1e-4, so that after the one maximum over the whole tensor (batch
    included) the second image's logits all fall below -50 000 and clamp:
    a per-row maximum would give them another softmax."""
    jcfg, tcfg, tree, model = _pair("tiny")
    sub = dict(tree["encoder_layers_0"]["fusion_layer"]["attn"])
    vision, text, pad = _bi_inputs(6, 1e-4 if case == "clamp" else 1.0)
    mod = _sub(model, "model.encoder.layers.0.fusion_layer.attn")
    if case == "clamp":
        sub["vision_proj"] = {k: v * 1e5 for k, v in
                              sub["vision_proj"].items()}
        mod = tgd.BiMultiHeadAttention(tcfg).eval()
        TW.load_into(mod, {k.split("attn.", 1)[1]: v for k, v in
                           TW.from_flax("gdino", {"encoder_layers_0": {
                               "fusion_layer": {"attn": sub}}}).items()})
        heads = tcfg.encoder_attention_heads // 2
        hd = (tcfg.encoder_ffn_dim // 2) // heads

        def proj(x, name):
            y = x @ np.asarray(sub[name]["kernel"]) + np.asarray(
                sub[name]["bias"])
            return y.reshape(*x.shape[:2], heads, hd)
        logits = np.einsum("bvhc,bthc->bhvt",
                           proj(vision, "vision_proj") * hd ** -0.5,
                           proj(text, "text_proj"))
        shifted = logits - logits.max()
        assert shifted[1].max() < -50000          # all of image 2 clamps
        assert (shifted[0] > -50000).any()
    want = _jax(jgd.BiMultiHeadAttention(jcfg), sub, vision, text, pad)
    got = mod(_t(vision), _t(text), _t(pad))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w),
                                   atol=MODULE_TOL * max(
                                       1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_swin_backbone_matches_jax(name):
    """Every emitted stage; at ``odd`` each block pads 17 → 20 and 9 → 12
    under window 4 (the shift mask on the padded grid) and the merge pads
    17 → 18."""
    jcfg, tcfg, tree, model = _pair(name)
    pixels = _pixels(jcfg.image_size, 7)
    want = _jax(jswin.SwinBackbone(jcfg.swin), tree["backbone"], pixels)
    got = _sub(model, "model.backbone.conv_encoder.model")(_t(pixels))
    assert [tuple(g.shape[1:3]) for g in got] == \
        [s for s in tcfg.level_shapes[:len(got)]]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=MODULE_TOL)


def test_bert_text_encoder_matches_jax():
    """The 3-D block mask and the per-phrase position ids of
    prepare_text_inputs; and a 2-D mask without position ids."""
    jcfg, tcfg, tree, model = _pair("tiny")
    ids, mask, pos, tok = _text()
    enc = jbert.BertTextEncoder(jcfg.bert)
    port = _sub(model, "model.text_backbone")
    for args in ((mask, None, pos), (tok, None, None)):
        want = _jax(enc, tree["text_backbone"], ids, *args)
        got = port(_t(ids), *(None if a is None else _t(a) for a in args))
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   atol=MODULE_TOL)
    assert isinstance(port, tbert.BertTextEncoder)


# ------------------------------------------------------------ the detector


def _spy_topk(monkeypatch):
    """Record the scores and indices of both packages' top-k."""
    seen = {"jax": [], "port": []}
    real_j, real_t = jax.lax.top_k, torch.topk

    def record(x, idx):
        seen["jax"].append((np.asarray(x), np.asarray(idx)))

    def jspy(x, k):
        out = real_j(x, k)
        jax.debug.callback(record, x, out[1])      # runs under jit too
        return out

    def tspy(x, k, dim=-1, **kw):
        out = real_t(x, k, dim=dim, **kw)
        seen["port"].append((_np(x), _np(out.indices)))
        return out

    monkeypatch.setattr(jax.lax, "top_k", jspy)
    monkeypatch.setattr(tgd.torch, "topk", tspy)
    return seen


def _forward_both(jcfg, tree, model, pixels, ids=INPUT_IDS):
    _, mask, pos, tok = _text(ids)
    jl, jb = _jax(jgd.GroundingDinoForDetection(jcfg), tree, pixels, ids,
                  mask, pos, text_token_mask=tok)
    with torch.no_grad():
        tl, tb = model(_t(pixels), _t(ids), _t(mask), _t(pos),
                       text_token_mask=_t(tok))
    return (np.asarray(jl), np.asarray(jb)), (_np(tl), _np(tb))


def _same_detections(jax_out, port_out):
    (jl, jb), (tl, tb) = jax_out, port_out
    finite = np.isfinite(jl)
    np.testing.assert_array_equal(np.isfinite(tl), finite)
    np.testing.assert_allclose(tl[finite], jl[finite], atol=FWD_ATOL,
                               rtol=FWD_RTOL)
    np.testing.assert_allclose(tb, jb, atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_detector_matches_jax(name, monkeypatch):
    """The whole forward on two images with two phrases: logits with the
    ``-inf`` columns equal, boxes, and the two-stage query selection's
    indices exactly, on a well-conditioned case (the gap between rank Q
    and rank Q+1 of the JAX scores is over 100× the tolerance)."""
    jcfg, tcfg, tree, model = _pair(name)
    seen = _spy_topk(monkeypatch)
    # pixel seed 15: rank Q and Q+1 of both images 0.206 and 0.233 apart
    # at tiny and odd
    jax_out, port_out = _forward_both(jcfg, tree, model,
                                      _pixels(jcfg.image_size, 15))
    assert port_out[0].shape == (2, tcfg.num_queries, tcfg.max_text_len)
    _same_detections(jax_out, port_out)
    (jscores, jidx), = seen["jax"]
    (_, tidx), = seen["port"]
    q = tcfg.num_queries
    ranked = -np.sort(-jscores, axis=-1)
    assert (ranked[:, q - 1] - ranked[:, q]).min() > 100 * FWD_ATOL
    np.testing.assert_array_equal(tidx, jidx)


def test_query_selection_with_ties(monkeypatch):
    """Eight feature levels at 64 px (16², 8², 4², 2², then four 1² levels,
    d_model 64 so that no GroupNorm group holds one value): the proposals
    of levels 5-7 (width 0.05·2^lvl > 0.99) are invalid, their coordinate
    logits ``+inf`` and their features zero, so their scores tie exactly.
    On this seed the tie group takes ranks 4-6 and Q is 6: two of the three
    are selected.  The two packages may pick different members, but the
    gathered rows are equal, and so are the outputs.  The consecutive gaps
    of the ranking down to the group's end are over 10× the largest
    difference between the two packages' scores."""
    kw = dict(num_feature_levels=8, d_model=64)
    jcfg, tcfg = _variant(jgd, **kw), _variant(tgd, **kw)
    ids = INPUT_IDS[:1]
    _, mask, pos, tok = _text(ids)
    tree = random_params(jgd.GroundingDinoForDetection(jcfg), 22,
                         jnp.zeros((1, 64, 64, 3)), ids, mask, pos,
                         text_token_mask=tok)
    valid = jgd.output_proposals(jcfg.level_shapes)[1]
    assert (~valid).sum() == 3 and not valid[-3:].any()
    q = 6
    tree = dict(tree, query_position_embeddings=tree[
        "query_position_embeddings"][:q])
    jcfg, tcfg = (dataclasses.replace(c, num_queries=q) for c in (jcfg,
                                                                  tcfg))
    model = tgd.GroundingDinoForDetection(tcfg).eval()
    TW.load_into(model, TW.from_flax("gdino", tree))
    seen = _spy_topk(monkeypatch)
    jax_out, port_out = _forward_both(jcfg, tree, model,
                                      _pixels(64, 4, b=1), ids)
    _same_detections(jax_out, port_out)
    (jscores, jidx), = seen["jax"]
    (tscores, tidx), = seen["port"]
    scores = jscores[0]
    tie = scores[~valid]
    assert (tie == tie[0]).all() and (tscores[0][~valid] == tscores[0][
        ~valid][0]).all()
    ranked = -np.sort(-scores)
    assert [int(np.sum(ranked > t)) for t in tie] == [4] * 3  # ranks 4-6
    gaps = -np.diff(ranked[:8])
    gaps = gaps[gaps > 0]
    assert len(gaps) == 5
    assert gaps.min() > 10 * np.abs(tscores - jscores).max()
    np.testing.assert_array_equal(tidx[0][:4], jidx[0][:4])
    assert not valid[tidx[0][4:]].any() and not valid[jidx[0][4:]].any()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_from_flax_covers_the_module(name):
    """from_flax gives every key of the port's module, no other, at its
    shape; the module loads it strictly."""
    _, tcfg, tree, _ = _pair(name)
    sd = TW.from_flax("gdino", tree)
    ref = tgd.GroundingDinoForDetection(tcfg).state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    tgd.GroundingDinoForDetection(tcfg).load_state_dict(
        {k: _t(v) for k, v in sd.items()}, strict=True)
    assert TW.gdino_config_of(sd) == tgd.tiny_gdino_config()


def test_full_width_detector_shapes():
    """grounding-dino-tiny on the meta device: ~172 M parameters, the
    config that gdino_config_of gives for its shapes."""
    with torch.device("meta"):
        m = tgd.GroundingDinoForDetection(tgd.GroundingDinoConfig())
    n = sum(p.numel() for p in m.parameters())
    assert 170e6 < n < 175e6
    sd = m.state_dict()
    assert TW.gdino_config_of(sd) == tgd.GroundingDinoConfig()
    with pytest.raises(ValueError, match="shapes"):
        TW.gdino_config_of({k: v for k, v in sd.items()
                            if "level_embed" not in k})


# ------------------------------------------------------ transformers' names


@pytest.fixture(scope="module")
def hf_model():
    pytest.importorskip("transformers")
    from test_gdino import torch_tiny_gdino

    return torch_tiny_gdino()


def test_port_grounding_dino_matches_jax(hf_model):
    """transformers' tiny model → the port's port_grounding_dino equals the
    JAX package's port_grounding_dino + from_flax, entry for entry, and
    loads strictly; an entry the module lacks is refused."""
    sd = hf_model.state_dict()
    got = TW.port_grounding_dino(sd)
    want = TW.from_flax("gdino", JW.port_grounding_dino(
        {k: v.numpy() for k, v in sd.items()}))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    model = tgd.GroundingDinoForDetection(tgd.tiny_gdino_config())
    TW.load_into(model, got)
    bad = dict(got, **{"model.text_backbone.pooler.dense.weight":
                       torch.zeros(2, 2)})
    with pytest.raises(KeyError, match="pooler"):
        TW.load_into(model, TW.port_grounding_dino(bad))


def test_detector_matches_transformers(hf_model):
    """The port's forward on transformers' tiny weights against
    transformers' own (tests/test_gdino.py's golden, here for the port)."""
    model = tgd.GroundingDinoForDetection(tgd.tiny_gdino_config()).eval()
    TW.load_into(model, TW.port_grounding_dino(hf_model.state_dict()))
    ids = INPUT_IDS[:1, :9]
    pixels = _pixels(64, 2, b=1)
    with torch.no_grad():
        ref = hf_model(pixel_values=_t(pixels.transpose(0, 3, 1, 2)),
                       input_ids=_t(ids))
        _, mask, pos, tok = _text(ids)
        logits, boxes = model(_t(pixels), _t(ids), _t(mask), _t(pos),
                              text_token_mask=_t(tok))
    _same_detections((ref.logits.numpy(), ref.pred_boxes.numpy()),
                     (_np(logits), _np(boxes)))


# ----------------------------------------------------------------- backend


def _vocab(tmp_path):
    vocab = ["[PAD]"] + [f"t{i}" for i in range(1, 100)] + [
        "[UNK]", "[CLS]", "[SEP]"]
    vocab += [f"u{i}" for i in range(len(vocab), 1012)] + ["."] + \
        [f"v{i}" for i in range(1013, 1029)] + ["?"]
    vocab += ["cat", "dog", "knight", "red", "a"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n")
    return str(path)


LONG = "a red knight " * 6 + "cat"   # 19 word tokens: truncated at 16


@pytest.fixture(scope="module")
def backends(tmp_path_factory):
    vocab = _vocab(tmp_path_factory.mktemp("vocab"))
    jcfg, tcfg, tree, model = _pair("tiny", 1)
    jb = jgd.GroundingDinoBackend(jcfg, tree, jgd.WordPieceTokenizer(vocab))
    tb = tgd.GroundingDinoBackend(tcfg, model.state_dict(),
                                  tgd.WordPieceTokenizer(vocab), device="cpu")
    return jb, tb


def _same(a, b, tol=BACKEND_TOL):
    np.testing.assert_allclose(_np(a.box), np.asarray(b.box), atol=tol)
    np.testing.assert_allclose(_np(a.confidence), np.asarray(b.confidence),
                               atol=tol)
    np.testing.assert_array_equal(_np(a.ok), np.asarray(b.ok))


def test_backend_matches_jax(backends):
    """Single and batched detection against the JAX backend (images of
    48² resized to 64², and one of the model's side), over a one-word
    phrase, two words and a phrase truncated at 16 tokens (no [SEP]); box,
    confidence and ok within BACKEND_TOL; the port's batch equals its own
    serial calls."""
    jb, tb = backends
    rng = np.random.RandomState(12)
    images = rng.rand(3, 48, 48, 3).astype(np.float32)
    phrases = ["cat", "red dog", LONG]
    assert len(tb._encode_text(LONG)[0][0]) == 16
    assert tb._encode_text(LONG)[0][0][-1] != 102
    serial = []
    for img, ph in zip(images, phrases):
        d = tb(img, ph)
        assert tuple(d.box.shape) == (4,) and d.ok.dtype == torch.bool
        _same(d, jb(jnp.asarray(img), ph))
        serial.append(d)
    same_side = rng.rand(64, 64, 3).astype(np.float32)
    _same(tb(same_side, "cat"), jb(jnp.asarray(same_side), "cat"))
    batch = tb.detect_batch(_t(images), phrases)
    assert tuple(batch.box.shape) == (3, 4)
    _same(batch, jb.detect_batch(jnp.asarray(images), phrases))
    for i, d in enumerate(serial):
        np.testing.assert_allclose(_np(batch.box[i]), _np(d.box),
                                   atol=BACKEND_TOL)
        np.testing.assert_allclose(float(batch.confidence[i]),
                                   float(d.confidence), atol=BACKEND_TOL)
        assert bool(batch.ok[i]) == bool(d.ok)
    with pytest.raises(ValueError, match="phrases"):
        tb.detect_batch(_t(images), phrases[:2])


def test_backend_needs_the_card_unless_asked(backends, monkeypatch):
    _, tb = backends
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgd.GroundingDinoBackend(tb.cfg, tb.model.state_dict(), tb.tokenizer)


def test_swin_and_bert_modules_are_the_ports():
    """The three modules import nothing of JAX (tests/test_torch_port_rules
    checks it in a fresh interpreter) and keep their own copies of the
    configs."""
    assert tswin.SwinConfig() == tswin.SwinConfig(**dataclasses.asdict(
        jswin.SwinConfig()))
    assert tbert.BertConfig() == tbert.BertConfig(**dataclasses.asdict(
        jbert.BertConfig()))
