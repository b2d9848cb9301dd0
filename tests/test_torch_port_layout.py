"""The stage-one layout utilities and the small helpers the port had left
out, against their JAX twins on the CPU.

``utils/layout.py`` and ``utils/cache.py`` are host code: they take the
inputs of ``tests/test_layout.py`` and ``tests/test_utils.py::
test_query_cache_roundtrip`` on both packages and must give equal
results.  The helpers (``sd.encode_image``, ``sam.segment_with_boxes`` and
``segment_with_box_legacy``, ``geometry.box_iou``,
``SamHF``'s ``embed_points``, ``scheduler.pred_original``,
``PhaseTimer.report``, the embedding store's ``keys``/``__len__``) run
fp32 at the tiny sizes on seeded numpy inputs.  Each test states its
bound.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.ops import geometry as JG
from theatergen_tpu.ops import scheduler as jsched
from theatergen_tpu.perception import sam as JSM
from theatergen_tpu.perception import sam_hf as JHF
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu.runtime import store as jstore
from theatergen_tpu.utils import cache as jcache
from theatergen_tpu.utils import layout as JL
from theatergen_tpu.utils import profiling as jprof
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.ops import geometry as TG
from theatergen_tpu_torch.ops import scheduler as tsched
from theatergen_tpu_torch.perception import sam as TSM
from theatergen_tpu_torch.pipelines import sd as tsd
from theatergen_tpu_torch.pipelines.bundle import init_bundle
from theatergen_tpu_torch.runtime import store as tstore
from theatergen_tpu_torch.utils import cache as tcache
from theatergen_tpu_torch.utils import layout as TL
from theatergen_tpu_torch.utils import profiling as tprof

from test_torch_port_models import random_params
from test_torch_port_sam import HF, SAM_TOL, hf_pair, lite_pair

torch.set_num_threads(1)

__all__ = ["hf_pair", "lite_pair"]

RESPONSE = """Objects: [('a red knight', [50, 100, 150, 300], 0), ('a green dragon', [300, 80, 180, 330], 1)]
Background prompt: a forest clearing
Negative prompt: blurry, low quality
"""


def _np(x):
    return np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x)


# ------------------------------------------------------------ utils/layout


@pytest.mark.parametrize("text", [
    RESPONSE,
    "Objects: [('a cat', [10, 10, 50, 50], 0)]\nBackground prompt: a room\n",
    "Objects: [('a cat', [10, 10, 50, 50], 0)]\nBackground prompt: a room\n"
    "Negative prompt: None\n",
    "Objects: No objects\nBackground prompt: an empty beach\n",
    "[('a', [1, 2, 3, 4]), ('b', [5, 6, 7, 8])]\nBackground prompt: x\n"],
    ids=["full", "no_negative", "none_negative", "no_objects", "two_tuples"])
def test_parse_layout_response_matches(text):
    """tests/test_layout.py's responses (and ids given by position): the
    same (ids, boxes, background, negative) on both sides."""
    assert TL.parse_layout_response(text) == JL.parse_layout_response(text)


def test_parse_layout_response_refuses_as_jax():
    bad = "Objects: [('a', [1, 2, 3, 4])]\n"
    with pytest.raises(ValueError):
        JL.parse_layout_response(bad)
    with pytest.raises(ValueError):
        TL.parse_layout_response(bad)


@pytest.mark.parametrize("boxes,kw", [
    ([("a", (0, 0, 0, 10)), ("bg", (0, 0, 512, 512)),
      ("b", (10, 10, 100, 100))], {}),
    ([("big", (-100, 0, 800, 400))], {}),
    ([{"name": "a cat.", "bounding_box": (10, 10, 60, 60)},
      {"name": "none", "bounding_box": None}], {"scale_boxes": False}),
    ([{"name": "a cat", "bounding_box": (10, 10, 60, 60)}], {}),
    ([{"name": "a cat", "bounding_box": (10, 10, 60, 60)}],
     {"force_scale": True}),
    ([("x", (600, 10, 50, 50)), ("y", (20, -30, 100, 600)),
      ("z", (5, 5, 40, 40))], {"return_indices": True}),
    ([], {"return_indices": True})],
    ids=["drops", "rescales", "dict", "in_bounds", "force_scale",
         "indices", "empty"])
def test_filter_boxes_matches(boxes, kw):
    """tests/test_layout.py's layouts and more (an off-canvas box, a box
    above the canvas, the surviving indices): equal outputs."""
    assert TL.filter_boxes(boxes, **kw) == JL.filter_boxes(boxes, **kw)


def test_generate_layout_with_cache_matches(tmp_path):
    """The stage-one step through each package's cache: one LLM call per
    package, the second served from the cache, equal specs, and each
    cache file read by the other package's QueryCache."""
    calls = []

    def fake_llm(prompt):
        calls.append(prompt)
        assert "Caption: two cats" in prompt
        return RESPONSE

    jc = jcache.QueryCache(str(tmp_path / "j.json"))
    tc = tcache.QueryCache(str(tmp_path / "t.json"))
    want = JL.generate_layout("two cats", fake_llm, jc)
    got = TL.generate_layout("two cats", fake_llm, tc)
    assert TL.generate_layout("two cats", fake_llm, tc) == got == want
    assert len(calls) == 2 and calls[0] == calls[1]
    assert TL.LAYOUT_PROMPT_TEMPLATE == JL.LAYOUT_PROMPT_TEMPLATE
    assert TL.generate_layout("two cats", fake_llm) == want
    prompt = calls[0]
    assert tcache.QueryCache(str(tmp_path / "j.json")).get(prompt) == \
        RESPONSE
    assert jcache.QueryCache(str(tmp_path / "t.json")).get(prompt) == \
        RESPONSE


@pytest.mark.parametrize("caption,order", [
    ("a knight to the left of a dragon", 1),
    ("a dragon to the left of a knight", -1),
    ("a knight and a dragon", 1),
    ("a cat above a dog", 1)])
def test_eval_layout_matches(caption, order):
    boxes = [("a red knight", (50, 100, 150, 300)),
             ("a green dragon", (300, 80, 180, 330))][::order]
    assert TL.eval_layout(caption, boxes) == JL.eval_layout(caption, boxes)
    assert TL.eval_layout(caption, [("x", (-5, 0, 600, 10))]) == \
        JL.eval_layout(caption, [("x", (-5, 0, 600, 10))])


def test_query_cache_roundtrip_matches(tmp_path):
    """tests/test_utils.py::test_query_cache_roundtrip on the port: one
    computation, persistence across instances, the counters; the files
    of both packages are the same JSON."""
    files = {}
    for name, mod in (("j", jcache), ("t", tcache)):
        path = str(tmp_path / f"{name}.json")
        c = mod.QueryCache(path)
        calls = []

        def compute():
            calls.append(1)
            return {"boxes": [[1, 2, 3, 4]]}

        v1 = c.get_or_compute("prompt A", compute)
        v2 = c.get_or_compute("prompt A", compute)
        assert v1 == v2 and len(calls) == 1
        c2 = mod.QueryCache(path)
        assert c2.get("prompt A") == v1
        assert c2.counters["prompt A"] >= 1
        with open(path) as f:
            files[name] = json.load(f)
    assert files["j"] == files["t"]


# ------------------------------------------------------------- the helpers


def test_encode_image_matches():
    """sd.encode_image: the posterior mean, and a sample with the JAX
    draw handed over as noise; bound 5e-5 (fp32 through the tiny VAE
    encoder, as test_torch_port_models' encoder check)."""
    jc = jcfg.tiny_config()
    jvae = JVAE(jc.vae)
    vp = random_params(jvae, 1, jnp.zeros((1, 16, 16, 3)))
    jb = types.SimpleNamespace(vae=jvae, vae_params=vp, cfg=jc)
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu").load_flax(vae=vp)
    img = np.random.RandomState(3).uniform(-1, 1, (2, 16, 16, 3)).astype(
        np.float32)
    key = jax.random.key(5)
    want_mean = np.asarray(jsd.encode_image(jb, jnp.asarray(img)))
    want = np.asarray(jsd.encode_image(jb, jnp.asarray(img), key))
    noise = np.asarray(jax.random.normal(key, want.shape, jnp.float32))
    got_mean = tsd.encode_image(tb, torch.from_numpy(img))
    got = tsd.encode_image(tb, torch.from_numpy(img),
                           noise=torch.from_numpy(noise))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got_mean), want_mean, atol=5e-5)
    np.testing.assert_allclose(_np(got), want, atol=5e-5)
    assert not np.allclose(want, want_mean)
    g = tsd.encode_image(tb, torch.from_numpy(img),
                         torch.Generator().manual_seed(0))
    assert g.shape == want.shape and not torch.equal(g, got_mean)


@pytest.mark.parametrize("backend", ["lite", "hf"])
def test_segment_with_boxes_matches(lite_pair, hf_pair, backend):
    """The legacy multi-box selection (each box rasterised as the coarse
    mask) through either backend: the refined masks equal, the chosen IoU
    scores within SAM_TOL; the one-box wrapper is its first row; the
    counter counts one segment a box."""
    if backend == "lite":
        jsam, jp, tm = lite_pair
    else:
        _, jp, tm = hf_pair
        jsam = JHF.SamHF(HF)
    rng = np.random.RandomState(12)
    img = rng.rand(64, 64, 3).astype(np.float32)
    boxes = np.array([[0.1, 0.1, 0.6, 0.9], [0.3, 0.2, 0.9, 0.8],
                      [0.0, 0.0, 1.0, 1.0]], np.float32)
    for kw in ({}, {"min_confidence": 0.0, "min_coarse_iou": 0.0}):
        jm, jc = jax.jit(lambda p, i, b: JSM.segment_with_boxes(
            jsam, p, i, b, out_size=16, **kw))(jp, jnp.asarray(img),
                                               jnp.asarray(boxes))
        before = TSM.segments
        tm_, tc = TSM.segment_with_boxes(tm, torch.from_numpy(img),
                                         torch.from_numpy(boxes),
                                         out_size=16, **kw)
        assert TSM.segments == before + 3
        assert tm_.shape == (3, 16, 16)
        np.testing.assert_array_equal(_np(tm_), np.asarray(jm))
        np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=SAM_TOL)
    jm1, jc1 = jax.jit(lambda p, i, b: JSM.segment_with_box_legacy(
        jsam, p, i, b, out_size=16))(jp, jnp.asarray(img),
                                     jnp.asarray(boxes[1]))
    tm1, tc1 = TSM.segment_with_box_legacy(tm, torch.from_numpy(img),
                                           torch.from_numpy(boxes[1]),
                                           out_size=16)
    np.testing.assert_array_equal(_np(tm1), np.asarray(jm1))
    np.testing.assert_allclose(float(tc1), float(jc1), atol=SAM_TOL)


def test_box_iou_matches():
    """Broadcast pairs, disjoint, nested, touching and degenerate boxes;
    bound 1e-7 (the same fp32 formula)."""
    rng = np.random.RandomState(13)
    lo = rng.rand(5, 1, 2).astype(np.float32) * 0.6
    hi = lo + rng.rand(5, 1, 2).astype(np.float32) * 0.4
    a = np.concatenate([lo, hi], -1)
    b = np.concatenate([hi - 0.2, hi + 0.1], -1).transpose(1, 0, 2)
    edge = np.array([[0, 0, 0.5, 0.5], [0.5, 0, 1, 0.5], [0.2, 0.2, 0.2, 0.6],
                     [0.1, 0.1, 0.9, 0.9]], np.float32)
    for x, y in ((a, b), (edge[:, None], edge[None])):
        np.testing.assert_allclose(
            _np(TG.box_iou(torch.from_numpy(x), torch.from_numpy(y))),
            np.asarray(JG.box_iou(jnp.asarray(x), jnp.asarray(y))),
            atol=1e-7)


def test_embed_points_matches(hf_pair):
    """SamHF's point prompts for every label (padding, not a point,
    negative, positive); bound SAM_TOL."""
    _, jp, tm = hf_pair
    rng = np.random.RandomState(14)
    pts = (rng.rand(2, 3, 4, 2) * HF.image_size).astype(np.float32)
    labels = np.array([-10, -1, 0, 1] * 6, np.int32).reshape(2, 3, 4)
    want = JHF.SamHF(HF).apply(
        {"params": jp}, jnp.asarray(pts), jnp.asarray(labels),
        method=lambda m, p, lab: m.prompt_encoder.embed_points(p, lab))
    got = tm.prompt_encoder.embed_points(
        torch.from_numpy(pts), torch.from_numpy(labels),
        tm.shared_image_embedding)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=SAM_TOL)
    assert not _np(got)[0, 0, 0].any()


@pytest.mark.parametrize("kind", ["epsilon", "v_prediction", "sample"])
def test_pred_original_matches(kind):
    """x0 at every loop position of a 10-step schedule, the index an int
    and a 0-dim tensor; bound 2e-6 (fp32, one division)."""
    jc = dataclasses.replace(jcfg.tiny_config().scheduler,
                             prediction_type=kind)
    tc = dataclasses.replace(tcfg.tiny_config().scheduler,
                             prediction_type=kind)
    js, ts = jsched.make_schedule(jc, 10), tsched.make_schedule(tc, 10)
    rng = np.random.RandomState(15)
    out = rng.randn(2, 8, 8, 4).astype(np.float32)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    for i in range(10):
        want = np.asarray(jsched.pred_original(js, jnp.asarray(out), i,
                                               jnp.asarray(x)))
        for idx in (i, torch.tensor(i)):
            got = tsched.pred_original(ts, torch.from_numpy(out), idx,
                                       torch.from_numpy(x))
            np.testing.assert_allclose(_np(got), want, rtol=2e-6, atol=2e-6)


def test_phase_timer_report_matches():
    """The same samples give the same JSON report."""
    samples = {"a": [0.5, 0.25, 1.0], "b": [2.0]}
    jt, tt = jprof.PhaseTimer(), tprof.PhaseTimer()
    for t in (jt, tt):
        for name, xs in samples.items():
            t.samples[name].extend(xs)
    assert tt.report() == jt.report()
    assert json.loads(tt.report())["a"]["count"] == 3
    with tt.phase("c"):
        pass
    assert set(json.loads(tt.report())) == {"a", "b", "c"}


def test_store_keys_and_len_match(tmp_path):
    """The native store's keys and length after puts, an overwrite and a
    delete, read by the port and by the JAX package on the same file."""
    if not tstore.available() or not jstore.available():
        pytest.skip("no g++ to build the native store")
    path = str(tmp_path / "emb.bin")
    s = tstore.EmbeddingStore(path, 4)
    assert s.keys() == [] and len(s) == 0
    for k in (9, 3, 12, 5):
        s.put(k, np.full(4, k, np.float32))
    s.put(3, np.zeros(4, np.float32))
    assert s.delete(12)
    assert s.keys() == [3, 5, 9] and len(s) == 3
    s.close()
    j = jstore.EmbeddingStore(path, 0)
    assert j.keys() == [3, 5, 9] and len(j) == 3
    j.close()
    t = tstore.EmbeddingStore(path, 0)
    assert t.keys() == [3, 5, 9] and len(t) == 3
    t.close()
    with pytest.raises(ValueError, match="closed"):
        t.keys()
