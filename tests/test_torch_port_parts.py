"""The parts of a turn against their JAX twins on the CPU: spec parsing,
phrase-token lookup, the characters' input latents, attention detection,
within-turn dedup, the PNG codec and the character DB's layout on disk."""

import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from theatergen_tpu import db as jdb
from theatergen_tpu import theater as jth
from theatergen_tpu.ops import latents as JL
from theatergen_tpu.perception import detector as jdet
from theatergen_tpu.utils import parse as jparse
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import db as tdb
from theatergen_tpu_torch import theater as tth
from theatergen_tpu_torch.ops import latents as TL
from theatergen_tpu_torch.perception import detector as tdet
from theatergen_tpu_torch.runtime import store as tstore
from theatergen_tpu_torch.utils import parse as tparse
from theatergen_tpu_torch.utils import png
from theatergen_tpu_torch.utils import tokenizer as ttok
from theatergen_tpu_torch.utils.profiling import PhaseTimer

torch.set_num_threads(1)

DATA = pathlib.Path(__file__).resolve().parent.parent / "data" / "sample"


def _turn_specs():
    from theatergen_tpu.cli.generate import build_spec

    specs = []
    for task in ("story", "editing"):
        data = json.loads((DATA / f"{task}.json").read_text())
        for dialogue in data.values():
            for turn in dialogue.values():
                specs.append(build_spec(turn))
    return specs


SPECS = _turn_specs()


@pytest.mark.parametrize("canvas", [None, 512])
@pytest.mark.parametrize("px", [16, 512])
def test_convert_spec_matches(px, canvas):
    """Every turn of data/sample/{story,editing}.json gives the same plan
    (object plans, overall prompt and phrases) in both packages, rendered
    at 16 and 512 px, with and without the authoring canvas."""
    assert len(SPECS) == 16
    for spec in SPECS:
        if canvas:
            spec = dict(spec, canvas_height=canvas, canvas_width=canvas)
        jp = jparse.convert_spec(spec, px, px)
        tp = tparse.convert_spec(spec, px, px)
        assert tp.objects == jp.objects and tp.obj_ids == jp.obj_ids
        assert tp.overall_prompt == jp.overall_prompt
        assert tp.overall_phrases == jp.overall_phrases
        assert [vars(o) for o in tp.object_plans] == [
            vars(o) for o in jp.object_plans]
    assert tparse.DEFAULT_SO_NEGATIVE_PROMPT == jparse.DEFAULT_SO_NEGATIVE_PROMPT
    assert (tparse.DEFAULT_OVERALL_NEGATIVE_PROMPT
            == jparse.DEFAULT_OVERALL_NEGATIVE_PROMPT)


def test_plural_and_article_helpers_match():
    for noun in ("a green dragon", "fox", "lady", "wolf", "knife", "boy",
                 "church", "sheep", "person"):
        assert tparse.plural_noun(noun) == jparse.plural_noun(noun)
        assert tparse.strip_article(noun) == jparse.strip_article(noun)
    for n in (0, 2, 12, 13):
        assert tparse.number_to_words(n) == jparse.number_to_words(n)
    box = (-10, 30, 600, 100)
    assert tparse.convert_box(box, 512, 512) == jparse.convert_box(box, 512,
                                                                    512)


@pytest.mark.parametrize("prompt,phrase", [
    ("full-body picture of a red knight", "knight"),
    ("full-body picture of a green dragon", "green dragon"),
    ("a forest with a green dragon and a green dragon", "dragon"),
    ("full-body picture of a girl", "umbrella"),          # absent: []
    ("full-body picture of a girl | a girl with umbrella", "umbrella"),
    ("anything", ""),                                     # empty phrase
    (" ".join(["word"] * 90) + " knight", "knight")])     # past 77 tokens
def test_find_phrase_token_indices_matches(prompt, phrase):
    """Token positions of a phrase, including the empty result that makes
    _character_prep rewrite the prompt, on the hash tokenizer."""
    jt, tt = jtok.HashTokenizer(1024), ttok.HashTokenizer(1024)
    got = ttok.find_phrase_token_indices(tt, prompt, phrase, 77)
    assert got == jtok.find_phrase_token_indices(jt, prompt, phrase, 77)
    if phrase == "umbrella" and "|" not in prompt:
        assert got == []


@pytest.mark.parametrize("sigma", [1.0, 14.6])
def test_input_latents_for_boxes_match(sigma):
    """The characters' input latents from injected unit noise, at two
    init-noise sigmas: fg noise blended into the bg noise inside each box,
    1e-6 absolute (fp32 square roots of the blend ratio)."""
    rng = np.random.RandomState(0)
    boxes = np.array([[0.1, 0.2, 0.6, 0.9], [0.5, 0.0, 1.0, 0.5],
                      [0.0, 0.0, 0.0, 0.0]], np.float32)
    bg = rng.randn(1, 8, 8, 4).astype(np.float32)
    fg = rng.randn(3, 1, 8, 8, 4).astype(np.float32)
    pj, bj = JL.input_latents_for_boxes(
        None, None, jnp.asarray(boxes), 8, 8, fg_blending_ratio=0.1,
        init_noise_sigma=sigma, bg_noise=bg, fg_noise=fg)
    pt, bt = TL.input_latents_for_boxes(
        None, torch.from_numpy(boxes), 8, 8, fg_blending_ratio=0.1,
        init_noise_sigma=sigma, bg_noise=torch.from_numpy(bg),
        fg_noise=torch.from_numpy(fg))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6 * sigma)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6 * sigma)
    # the empty box keeps the background
    np.testing.assert_array_equal(pt[2].numpy(), bt.numpy())


def test_input_latents_draw_bg_then_fg():
    """With a generator, the background is drawn first, then the per-box
    foreground noise, both fp32 unit normals from the one generator."""
    boxes = torch.tensor([[0.25, 0.25, 0.75, 0.75]])
    per, bg = TL.input_latents_for_boxes(
        torch.Generator().manual_seed(5), boxes, 4, 4)
    g = torch.Generator().manual_seed(5)
    want_bg = torch.randn(1, 4, 4, 4, generator=g)
    want_fg = torch.randn(1, 1, 4, 4, 4, generator=g)
    torch.testing.assert_close(bg, want_bg, rtol=0, atol=0)
    torch.testing.assert_close(
        per, TL.input_latents_for_boxes(None, boxes, 4, 4, bg_noise=want_bg,
                                        fg_noise=want_fg)[0], rtol=0, atol=0)


@pytest.mark.parametrize("peaked", [True, False])
def test_attention_detect_matches(peaked):
    """Box, confidence and ok from three guidance keys' maps ([heads, HW]
    at 8², 4², 8²; and [heads, HW, T] picked at a word token): box and ok
    equal, confidence 1e-6.  A blob is found; one hot pixel over a raised
    background holds too little of the mass, and is not."""
    rng = np.random.RandomState(1 if peaked else 2)
    maps = []
    for side in (8, 4, 8):
        m = rng.rand(2, side * side).astype(np.float32) * 0.1
        img = m.reshape(2, side, side)
        if peaked:
            img[:, side // 4:side // 2 + 1, side // 4:side // 2 + 1] += 1.0
        else:
            img += 0.3
            img[:, 1, 2] += 1.0
        maps.append(m)
    for word in (None, 3):
        ins = maps if word is None else [
            np.repeat(m[..., None], 5, -1) * (np.arange(5) == 3) for m in maps]
        dj = jdet.attention_detect([jnp.asarray(m) for m in ins], word)
        dt = tdet.attention_detect([torch.from_numpy(m) for m in ins], word)
        np.testing.assert_array_equal(dt.box.numpy(), np.asarray(dj.box))
        np.testing.assert_allclose(float(dt.confidence),
                                   float(dj.confidence), atol=1e-6)
        assert bool(dt.ok) == bool(dj.ok) == peaked


def test_dedup_plans_matches():
    """Dedup keys on (prompt, obj_id): two dragons with their own ids stay
    two, the same id twice is one, for every sample turn and a made-up
    one."""
    spec = dict(SPECS[3], obj_ids=[1, 1])
    assert len(spec["gen_boxes"]) == 2
    for s in SPECS + [spec]:
        jo, ju, ji = jth._dedup_plans(jparse.convert_spec(s))
        to, tu, ti = tth._dedup_plans(tparse.convert_spec(s))
        assert to == jo and ti == ji
        assert [vars(p) for p in tu] == [vars(p) for p in ju]
    assert len(tth._dedup_plans(tparse.convert_spec(spec))[1]) == 1
    assert len(tth._dedup_plans(tparse.convert_spec(SPECS[3]))[1]) == 2


def test_phase_timer_counts_and_summary():
    t = PhaseTimer("cpu")
    for _ in range(3):
        with t.phase("a", sync=True):
            pass
    with t.phase("b"):
        pass
    assert t.counts() == {"a": 3, "b": 1}
    s = t.summary()
    assert s["a"]["count"] == 3 and s["b"]["total_s"] >= 0.0
    assert s["a"]["p50_s"] <= s["a"]["p90_s"]


# ---------------------------------------------------------------------------
# PNG codec and the character DB
# ---------------------------------------------------------------------------

def _image(seed, h=24, w=20):
    """Noise over a gradient: PIL's adaptive filter picks several row
    filters for it."""
    rng = np.random.RandomState(seed)
    ramp = np.linspace(0, 200, w)[None, :, None] + np.linspace(
        0, 50, h)[:, None, None]
    img = ramp + rng.randint(0, 40, (h, w, 3))
    img[h // 2:, : w // 2] = rng.randint(0, 256, (h - h // 2, w // 2, 3))
    return img.clip(0, 255).astype(np.uint8)


def _filter_rows(img: np.ndarray, ftype: int) -> bytes:
    """Raw PNG scanlines of ``img`` (uint8 [H, W, C]) all under one filter
    type, written straight from the PNG specification."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        x = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - prev
        elif ftype == 3:
            f = x - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            f = x - pred
        out.append(ftype)
        out += bytes((f % 256).astype(np.uint8))
        prev = x
    return bytes(out)


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("channels", [3, 4])
def test_png_reads_every_row_filter(ftype, channels):
    """A file whose rows all use one of the five filters (RGB and RGBA)
    reads back to the pixels."""
    import struct
    import zlib

    img = _image(ftype)
    if channels == 4:
        img = np.concatenate([img, img[..., :1]], -1)
    h, w, _ = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if channels == 4 else 2, 0, 0,
                       0)
    blob = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(_filter_rows(img, ftype)))
            + png._chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode_png(blob), img[..., :3])


def test_png_round_trip_and_pil(tmp_path):
    """The port's files read back bit for bit in the port and in PIL; PIL's
    files (RGB, RGBA, greyscale; adaptive row filters) read in the port as
    PIL reads them."""
    for seed in range(3):
        img = _image(seed)
        path = str(tmp_path / f"port{seed}.png")
        png.write_png(path, img)
        np.testing.assert_array_equal(png.read_png(path), img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        for mode in ("RGB", "RGBA", "L"):
            pil = Image.fromarray(img).convert(mode)
            ppath = str(tmp_path / f"pil{seed}{mode}.png")
            pil.save(ppath)
            np.testing.assert_array_equal(
                png.read_png(ppath), np.asarray(pil.convert("RGB")))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError):
        png.decode_png(b"GIF89a" + bytes(20))
    f = np.array([[[-0.2, 0.5, 1.3]]], np.float32)
    np.testing.assert_array_equal(png.to_uint8(f), [[[0, 127, 255]]])


def _db_items():
    rng = np.random.RandomState(4)
    return [(oid, rng.rand(16, 12, 3).astype(np.float32),
             rng.randn(32).astype(np.float32)) for oid in (0, 7, "hero")]


@pytest.mark.parametrize("native", [True, False])
def test_db_reads_a_jax_written_db(tmp_path, native):
    """A DB directory written by the JAX CharacterDB (with and without its
    native store) reads in the port's, with and without the port's
    store: the same images (PNG bytes through both codecs) and
    embeddings; hits and misses agree; a delete in either is seen by
    both."""
    root = str(tmp_path / "db")
    jd = jdb.CharacterDB(root, use_native=native)
    for oid, img, emb in _db_items():
        jd.save(oid, img, emb)
    for port_native in (True, False):
        td = tdb.CharacterDB(root, use_native=port_native)
        for oid, img, emb in _db_items():
            ti, te, hit = td.lookup(oid)
            ji, je, jhit = jdb.CharacterDB(root, use_native=native).lookup(oid)
            assert hit and jhit
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_allclose(ti, img, atol=1 / 255 + 1e-6)
            if te is None:
                # the port without a store cannot read embeddings.bin
                assert not port_native and os.path.exists(
                    os.path.join(root, "embeddings.bin"))
            else:
                np.testing.assert_array_equal(np.ravel(te), emb)
        assert td.lookup(99) == (None, None, False)
    tdb.CharacterDB(root).delete(7)
    assert not jdb.CharacterDB(root, use_native=native).has(7)


def test_jax_reads_a_port_written_db(tmp_path):
    """The other way: the port's DB (native store) reads in the JAX one."""
    root = str(tmp_path / "db")
    td = tdb.CharacterDB(root)
    assert td.store_kind == ("native" if tstore.available() else "npy")
    for oid, img, emb in _db_items():
        td.save(oid, img, emb)
    jd = jdb.CharacterDB(root)
    for oid, img, emb in _db_items():
        ji, je, hit = jd.lookup(oid)
        assert hit
        np.testing.assert_array_equal(ji, tdb.CharacterDB(root).load_image(
            oid))
        np.testing.assert_array_equal(np.ravel(je), emb)


def test_store_builds_under_build_not_beside_the_source():
    """The port's native store is built from native/theaterstore.cpp into
    build/theaterstore/, its name carrying the source's hash."""
    if not tstore.available():
        pytest.skip("no g++ to build the native store")
    path = tstore.library_path()
    assert path.exists() and path.parent == tstore.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "theaterstore")
    assert tstore.SRC.name == "theaterstore.cpp"
