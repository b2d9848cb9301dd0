"""The CMIGBench evaluation of the port (``eval/{metrics,cmig,inception}.py``,
``utils/vis.py``, ``models/clip.py::clip_similarity``,
``perception/detector.py::ClipBoxScorer``) against the JAX package's, on
the CPU, with the same numpy inputs and the JAX trees carried by
``from_flax``.

Tolerances: the metrics are the same numpy code, so bit for bit; the tiny
towers' embeddings within 1e-5 (fp32 on both sides); InceptionV3 at 96 px
with full channels within 1e-4 of its features' scale (the JAX package's
own chunked-against-one-shot drift is 3e-5 on features of scale 28);
``evaluate_tree``'s aggregates within 1e-4 relative, each thresholded
decision equal (the scores lie 1e-3 or more from their thresholds, checked
here, so no verdict can flip on rounding).
"""

import csv
import dataclasses
import functools
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu.config import CLIPTextConfig as JTCfg
from theatergen_tpu.config import CLIPVisionConfig as JVCfg
from theatergen_tpu.eval import cmig as jcmig
from theatergen_tpu.eval import inception as jinc
from theatergen_tpu.eval import metrics as JM
from theatergen_tpu.models import clip as jclip
from theatergen_tpu.perception import detector as jdet
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu.utils import vis as jvis
from theatergen_tpu_torch.eval import cmig as tcmig
from theatergen_tpu_torch.eval import inception as tinc
from theatergen_tpu_torch.eval import metrics as TM
from theatergen_tpu_torch.models import clip as tclip
from theatergen_tpu_torch.models import weights as TW
from theatergen_tpu_torch.perception import detector as tdet
from theatergen_tpu_torch.utils import png
from theatergen_tpu_torch.utils import tokenizer as ttok
from theatergen_tpu_torch.utils import vis as tvis

from test_torch_port_models import random_params

torch.set_num_threads(1)

TOL = 1e-5
MARGIN = 1e-3
DATA = pathlib.Path(__file__).resolve().parent.parent / "data" / "sample"


# ---------------------------------------------------------------- metrics


def test_metrics_match_bit_for_bit():
    """Every metric primitive on the same numpy input gives the same bits:
    the cosine and logit, the Fréchet distance through scipy's sqrtm and
    through the Newton–Schulz fallback, the spatial rules, the crop."""
    rng = np.random.RandomState(0)
    a, b = rng.randn(7, 16), rng.randn(7, 16)
    for fn in ("cosine_similarity", "clip_logit"):
        np.testing.assert_array_equal(getattr(TM, fn)(a, b),
                                      getattr(JM, fn)(a, b))
    fa, fb = rng.randn(40, 8), rng.randn(30, 8) + 0.5
    assert TM.frechet_distance(fa, fb) == JM.frechet_distance(fa, fb)
    assert TM.frechet_distance(fa[:3], fb[:3]) == \
        JM.frechet_distance(fa[:3], fb[:3])
    m = np.cov(fa, rowvar=False) @ np.cov(fb, rowvar=False)
    np.testing.assert_array_equal(TM._sqrtm_newton_schulz(m),
                                  JM._sqrtm_newton_schulz(m))
    cat = ("a grey cat", [0.1, 0.4, 0.3, 0.6])
    dog = ("a brown dog", [0.6, 0.4, 0.9, 0.6])
    for cap in ("a grey cat to the right of a brown dog",
                "a brown dog to the left of a grey cat",
                "a cat below a dog", "a cat in the middle of a dog",
                "a cat and a dog"):
        for dets in ([cat, dog], [dog], [dog, cat]):
            assert TM.eval_spatial_reference(dets, cap, 2) == \
                JM.eval_spatial_reference(dets, cap, 2)
        assert TM.parse_spatial_relation(cap) == \
            JM.parse_spatial_relation(cap)
    for rel in ("left", "right", "top", "bottom", "middle", "none"):
        assert TM.check_spatial(rel, cat[1], dog[1]) == \
            JM.check_spatial(rel, cat[1], dog[1])
    img = rng.rand(50, 70, 3)
    for box in ([0.1, 0.2, 0.5, 0.9], [0.99, 0.99, 1.0, 1.0],
                [0.0, 0.0, 0.01, 0.02]):
        np.testing.assert_array_equal(TM.crop(img, box), JM.crop(img, box))


def test_sqrtm_without_disp_gives_the_same_root():
    """scipy releases without ``sqrtm``'s ``disp`` return the root alone;
    the port's call gives the same root either way."""
    import types

    from scipy import linalg

    rng = np.random.RandomState(2)
    a = rng.randn(6, 6)
    m = a @ a.T
    no_disp = types.SimpleNamespace(sqrtm=lambda x: TM._scipy_sqrtm(linalg,
                                                                    x))
    np.testing.assert_array_equal(TM._scipy_sqrtm(no_disp, m),
                                  TM._scipy_sqrtm(linalg, m))


def test_clip_similarity_matches():
    rng = np.random.RandomState(1)
    a = rng.randn(3, 16).astype(np.float32)
    b = rng.randn(5, 16).astype(np.float32)
    got = tclip.clip_similarity(torch.from_numpy(a), torch.from_numpy(b))
    ref = jclip.clip_similarity(jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


# ------------------------------------------------------------------- towers


@functools.lru_cache(maxsize=None)
def _embedders():
    """The JAX ClipEmbedder of the tiny eval towers on seeded trees and the
    port's on the same weights."""
    tcfg, vcfg = tcmig.eval_tower_configs(tiny=True)
    jt, jv = (JTCfg(**dataclasses.asdict(tcfg)),
              JVCfg(**dataclasses.asdict(vcfg)))
    text, vision = jclip.CLIPTextEncoder(jt), jclip.CLIPVisionEncoder(jv)
    tp = random_params(text, 11, jnp.zeros((1, 16), jnp.int32))
    vp = random_params(vision, 12, jnp.zeros((1, 32, 32, 3)))
    jemb = jcmig.ClipEmbedder(text, tp, vision, vp, jtok.HashTokenizer(1024),
                              16)
    ttext = TW.load_into(tclip.CLIPTextEncoder(tcfg), TW.from_flax("text", tp))
    tvision = TW.load_into(tclip.CLIPVisionEncoder(vcfg),
                           TW.from_flax("vision", vp))
    temb = tcmig.ClipEmbedder(ttext, tvision, ttok.HashTokenizer(1024), 16)
    return jemb, temb


def _images(seed, n, sides=((40, 56), (64, 64), (20, 9))):
    rng = np.random.RandomState(seed)
    return [rng.rand(*sides[i % len(sides)], 3).astype(np.float32)
            for i in range(n)]


def test_clip_embedder_matches():
    """Image embeddings of crops of several sizes (each resized to 32² by
    the antialiased bilinear of jax.image.resize) and text embeddings."""
    jemb, temb = _embedders()
    imgs = _images(0, 5)
    np.testing.assert_allclose(temb.embed_images(imgs),
                               jemb.embed_images(imgs), atol=TOL)
    texts = ["a red knight", "a green dragon flies", ""]
    np.testing.assert_allclose(temb.embed_texts(texts),
                               jemb.embed_texts(texts), atol=TOL)
    assert temb.embed_images(imgs).dtype == np.float32


def test_eval_default_builds_seeded_towers_and_needs_the_card():
    """``eval_default`` at the tiny widths on the CPU: finite embeddings
    of the right width, the same for the same seed; without a card the
    default device raises, with no fallback."""
    a = tcmig.ClipEmbedder.eval_default(0, tiny=True, device="cpu")
    b = tcmig.ClipEmbedder.eval_default(0, tiny=True, device="cpu")
    img = _images(3, 1)
    ea, eb = a.embed_images(img), b.embed_images(img)
    assert ea.shape == (1, 32) and np.isfinite(ea).all()
    np.testing.assert_array_equal(ea, eb)
    assert a.embed_texts(["a cat"]).shape == (1, 32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcmig.ClipEmbedder.eval_default(0, tiny=True)


def test_clip_sliding_detector_matches():
    """The 88 candidate boxes, their scores, the best box and verdict, and
    the NMS count, against the JAX detector on the same towers; the
    threshold set by the scores so that several pass."""
    jemb, temb = _embedders()
    img = _images(4, 1, ((64, 48),))[0]
    jd = jcmig.ClipSlidingDetector(jemb)
    sims = jd._scores(img, "a red knight")
    thr = float(np.quantile(sims, 0.8))
    thr += MARGIN if np.abs(sims - thr).min() < MARGIN else 0.0
    jd.threshold = thr
    td = tcmig.ClipSlidingDetector(temb, threshold=thr)
    assert td.provenance == "clipdet" and len(td.candidates) == 88
    np.testing.assert_array_equal(td.candidates, jd.candidates)
    np.testing.assert_allclose(td._scores(img, "a red knight"), sims,
                               atol=TOL)
    tb, tc, tok = td(img, "a red knight")
    jb, jc, jok = jd(img, "a red knight")
    np.testing.assert_array_equal(tb, jb)
    assert abs(tc - jc) <= TOL and tok == jok
    assert td.count_instances(img, "a red knight") == \
        jd.count_instances(img, "a red knight") >= 2


def test_clip_box_scorer_matches():
    jemb, temb = _embedders()
    img = _images(5, 1, ((48, 48),))[0]
    box = np.array([0.1, 0.2, 0.7, 0.9], np.float32)
    got = tdet.ClipBoxScorer(temb).score(torch.from_numpy(img),
                                         torch.from_numpy(box), "a cat")
    ref = jdet.ClipBoxScorer(jemb).score(jnp.asarray(img), jnp.asarray(box),
                                         "a cat")
    assert abs(got - ref) <= TOL


# --------------------------------------------------------------- inception


@functools.lru_cache(maxsize=None)
def _inception():
    """The JAX InceptionV3Features at 96 px on a seeded tree whose BN
    statistics are not the identity, and the port's on the same weights."""
    model = jinc.InceptionV3Features()
    params = random_params(model, 13, jnp.zeros((1, 96, 96, 3)))
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: (np.abs(x) + 0.5 if p[-1].key == "bn_var" else x),
        params)
    sd = TW.from_flax("inception", params)
    return model, params, sd


def test_inception_matches_jax():
    model, params, sd = _inception()
    tm = TW.load_into(tinc.InceptionV3Features(), sd).eval()
    x = np.random.RandomState(0).rand(2, 96, 96, 3).astype(np.float32) * 2 - 1
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_port_inception_takes_torchvision_names():
    """``port_inception`` of a pytorch_fid state dict (torchvision's names,
    with ``fc``, ``AuxLogits`` and ``num_batches_tracked``) is exactly the
    module's state dict; the JAX package's ``port_inception`` of the same
    file gives the tree that ``from_flax`` maps to it."""
    _, params, sd = _inception()
    with torch.device("meta"):
        names = set(tinc.InceptionV3Features().state_dict())
    assert set(sd) == names
    assert "Mixed_5b.branch1x1.bn.running_var" in names
    pub = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    pub.update({"fc.weight": torch.zeros(1008, 2048),
                "fc.bias": torch.zeros(1008),
                "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1),
                "Conv2d_1a_3x3.bn.num_batches_tracked": torch.tensor(0)})
    ported = TW.port_inception(pub)
    assert set(ported) == names
    back = TW.from_flax("inception", jinc.port_inception(
        {k: v.numpy() for k, v in pub.items()}))
    for k in names:
        np.testing.assert_array_equal(np.asarray(back[k]),
                                      ported[k].numpy(), err_msg=k)


def test_inception_embedder_matches_jax_and_chunks():
    """The embedder's resize to 96², ×2−1 and features against the JAX
    embedder's; chunks of 3 (the last padded) equal to one chunk."""
    _, params, sd = _inception()
    jemb = jinc.InceptionEmbedder(params, size=96)
    temb = tinc.InceptionEmbedder(sd, size=96, device="cpu")
    imgs = _images(6, 7)
    ref = jemb.embed_images(imgs)
    one = temb.embed_images(imgs)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(one, ref, atol=1e-4 * scale)
    chunked = temb.embed_images(imgs, batch_size=3)
    assert one.shape == chunked.shape == (7, 2048)
    np.testing.assert_allclose(chunked, one, atol=1e-5 * scale)


def test_inception_embedder_round_trips_a_weights_dir(tmp_path):
    """``from_weights_dir`` of fid_inception.safetensors (pytorch_fid's
    names) gives the same features; ``random_init`` is seeded."""
    _, _, sd = _inception()
    TW.save_safetensors(str(tmp_path / "fid_inception.safetensors"),
                        {**sd, "fc.weight": np.zeros((8, 2048), np.float32)})
    a = tinc.InceptionEmbedder.from_weights_dir(str(tmp_path), device="cpu")
    a.size = 96
    b = tinc.InceptionEmbedder(sd, size=96, device="cpu")
    imgs = _images(7, 2)
    np.testing.assert_array_equal(a.embed_images(imgs), b.embed_images(imgs))
    r1 = tinc.InceptionEmbedder.random_init(3, size=96, device="cpu")
    r2 = tinc.InceptionEmbedder.random_init(3, size=96, device="cpu")
    f1 = r1.embed_images(imgs)
    np.testing.assert_array_equal(f1, r2.embed_images(imgs))
    assert np.isfinite(f1).all() and f1.shape == (2, 2048)


def test_clip_embedder_round_trips_a_weights_dir(tmp_path):
    """``from_weights_dir`` of eval_clip_{text,vision}.safetensors in
    transformers' names: without BPE assets it raises, as the JAX package
    does; with a tokenizer it embeds as the source towers."""
    _, temb = _embedders()
    tcfg, vcfg = tcmig.eval_tower_configs(tiny=True)
    TW.save_safetensors(str(tmp_path / "eval_clip_text.safetensors"), {
        f"text_model.{k}" if k != "text_projection.weight" else k: v
        for k, v in temb.text.state_dict().items()})
    TW.save_safetensors(str(tmp_path / "eval_clip_vision.safetensors"), {
        f"vision_model.{k}" if k != "visual_projection.weight" else k: v
        for k, v in temb.vision.state_dict().items()})
    with pytest.raises(FileNotFoundError, match="BPE"):
        tcmig.ClipEmbedder.from_weights_dir(str(tmp_path), tcfg=tcfg,
                                            vcfg=vcfg, device="cpu")
    emb = tcmig.ClipEmbedder.from_weights_dir(
        str(tmp_path), tokenizer=ttok.HashTokenizer(1024), tcfg=tcfg,
        vcfg=vcfg, device="cpu")
    imgs = _images(8, 2)
    np.testing.assert_array_equal(emb.embed_images(imgs),
                                  temb.embed_images(imgs))
    np.testing.assert_array_equal(emb.embed_texts(["a cat"]),
                                  temb.embed_texts(["a cat"]))


# --------------------------------------------------------------------- vis


def test_vis_reads_and_writes_pngs_as_the_jax_package(tmp_path):
    """``save_image_rgb``/``load_image_rgb``/``display`` with the port's
    PNG codec against the JAX package's PIL: each reads what the other
    writes to the same values; ``display`` numbers its files as the
    reference does; the renderers are the same numpy."""
    rng = np.random.RandomState(9)
    img = rng.rand(17, 23, 3).astype(np.float32)
    tvis.save_image_rgb(str(tmp_path / "t" / "a.png"), img)
    jvis.save_image_rgb(str(tmp_path / "j" / "a.png"), img)
    for d in ("t", "j"):
        p = str(tmp_path / d / "a.png")
        np.testing.assert_array_equal(tvis.load_image_rgb(p),
                                      jvis.load_image_rgb(p))
    np.testing.assert_array_equal(
        tvis.load_image_rgb(str(tmp_path / "t" / "a.png")),
        jvis.load_image_rgb(str(tmp_path / "j" / "a.png")))
    tvis.reset_save_ind()
    paths = [tvis.display(img, img_dir=str(tmp_path / "d")) for _ in range(2)]
    assert [os.path.basename(p) for p in paths] == ["img_0.png", "img_1.png"]
    assert os.path.basename(tvis.display(img, "x_", ind=7, img_dir=str(
        tmp_path / "d"))) == "x_img_7.png"
    masks = [rng.rand(8, 8) > 0.5 for _ in range(3)]
    for fn, args in (("colorize", (img[..., 0],)),
                     ("visualize_latents", (rng.randn(1, 8, 8, 4),)),
                     ("visualize_masks", (masks,)),
                     ("visualize_attn", (rng.rand(2, 64), 16)),
                     ("draw_boxes", (img, [[0.1, 0.1, 0.6, 0.8]]))):
        np.testing.assert_array_equal(getattr(tvis, fn)(*args),
                                      getattr(jvis, fn)(*args))


# ------------------------------------------------------------ evaluate_tree


def _tree(root: pathlib.Path, n_dialogues: int = 2, side: int = 64,
          seed: int = 0) -> dict:
    """A tree of ``n_dialogues`` dialogues (data/sample/story.json's two
    in turn, renamed), each turn's img_0.png random, and its dataset."""
    story = json.loads((DATA / "story.json").read_text())
    src = list(story.values())
    rng = np.random.RandomState(seed)
    dataset = {}
    for i in range(n_dialogues):
        name = f"dialogue_{i}"
        dataset[name] = src[i % len(src)]
        for turn in dataset[name]:
            d = root / name / turn
            d.mkdir(parents=True)
            png.write_png(str(d / "img_0.png"),
                          (rng.rand(side, side, 3) * 255).astype(np.uint8))
    return dataset


def _same_aggregates(got: dict, ref: dict, rtol: float = 1e-4):
    assert list(got) == list(ref)
    for k, v in ref.items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6,
                                       err_msg=k)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_evaluate_tree_matches_jax_with_the_sliding_detector(tmp_path):
    """Two dialogues of the sample story (every turn-wise metric scored)
    with the default CLIP sliding detector on the tiny towers: the
    aggregate dict (keys, ``_clipdet`` and ``_UNVALIDATED`` suffixes,
    values) and the CSV against the JAX package's; every sliding score
    1e-3 or more from the 0.5 threshold."""
    jemb, temb = _embedders()
    dataset = _tree(tmp_path / "tree")
    seen = []
    real = jcmig.ClipSlidingDetector._scores

    def scores(self, image, phrase):
        s = real(self, image, phrase)
        seen.append(np.abs(s - self.threshold).min())
        return s

    jcmig.ClipSlidingDetector._scores = scores
    try:
        ref = jcmig.evaluate_tree(str(tmp_path / "tree"), dataset, jemb,
                                  validated=False,
                                  csv_path=str(tmp_path / "j.csv"))
    finally:
        jcmig.ClipSlidingDetector._scores = real
    got = tcmig.evaluate_tree(str(tmp_path / "tree"), dataset, temb,
                              validated=False,
                              csv_path=str(tmp_path / "t.csv"))
    assert min(seen) > MARGIN, min(seen)
    assert set(got) == {f"{k}_UNVALIDATED" for k in (
        "ACCS", "ATIS", "AFID", "CLIP_FD", "spatial_clipdet",
        "attribute_clipdet", "negative_clipdet", "numeracy_clipdet")}
    _same_aggregates(got, ref)
    jr, tr = _rows(tmp_path / "j.csv"), _rows(tmp_path / "t.csv")
    assert len(tr) == len(jr) == 8
    for a, b in zip(tr, jr):
        assert (a["dialogue"], a["turn"]) == (b["dialogue"], b["turn"])
        np.testing.assert_allclose(float(a["tis"]), float(b["tis"]),
                                   rtol=1e-4)
        assert (a["ccs"] == "") == (b["ccs"] == "")


def test_evaluate_tree_matches_jax_with_owl_and_inception(tmp_path):
    """The same tree with OWL-ViT (test_torch_port_owl.py's tiny pair) as
    the detector, whose ``count_instances`` numeracy uses, and Inception at
    96 px as the AFID feature space: the aggregates against the JAX
    package's (no provenance suffix: OWL-ViT has none), AFID finite; the
    crops' Inception features compared directly, the Fréchet distance over
    a few rank-deficient crops being ill-conditioned."""
    import test_torch_port_owl as owl_tests

    jemb, temb = _embedders()
    jowl, towl = owl_tests._backends()
    _, params, sd = _inception()
    jfid = jinc.InceptionEmbedder(params, size=96)
    tfid = tinc.InceptionEmbedder(sd, size=96, device="cpu")
    crops = {"jax": [], "port": []}

    def spy(emb, key):
        real = emb.embed_images

        def embed(images, **kw):
            crops[key].append([np.asarray(i) for i in images])
            return real(images, **kw)
        return embed

    jfid.embed_images, tfid.embed_images = spy(jfid, "jax"), spy(tfid, "port")
    dataset = _tree(tmp_path / "tree", seed=1)
    ref = jcmig.evaluate_tree(str(tmp_path / "tree"), dataset, jemb,
                              detector=jowl, fid_embedder=jfid)
    got = tcmig.evaluate_tree(str(tmp_path / "tree"), dataset, temb,
                              detector=towl, fid_embedder=tfid)
    assert np.isfinite(got["AFID"]) and "numeracy" in got
    assert len(crops["port"]) == len(crops["jax"]) == 2
    for a, b in zip(crops["port"], crops["jax"]):
        assert len(a) == len(b) >= 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    ref_feats = jinc.InceptionEmbedder(params, size=96).embed_images(
        crops["jax"][0])
    got_feats = tinc.InceptionEmbedder(sd, size=96,
                                       device="cpu").embed_images(
        crops["port"][0])
    np.testing.assert_allclose(got_feats, ref_feats,
                               atol=1e-4 * np.abs(ref_feats).max())
    _same_aggregates({k: v for k, v in got.items() if k != "AFID"},
                     {k: v for k, v in ref.items() if k != "AFID"})


def test_main_refuses_without_weights_and_runs_with_random_ok(tmp_path,
                                                              capsys):
    """``main`` without ``--weights_dir`` or ``--random-ok`` refuses, as
    the JAX package's; with ``--random-ok --tiny --device cpu`` it scores
    the tree and prints the suffixed aggregates; on the default device
    without a card it raises."""
    dataset = _tree(tmp_path / "tree", n_dialogues=1)
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "story.json").write_text(json.dumps(dataset))
    args = ["--save_dir", str(tmp_path / "tree"), "--dataset_path",
            str(tmp_path / "data")]
    with pytest.raises(SystemExit, match="no --weights_dir"):
        tcmig.main(args)
    with pytest.raises(SystemExit, match="no --weights_dir"):
        jcmig.main(args)
    out = tcmig.main(args + ["--random-ok", "--tiny", "--device", "cpu",
                             "--csv", str(tmp_path / "s.csv")])
    printed = json.loads(capsys.readouterr().out)
    assert list(printed) == list(out)
    assert all(k.endswith("_UNVALIDATED") for k in out)
    assert len(_rows(tmp_path / "s.csv")) == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcmig.main(args + ["--random-ok", "--tiny"])


def test_a_twenty_dialogue_tree(tmp_path):
    """The eval half of a ≥ 20-dialogue run: 20 dialogues, 80 turns,
    scored with the tiny towers and Inception at 96 px; every turn has its
    CSV row and every aggregate its suffix."""
    _, temb = _embedders()
    dataset = _tree(tmp_path / "tree", n_dialogues=20, side=32, seed=2)
    fid = tinc.InceptionEmbedder.random_init(1, size=96, device="cpu")

    class Always:
        def __call__(self, image, phrase):
            return np.array([0.2, 0.2, 0.8, 0.8], np.float32), 1.0, True

    out = tcmig.evaluate_tree(str(tmp_path / "tree"), dataset, temb,
                              detector=Always(), fid_embedder=fid,
                              validated=False,
                              csv_path=str(tmp_path / "s.csv"))
    rows = _rows(tmp_path / "s.csv")
    assert len(rows) == 80 and len({r["dialogue"] for r in rows}) == 20
    assert np.isfinite(out["AFID_UNVALIDATED"])
    assert np.isfinite(out["ACCS_UNVALIDATED"])
    assert 0.0 <= out["numeracy_UNVALIDATED"] <= 1.0
    shutil.rmtree(tmp_path / "tree")
