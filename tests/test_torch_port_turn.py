"""A whole story turn on the CPU: the port's Theater.run_turn against the JAX
package's, and the port's CLI.

Both Theaters run the tiny config on the same random weights (text tower,
vision tower, IP projector, IP UNet, ControlNet, VAE; 4 DDIM steps) over
``dialogue_0`` of ``data/sample/story.json``, each with its own character
DB.  The random draws cannot match across the two frameworks, so both
sides take their noise from the same numpy stream at the method level:
the JAX Theater's ``_char_lat_fn`` and ``sd.seeded_latents``, the port's
``_char_input_latents`` and ``_bg_latents``.  The JAX package's
``align_with_boxes`` shifts a trajectory's (w, C) axes (ROADMAP §3); here
it is patched to shift (h, w), as the port and the reference do.  And its
composition program runs eagerly: jitted, XLA's CPU compiler contracts the
collage's sample position ``(o + 0.5)·inv − t·inv`` into a fused
multiply-add, so where a layout box edge falls on an exact pixel boundary
(dialogue_0's boxes are whole pixels of a 512 canvas) the sample lands a
rounding step below −0.5 and the jitted collage drops a column that the
exact arithmetic, eager JAX and the port keep (ROADMAP §3).
"""

import dataclasses
import functools
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu import db as jdb
from theatergen_tpu import theater as jth
from theatergen_tpu.models.clip import CLIPTextEncoder as JText
from theatergen_tpu.models.clip import CLIPVisionEncoder as JVision
from theatergen_tpu.models.controlnet import ControlNet as JControlNet
from theatergen_tpu.models.ip_adapter import ImageProjModel as JImageProj
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.ops import latents as JL
from theatergen_tpu.ops.lineart import LineartGenerator as JLineartGenerator
from theatergen_tpu.perception import sam_hf as jsam_hf
from theatergen_tpu.perception.sam import SAMLite as JSAMLite
from theatergen_tpu.perception.sam_hf import SamHF as JSamHF
from theatergen_tpu.perception import detector as jdet
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch import db as tdb
from theatergen_tpu_torch import theater as tth
from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.ops import latents as TL
from theatergen_tpu_torch.perception import sam as tsam
from theatergen_tpu_torch.pipelines.bundle import (build_lineart, build_sam,
                                                   init_bundle, sam_hf_config)
from theatergen_tpu_torch.utils import png

from test_torch_port_models import random_params

torch.set_num_threads(1)

CFG = jcfg.tiny_config()
PL = CFG.pipeline
h = w = PL.latent_height
STEPS = 4
DATA = pathlib.Path(__file__).resolve().parent.parent / "data" / "sample"
# image-space bound: fp32 through a 4-step character pass (CFG 7.5
# amplifies each step's eps difference), a CLIP encode of its image, the
# composition and a 4-step ControlNet final pass, then the VAE decode
# (4e-6 measured)
IMG_TOL = 1e-4


def _bundles(perception: str = ""):
    """A JAX bundle and the port's bundle on the same random weights, one
    pair per ``perception``: a segmenter ("sam_lite", "sam_hf") and/or the
    lineart annotator ("lineart"), "+"-joined, on the same weights too."""
    return _cached_bundles(perception)


@functools.lru_cache(maxsize=None)
def _cached_bundles(perception: str):
    if perception:
        jb, tb = _cached_bundles("")
        return _with_perception(jb, tb, perception)
    zeros = functools.partial(jnp.zeros, dtype=jnp.float32)
    text = JText(CFG.text)
    tp = random_params(text, 3, jnp.zeros((1, 16), jnp.int32))
    unet_ip = JUNet(dataclasses.replace(CFG.unet, ip_num_tokens=4))
    uip = random_params(unet_ip, 1, zeros((1, h, w, 4)),
                        jnp.zeros((1,), jnp.int32), zeros((1, 20, 32)))
    proj = JImageProj(CFG.ip_adapter)
    pp = random_params(proj, 4, zeros((1, CFG.ip_adapter.clip_embeddings_dim)))
    vis = JVision(CFG.vision)
    vp = random_params(vis, 5, zeros((1, 32, 32, 3)))
    cn = JControlNet(CFG.controlnet)
    cp = random_params(cn, 2, zeros((1, h, w, 4)), jnp.zeros((1,), jnp.int32),
                       zeros((1, 16, 32)), zeros((1, PL.height, PL.width, 3)))
    vae = JVAE(CFG.vae)
    vaep = random_params(vae, 6, zeros((1, PL.height, PL.width, 3)))
    jb = JBundle(cfg=CFG, tokenizer=jtok.HashTokenizer(1024), unet=None,
                 unet_params=None, vae=vae, vae_params=vaep, text=text,
                 text_params=tp, unet_ip=unet_ip, unet_ip_params=uip,
                 vision=vis, vision_params=vp, image_proj=proj,
                 image_proj_params=pp, controlnet=cn, controlnet_params=cp)
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu", with_ip=True,
                     with_vision=True, with_controlnet=True).load_flax(
        text=tp, unet_ip=uip, image_proj=pp, vision=vp, controlnet=cp,
        vae=vaep)
    return jb, tb


def _with_perception(jb, tb, perception: str):
    """Copies of the two bundles (the same UNets, towers and caches) with
    the JAX package's SAMLite or SamHF (tiny) and its full-width
    LineartGenerator on seeded weights, and the port's on the same."""
    parts = perception.split("+")
    tb = dataclasses.replace(tb)
    jkw = {}
    if "sam_lite" in parts:
        jsam = JSAMLite(CFG.sam)
        sp = random_params(jsam, 20, jnp.zeros((1, 64, 64, 3)),
                           jnp.zeros((1, 1, 4)))
        tb.sam = build_sam(tcfg.tiny_config(), "cpu")
    if "sam_hf" in parts:
        jsam = JSamHF(jsam_hf.tiny_sam_hf_config())
        sp = random_params(jsam, 21, jnp.zeros((1, 64, 64, 3)),
                           jnp.zeros((1, 1, 4)))
        tb.sam = build_sam(tcfg.tiny_config(), "cpu",
                           hf_cfg=sam_hf_config(tcfg.tiny_config()))
    if tb.sam is not None:
        jkw.update(sam=jsam, sam_params=sp)
        tb.load_flax(sam=sp)
    if "lineart" in parts:
        jl = JLineartGenerator()
        lp = random_params(jl, 22, jnp.zeros((1, PL.height, PL.width, 3)))
        jkw.update(lineart=jl, lineart_params=lp)
        tb.lineart = build_lineart("cpu")
        tb.load_flax(lineart=lp)
    return dataclasses.replace(jb, **jkw), tb


class Noise:
    """A numpy noise stream: the k-th request gets seed 100 + k."""

    def __init__(self):
        self.n = 0

    def draw(self, shape):
        self.n += 1
        return np.random.RandomState(99 + self.n).randn(*shape).astype(
            np.float32)


def _align_hw(orig):
    def align(traj, masks, boxes, **kw):
        t, m, off = orig(jnp.moveaxis(traj, -1, -3), masks, boxes, **kw)
        return jnp.moveaxis(t, -3, -1), m, off
    return align


@pytest.fixture(autouse=True)
def _jax_align_shifts_hw(monkeypatch):
    monkeypatch.setattr(JL, "align_with_boxes", _align_hw(JL.align_with_boxes))


def _theaters(tmp_path, monkeypatch, perception: str = ""):
    """(JAX Theater, port Theater, records) on fresh DBs, fed one noise
    stream each; records hold each side's character records."""
    jb, tb = _bundles(perception) if perception else _bundles()
    jn, tn = Noise(), Noise()
    rec = {"jax": [], "port": []}
    jt = jth.Theater(jb, jdb.CharacterDB(str(tmp_path / "jax_db")),
                     num_steps=STEPS)
    tt = tth.Theater(tb, tdb.CharacterDB(str(tmp_path / "port_db")),
                     num_steps=STEPS)

    def jlat(r0, r1, bx):
        return JL.input_latents_for_boxes(
            None, None, bx, h, w, fg_blending_ratio=PL.fg_blending_ratio,
            init_noise_sigma=1.0, bg_noise=jn.draw((1, h, w, 4)),
            fg_noise=jn.draw((1, 1, h, w, 4)))[0][0]

    jt._char_lat_fn = lambda: jlat

    def compose_eager(*a):
        with jax.disable_jit():
            return jth._compose_program(jb.lineart)(*a)

    monkeypatch.setitem(jb._jits, f"theater_compose_{id(jb.lineart)}",
                        compose_eager)
    monkeypatch.setattr(jsd, "seeded_latents",
                        lambda rng, b, hh, ww, c=4, dtype=None: jnp.asarray(
                            jn.draw((b, hh, ww, c))))

    def tlat(gen, centered):
        return TL.input_latents_for_boxes(
            None, centered[None], h, w,
            fg_blending_ratio=PL.fg_blending_ratio, init_noise_sigma=1.0,
            bg_noise=torch.from_numpy(tn.draw((1, h, w, 4))),
            fg_noise=torch.from_numpy(tn.draw((1, 1, h, w, 4))))[0][0]

    tt._char_input_latents = tlat
    tt._bg_latents = lambda gen: torch.from_numpy(tn.draw((1, h, w, 4)))
    for key, th in (("jax", jt), ("port", tt)):
        finish = th._character_finish

        def spy(*a, _finish=finish, _key=key, **k):
            out = _finish(*a, **k)
            rec[_key].append(out)
            return out
        th._character_finish = spy
    return jt, tt, rec, (jn, tn)


def _np(x):
    return np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x)


def _compare(jr, tr, rec, noise, jt, tt, want_chars):
    assert len(tr.so_images) == len(jr.so_images) == want_chars
    assert tr.detections == jr.detections
    np.testing.assert_allclose(tr.image, np.asarray(jr.image), atol=IMG_TOL)
    np.testing.assert_allclose(tr.collage, np.asarray(jr.collage),
                               atol=IMG_TOL)
    for a, b in zip(tr.so_images, jr.so_images):
        np.testing.assert_allclose(a, np.asarray(b), atol=IMG_TOL)
    assert len(rec["port"]) == len(rec["jax"])
    for rt, rj in zip(rec["port"], rec["jax"]):
        np.testing.assert_array_equal(_np(rt["mask_lat"]), _np(rj["mask_lat"]))
        np.testing.assert_array_equal(_np(rt["mask_pix"]), _np(rj["mask_pix"]))
        assert rt["token_pos"] == rj["token_pos"]
    assert tt.timer.counts() == {k: len(v) for k, v in jt.timer.samples.items()}
    assert noise[0].n == noise[1].n
    jdir, tdir = jt.db.root, tt.db.root
    ids = sorted(int(f[:-4]) for f in os.listdir(jdir) if f.endswith(".png"))
    assert ids == sorted(int(f[:-4]) for f in os.listdir(tdir)
                         if f.endswith(".png"))
    for oid in ids:
        ji, je, _ = jdb.CharacterDB(jdir).lookup(oid)
        ti, te, _ = tdb.CharacterDB(tdir).lookup(oid)
        np.testing.assert_allclose(ti, ji, atol=1 / 255 + 1e-6)
        np.testing.assert_allclose(np.ravel(te), np.ravel(je), atol=1e-4)
    rec["port"].clear()
    rec["jax"].clear()


def _specs():
    data = json.loads((DATA / "story.json").read_text())["dialogue_0"]
    out = []
    for t_idx in range(4):
        spec = tgen.build_spec(data[f"turn {t_idx + 1}"])
        spec["canvas_height"] = spec["canvas_width"] = 512
        out.append(spec)
    return out


def test_run_turn_matches_over_dialogue_0(tmp_path, monkeypatch):
    """The four turns of dialogue_0 in order: turn 1 two DB misses, turn 2
    the knight (a hit), turn 3 the dragon (a hit), turn 4 the dragon (a
    hit) beside a new dragon (obj_id 2: a miss).  Image, character images
    and collage within IMG_TOL, masks and detections equal, DB images
    within one 8-bit step and features 1e-4, phase counts equal."""
    jt, tt, rec, noise = _theaters(tmp_path, monkeypatch)
    hits = [[False, False], [True], [True], [True, False]]
    for t_idx, spec in enumerate(_specs()):
        seed = tgen.turn_seed(0, 0, t_idx, 0)
        jr = jt.run_turn(spec, seed, frozen_step_ratio=0.5)
        tr = tt.run_turn(spec, seed, frozen_step_ratio=0.5)
        assert tr.db_hits == hits[t_idx]
        _compare(jr, tr, rec, noise, jt, tt, len(hits[t_idx]))


@pytest.mark.parametrize("perception", ["sam_lite", "sam_hf", "lineart",
                                        "sam_hf+lineart"])
def test_run_turn_with_perception_matches(tmp_path, monkeypatch, perception):
    """Turns 1 and 4 of dialogue_0 (turn 4: one DB hit, one miss) with a
    segmenter (SAMLite, or the tiny SamHF, its box in pixels) making the
    character masks from the decoded image resized to its side and the
    detection box, and/or the annotator drawing the ControlNet hint: masks
    equal, images within IMG_TOL of the JAX Theater's, SAM run once per
    character.  The JAX segmenter runs jitted (eager, it compiles op by
    op).  On a constant collage (every mask empty) the annotator's
    instance norms divide rounding noise by sqrt(eps) layer after layer
    and two summation orders part at O(1), so the annotator is compared on
    turns whose collage is not constant, which the test asserts."""
    jt, tt, rec, noise = _theaters(tmp_path, monkeypatch, perception)
    assert (tt.bundle.sam is None) == ("sam" not in perception)
    jitted = {}
    real = jth.sam_lib.segment_with_box

    def segment(sam, params, img, box, out_sizes=(64, 512)):
        if out_sizes not in jitted:
            jitted[out_sizes] = jax.jit(lambda p, i, b: real(
                sam, p, i, b, out_sizes=out_sizes))
        return jitted[out_sizes](params, img, box)

    monkeypatch.setattr(jth.sam_lib, "segment_with_box", segment)
    specs = _specs()
    for t_idx in (0, 3):
        seed = tgen.turn_seed(0, 0, t_idx, 0)
        jr = jt.run_turn(specs[t_idx], seed, frozen_step_ratio=0.5)
        before = tsam.segments
        tr = tt.run_turn(specs[t_idx], seed, frozen_step_ratio=0.5)
        chars = len(tr.so_images)
        assert chars == 2
        assert tsam.segments - before == (chars if "sam" in perception
                                          else 0)
        if "lineart" in perception:
            assert tr.collage.std() > 0.01
        _compare(jr, tr, rec, noise, jt, tt, chars)


def test_forced_regeneration_matches(tmp_path, monkeypatch):
    """Turn 1 with the first detection forced to fail in both packages:
    the first character is drawn and run a second time, the results
    agree, and the attempt count shows in char.denoise_decode."""
    jt, tt, rec, noise = _theaters(tmp_path, monkeypatch)
    jb, _ = _bundles()
    compiled = jax.jit(lambda maps: jdet.attention_detect(list(maps), None))
    first = {"jax": True, "port": True}

    def jax_detect(maps):
        d = compiled(maps)
        if first["jax"]:
            first["jax"] = False
            return dataclasses.replace(d, ok=jnp.asarray(False))
        return d

    real = tth.det.attention_detect

    def port_detect(maps, word=None):
        d = real(maps, word)
        if first["port"]:
            first["port"] = False
            return dataclasses.replace(d, ok=torch.tensor(False))
        return d

    monkeypatch.setitem(jb._jits, "attn_detect", jax_detect)
    monkeypatch.setattr(tth.det, "attention_detect", port_detect)
    spec = _specs()[0]
    jr = jt.run_turn(spec, 7)
    tr = tt.run_turn(spec, 7)
    assert tt.timer.counts()["char.denoise_decode"] >= 3
    _compare(jr, tr, rec, noise, jt, tt, 2)
    assert noise[1].n == 2 * 3 + 1     # three attempts' draws, one bg


def test_dedup_turn_matches(tmp_path, monkeypatch):
    """Turn 4 with both dragons under obj_id 1: one generation serves both
    slots (a DB miss on a fresh DB)."""
    jt, tt, rec, noise = _theaters(tmp_path, monkeypatch)
    spec = dict(_specs()[3], obj_ids=[1, 1])
    jr = jt.run_turn(spec, 3)
    tr = tt.run_turn(spec, 3)
    assert tr.db_hits == [False, False]
    np.testing.assert_array_equal(tr.so_images[0], tr.so_images[1])
    assert tt.timer.counts()["character"] == 1
    _compare(jr, tr, rec, noise, jt, tt, 2)


def test_background_only_turn_matches(tmp_path, monkeypatch):
    """A turn without characters: plain txt2img on the overall prompt
    through the IP UNet at scale 0; the image is also the collage."""
    jt, tt, rec, noise = _theaters(tmp_path, monkeypatch)
    spec = dict(_specs()[2], gen_boxes=[], obj_ids=[])
    jr = jt.run_turn(spec, 5)
    tr = tt.run_turn(spec, 5)
    assert tr.so_images == [] and tr.detections == [] and tr.db_hits == []
    np.testing.assert_array_equal(tr.image, tr.collage)
    _compare(jr, tr, rec, noise, jt, tt, 0)


def test_pending_save_is_a_hit_and_frozen_steps(tmp_path, monkeypatch):
    """A character saved earlier in the same turn (its write deferred) is a
    hit served from the device; frozen steps follow
    min(round(ratio·steps), schedule length)."""
    _, tt, _, _ = _theaters(tmp_path, monkeypatch)
    spec = dict(_specs()[3], obj_ids=[1, 1], gen_boxes=[
        ("a green dragon", (80, 60, 150, 220)),
        ("a green dragon ", (290, 100, 150, 220))])
    seen = []
    real = tt.final_run
    tt.final_run = lambda *a, **k: seen.append(a[2]) or real(*a, **k)
    res = tt.run_turn(spec, 1, frozen_step_ratio=2.0)
    assert res.db_hits == [False, True]
    assert seen == [STEPS]
    assert tdb.CharacterDB(tt.db.root).has(1)


def test_character_runner_captures_the_word_token(tmp_path, monkeypatch):
    """The runner captures the reference maps at the given word token, as
    the JAX runner does at gin.word_token[0] (theatergen_tpu
    pipelines/character.py:178): maps 1e-5 apart at token 5, and not the
    token-0 maps the runner gave before it took a word token."""
    jt, tt, _, _ = _theaters(tmp_path, monkeypatch)
    jb, _ = _bundles()
    rng = np.random.RandomState(8)
    lat = rng.randn(1, h, w, 4).astype(np.float32)
    ctx = rng.randn(2, 20, 32).astype(np.float32)
    gin = jt._guidance_inputs([(0.0, 0.0, 1.0, 1.0)], [[3, 4, 5]])
    assert int(gin.word_token[0]) == 5
    res_j = jt.char_run(jb.unet_ip_params, jnp.asarray(lat), jnp.asarray(ctx),
                        jnp.float32(0.4), gin)
    res_t = tt.char_run(torch.from_numpy(lat), torch.from_numpy(ctx), 0.4,
                        word_token=5)
    res_0 = tt.char_run(torch.from_numpy(lat), torch.from_numpy(ctx), 0.4)
    for mt, mj, m0 in zip(res_t.ref_attn, res_j.ref_attn, res_0.ref_attn):
        np.testing.assert_allclose(_np(mt), np.asarray(mj), atol=1e-5)
        assert float((mt - m0).abs().max()) > 1e-3


def test_theater_refuses_unported_modes():
    _, tb = _bundles()
    db = None
    for kw in (dict(mesh=object()), dict(batch_characters=True)):
        with pytest.raises(NotImplementedError):
            tth.Theater(tb, db, **kw)
    with pytest.raises(ValueError):
        tth.Theater(init_bundle(tcfg.tiny_config(), 0, device="cpu"), db)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(tmp_path, *extra):
    return ["--tiny", "--device", "cpu", "--dataset_path", str(DATA),
            "--max_dialogues", "1", "--num_steps", "2",
            "--base_save_dir", str(tmp_path / "out"),
            "--database_path_base", str(tmp_path / "db"), *extra]


def _log(tmp_path):
    path = tmp_path / "out" / "story" / "run0" / "run_log.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_tree_log_and_resume(tmp_path):
    """One dialogue: the output tree, the DB, run_log.jsonl's turn,
    dialogue and summary events; a second run writes nothing new."""
    tgen.main(_cli(tmp_path))
    run = tmp_path / "out" / "story" / "run0" / "dialogue_0"
    chars = [2, 1, 1, 2]
    for t_idx, n in enumerate(chars):
        files = sorted(os.listdir(run / f"turn {t_idx + 1}"))
        assert files == ["img_0.png"] + [f"so_0_{i}.png" for i in range(n)]
        img = png.read_png(str(run / f"turn {t_idx + 1}" / "img_0.png"))
        assert img.shape == (PL.height, PL.width, 3)
    db = tmp_path / "db" / "story" / "dialogue_0"
    assert sorted(f for f in os.listdir(db) if f.endswith(".png")) == [
        "0.png", "1.png", "2.png"]
    events = _log(tmp_path)
    turns = [e for e in events if e["event"] == "turn"]
    assert [e["turn"] for e in turns] == [f"turn {i}" for i in range(1, 5)]
    assert [e["characters"] for e in turns] == chars
    assert [e["db_hits"] for e in turns] == [[False, False], [True], [True],
                                             [True, False]]
    assert [e["seed"] for e in turns] == [tgen.turn_seed(0, 0, i, 0)
                                          for i in range(4)]
    (dia,) = [e for e in events if e["event"] == "dialogue"]
    assert dia["phase_summary"]["final"]["count"] == 4
    assert events[-1]["event"] == "summary"
    before = sorted(p for p in (tmp_path / "out").rglob("*.png"))
    mtimes = [p.stat().st_mtime_ns for p in before]
    tgen.main(_cli(tmp_path))
    after = sorted(p for p in (tmp_path / "out").rglob("*.png"))
    assert after == before and [p.stat().st_mtime_ns for p in after] == mtimes
    assert [e["event"] for e in _log(tmp_path)[len(events):]] == [
        "dialogue", "summary"]


def test_cli_quarantines_a_failing_turn(tmp_path, monkeypatch):
    """A turn that raises is logged as quarantined, leaves no turn
    directory, and the next turn runs."""
    real = tth.Theater.run_turn

    def run_turn(self, spec, seed, **kw):
        if spec["prompt"].startswith("the red knight"):
            raise RuntimeError("boom")
        return real(self, spec, seed, **kw)

    monkeypatch.setattr(tth.Theater, "run_turn", run_turn)
    tgen.main(_cli(tmp_path))
    run = tmp_path / "out" / "story" / "run0" / "dialogue_0"
    assert not (run / "turn 2").exists() and (run / "turn 3").exists()
    events = _log(tmp_path)
    (q,) = [e for e in events if e["event"] == "quarantine"]
    assert q["turn"] == "turn 2" and "boom" in q["error"]
    assert [e["turn"] for e in events if e["event"] == "turn"] == [
        "turn 1", "turn 3", "turn 4"]


@pytest.mark.parametrize("flag", [
    ["--dp_dialogues", "2"], ["--mesh", "dp=2"], ["--batch_chars"]])
def test_cli_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgen.main(_cli(tmp_path, *flag))
    assert not (tmp_path / "out").exists()


def _weights_dir(tmp_path):
    """A synthetic checkpoint directory in the published names (fp16, as
    most SD1.5 files ship) from a seeded tiny bundle, with the tiny SamHF
    and the annotator."""
    from theatergen_tpu_torch.models import export

    cfg = tcfg.tiny_config()
    b = init_bundle(cfg, 9, device="cpu", with_ip=True, with_vision=True,
                    with_controlnet=True)
    b.sam = build_sam(cfg, "cpu", torch.Generator().manual_seed(10),
                      hf_cfg=sam_hf_config(cfg))
    b.lineart = build_lineart("cpu", torch.Generator().manual_seed(11))
    d = tmp_path / "weights"
    export.export_checkpoint_dir(b, str(d))
    return str(d), b


def _pngs(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*.png"))}


def test_cli_weights_and_snapshot(tmp_path, monkeypatch, capsys):
    """``--weights DIR --snapshot SNAP``: the bundle loads from the
    directory (SamHF and the annotator on the turn's path, each module the
    fp16 file's), runs dialogue_0 whole and is saved; a second run with
    ``--snapshot SNAP`` loads it back and writes the same PNGs byte for
    byte, SAM running once per character in each."""
    d, src = _weights_dir(tmp_path)
    snap = str(tmp_path / "snap")
    seen = []
    real = tgen.build_theater
    monkeypatch.setattr(tgen, "build_theater",
                        lambda args: seen.append(real(args)) or seen[-1])
    trees = []
    for run, flags in enumerate((["--weights", d, "--snapshot", snap],
                                 ["--snapshot", snap])):
        before = tsam.segments
        tgen.main(_cli(tmp_path / f"run{run}", *flags))
        out = capsys.readouterr().out
        assert ("bundle snapshot saved" in out) == (run == 0)
        assert ("loading bundle snapshot" in out) == (run == 1)
        b = seen[-1]
        assert type(b.sam).__name__ == "SamHF" and b.lineart is not None
        assert torch.equal(b.sam.mask_decoder.iou_token.weight,
                           src.sam.mask_decoder.iou_token.weight)
        assert torch.equal(b.unet.conv_in.weight,
                           src.unet.conv_in.weight.half().float())
        root = tmp_path / f"run{run}"
        events = [json.loads(line) for line in (
            root / "out" / "story" / "run0" / "run_log.jsonl"
        ).read_text().splitlines()]
        turns = [e for e in events if e["event"] == "turn"]
        assert [e["characters"] for e in turns] == [2, 1, 1, 2]
        assert not [e for e in events if e["event"] == "quarantine"]
        assert tsam.segments - before == 6
        trees.append(_pngs(root / "out"))
    assert trees[0] and trees[0] == trees[1]


def test_cli_snapshot_of_random_weights(tmp_path, capsys):
    """``--snapshot`` without ``--weights`` saves the random-weight
    bundle, and the next run loads it: the same PNGs byte for byte."""
    snap = str(tmp_path / "snap")
    trees = []
    for run in range(2):
        tgen.main(_cli(tmp_path / f"run{run}", "--snapshot", snap))
        out = capsys.readouterr().out
        assert ("loading bundle snapshot" in out) == (run == 1)
        trees.append(_pngs(tmp_path / f"run{run}" / "out"))
    assert len(trees[0]) == 10 and trees[0] == trees[1]


def test_cli_sd_version_xl_runs(tmp_path, monkeypatch):
    """``--sd_version xl --tiny --device cpu``: the tiny XL bundle with
    the T2I-Adapter and no ControlNet, as the JAX CLI builds it, writes
    dialogue_0's 4-turn tree (16² images), the DB and the run log."""
    seen = []
    real = tgen.build_theater
    monkeypatch.setattr(tgen, "build_theater",
                        lambda args: seen.append(real(args)) or seen[-1])
    tgen.main(_cli(tmp_path, "--sd_version", "xl"))
    (b,) = seen
    assert b.cfg.unet.addition_embed_type == "text_time"
    assert b.t2i_adapter is not None and b.controlnet is None
    run = tmp_path / "out" / "story" / "run0" / "dialogue_0"
    chars = [2, 1, 1, 2]
    for t_idx, n in enumerate(chars):
        files = sorted(os.listdir(run / f"turn {t_idx + 1}"))
        assert files == ["img_0.png"] + [f"so_0_{i}.png" for i in range(n)]
        img = png.read_png(str(run / f"turn {t_idx + 1}" / "img_0.png"))
        assert img.shape == (16, 16, 3)
    db = tmp_path / "db" / "story" / "dialogue_0"
    assert sorted(f for f in os.listdir(db) if f.endswith(".png")) == [
        "0.png", "1.png", "2.png"]
    events = _log(tmp_path)
    turns = [e for e in events if e["event"] == "turn"]
    assert [e["db_hits"] for e in turns] == [[False, False], [True], [True],
                                             [True, False]]
    assert not [e for e in events if e["event"] == "quarantine"]
    assert [e["event"] for e in events][-2:] == ["dialogue", "summary"]


@pytest.mark.parametrize("flag,part,field,value", [
    (["--profile"], None, None, None),
    (["--cfg_cutoff", "0.5"], "pipeline", "cfg_cutoff_fraction", 0.5),
    (["--deepcache", "2"], "pipeline", "deepcache_interval", 2),
    (["--cn_interval", "2"], "pipeline", "controlnet_interval", 2),
    (["--scheduler", "lcm"], "pipeline", "scheduler_type", "lcm"),
    (["--prediction_type", "v_prediction"], "scheduler", "prediction_type",
     "v_prediction"),
    (["--zero_snr"], "scheduler", "rescale_zero_terminal_snr", True)])
def test_cli_knob_flags_run(tmp_path, monkeypatch, flag, part, field, value):
    """Each knob flag of the JAX package's CLI reaches the bundle's config and
    the dialogue runs whole: every turn's images, the DB and the run log's
    turn, dialogue and summary events.  ``--profile`` leaves a trace of
    the first dialogue under <save dir>/profile."""
    seen = []
    real = tgen.build_theater
    monkeypatch.setattr(tgen, "build_theater",
                        lambda args: seen.append(real(args)) or seen[-1])
    tgen.main(_cli(tmp_path, *flag))
    if part is not None:
        assert getattr(getattr(seen[0].cfg, part), field) == value
    run = tmp_path / "out" / "story" / "run0" / "dialogue_0"
    chars = [2, 1, 1, 2]
    for t_idx, n in enumerate(chars):
        files = sorted(os.listdir(run / f"turn {t_idx + 1}"))
        assert files == ["img_0.png"] + [f"so_0_{i}.png" for i in range(n)]
    events = _log(tmp_path)
    assert [e["turn"] for e in events if e["event"] == "turn"] == [
        f"turn {i}" for i in range(1, 5)]
    assert not [e for e in events if e["event"] == "quarantine"]
    assert [e["event"] for e in events][-2:] == ["dialogue", "summary"]
    trace = tmp_path / "out" / "story" / "run0" / "profile"
    if flag == ["--profile"]:
        assert (trace / "trace.json").stat().st_size > 0
    else:
        assert not trace.exists()


def test_cli_defaults_to_the_card():
    args = tgen.make_parser().parse_args([])
    assert args.device == "cuda" and not args.tiny
