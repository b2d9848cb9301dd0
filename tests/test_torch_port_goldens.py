"""The golden kit of the port (``eval/goldens.py``) against the JAX
package's, on the CPU: the on-disk format read and written both ways, the
port consuming cases of all five kinds that the JAX package's own
exporters (``scripts/golden_parity.py``) wrote from tiny bundles whose
weights the port carries (``load_flax``), and planted bugs failing the
verdict in both packages.

Tolerances: a case written by one package and read by the other is equal
bit for bit (the same ``.npy`` files; the image through one PNG).  The
port's run of a JAX case must reach ``final_rel_mse`` ≤ 1e-8 (fp32 on both
sides; the loops differ only in summation order) and PSNR ≥ 50 dB (the PNG's
8-bit rounding bounds it near 53 dB); a planted bug must exceed 0.1, twice
the verdict's own bound, in both packages, and the two must agree to
1e-4.
"""

import dataclasses
import functools
import importlib.util
import os
import pathlib

import jax
import numpy as np
import pytest
import torch

from theatergen_tpu.config import tiny_config as j_tiny
from theatergen_tpu.config import tiny_xl_config as j_tiny_xl
from theatergen_tpu.eval import goldens as JGD
from theatergen_tpu.pipelines.bundle import init_bundle as j_init_bundle
from theatergen_tpu_torch.config import tiny_config, tiny_xl_config
from theatergen_tpu_torch.eval import goldens as TGD
from theatergen_tpu_torch.pipelines.bundle import init_bundle

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REL_TOL = 1e-8


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_golden_parity", ROOT / "scripts" / "golden_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _seeded(bundle, seed, fields):
    """The JAX bundle (built abstract: shapes only) with each of ``fields``
    given seeded numpy leaves, as ``test_torch_port_models.random_params``
    draws them."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        if path[-1].key == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if path[-1].key == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return dataclasses.replace(bundle, **{
        f: jax.tree_util.tree_map_with_path(leaf, getattr(bundle, f))
        for f in fields})


@functools.lru_cache(maxsize=None)
def _bundles():
    """(JAX SD1.5, port SD1.5, JAX SDXL, port SDXL) tiny bundles on seeded
    weights, the port's carrying the JAX trees (SD1.5: UNet, IP UNet,
    ControlNet, text and vision towers, projector, VAE; SDXL: UNet, both
    towers, VAE)."""
    jb = _seeded(j_init_bundle(j_tiny(), jax.random.key(0), with_ip=True,
                               with_controlnet=True, with_vision=True,
                               abstract=True), 0,
                 ("unet_params", "unet_ip_params", "text_params",
                  "vision_params", "image_proj_params", "controlnet_params",
                  "vae_params"))
    tb = init_bundle(tiny_config(), 0, device="cpu", with_ip=True,
                     with_controlnet=True, with_vision=True).load_flax(
        unet=jb.unet_params, unet_ip=jb.unet_ip_params, text=jb.text_params,
        vision=jb.vision_params, image_proj=jb.image_proj_params,
        controlnet=jb.controlnet_params, vae=jb.vae_params)
    jxl = _seeded(j_init_bundle(j_tiny_xl(), jax.random.key(1),
                                abstract=True), 1,
                  ("unet_params", "text_params", "text2_params",
                   "vae_params"))
    txl = init_bundle(tiny_xl_config(), 1, device="cpu").load_flax(
        unet=jxl.unet_params, text=jxl.text_params, text2=jxl.text2_params,
        vae=jxl.vae_params)
    return jb, tb, jxl, txl


EXPORTERS = {"text2img": "_export_self_text2img",
             "character_ip": "_export_self_character",
             "final_cn": "_export_self_final",
             "sdxl": "_export_self_sdxl",
             "sdxl_ea": "_export_self_sdxl_ea"}


@functools.lru_cache(maxsize=None)
def _jax_cases(root: str) -> str:
    """Every kind's case, written by the JAX package's exporters."""
    script = _jax_script()
    jb, _, jxl, _ = _bundles()
    for kind, fn in EXPORTERS.items():
        getattr(script, fn)(root, jxl if kind.startswith("sdxl") else jb)
    return root


@pytest.fixture(scope="module")
def jax_cases(tmp_path_factory):
    return _jax_cases(str(tmp_path_factory.mktemp("jax_goldens")))


def _pair(kind):
    jb, tb, jxl, txl = _bundles()
    return (jxl, txl) if kind.startswith("sdxl") else (jb, tb)


def _full_case(rng):
    """Every field of the format, random."""
    f = functools.partial(lambda *s: rng.rand(*s).astype(np.float32))
    return dict(prompt="a knight", negative="lowres", num_steps=3,
                guidance_scale=5.0, seed=9, model="sd15", kind="final_cn",
                ip_scale=0.25, frozen_steps=2, controlnet_scale=0.8,
                init_latents=f(1, 8, 8, 4), context=f(2, 20, 32),
                trajectory=f(4, 1, 8, 8, 4), image=f(64, 64, 3),
                image_embeds=f(1, 32), cn_context=f(2, 16, 32),
                cond_image=f(64, 64, 3), latents_all=f(4, 1, 8, 8, 4),
                frozen_mask=(f(8, 8) > 0.5).astype(np.float32),
                pooled=f(2, 32), time_ids=f(2, 6), step_noise=f(3, 1, 8, 8, 4))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_format_round_trips_both_ways(tmp_path, writer):
    """A case with every field, written by one package and read by both:
    the same GoldenCase (NCHW on disk, NHWC at load), the image through
    one PNG round trip."""
    fields = _full_case(np.random.RandomState(0))
    (JGD if writer == "jax" else TGD).save_case(str(tmp_path), "c", **fields)
    raw = np.load(tmp_path / "c" / "latents_all.npy")
    assert raw.shape == (4, 1, 4, 8, 8)
    assert TGD.list_cases(str(tmp_path)) == JGD.list_cases(str(tmp_path))
    jc, tc = (JGD.load_case(str(tmp_path), "c"),
              TGD.load_case(str(tmp_path), "c"))
    for f in dataclasses.fields(JGD.GoldenCase):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name
    for name in ("init_latents", "trajectory", "latents_all", "step_noise",
                 "context", "pooled"):
        np.testing.assert_array_equal(getattr(tc, name), fields[name])
    np.testing.assert_allclose(tc.image, fields["image"], atol=1 / 255)


def test_load_case_refuses_an_unknown_kind(tmp_path):
    fields = _full_case(np.random.RandomState(1))
    TGD.save_case(str(tmp_path), "c", **fields)
    meta = tmp_path / "c" / "meta.json"
    meta.write_text(meta.read_text().replace('"final_cn"', '"video"'))
    with pytest.raises(ValueError, match="unknown golden kind"):
        TGD.load_case(str(tmp_path), "c")


@pytest.mark.parametrize("kind", sorted(EXPORTERS))
def test_port_consumes_jax_cases(jax_cases, kind):
    """The port's runner of each kind on the JAX package's exported case:
    the trajectory within REL_TOL of the record, the image within the
    PNG's rounding, the verdict True as the JAX package's own run; the
    isolation modes (own text encoder, own projector) too."""
    jb, tb = _pair(kind)
    name = f"self_{kind}"
    case = TGD.load_case(jax_cases, name)
    assert case.kind == kind
    res = TGD.run_case(tb, case)
    jres = JGD.run_case(jb, JGD.load_case(jax_cases, name))
    assert res["final_rel_mse"] <= REL_TOL, res
    assert res["image_psnr_db"] >= 50.0, res
    assert TGD.verdict(res) and JGD.verdict(jres)
    assert {k for k in res if k != "step_mse"} == set(jres) - {"step_mse"}
    assert len(res["step_mse"]) == case.num_steps + 1
    own = {"text2img": {"use_own_text_encoder": True},
           "character_ip": {"use_own_projector": True}}.get(kind)
    if own:
        res = TGD.run_case(tb, case, **own)
        assert res["context"] in ("own-encoder", "own-projector")
        assert res["final_rel_mse"] <= REL_TOL and TGD.verdict(res)


@pytest.mark.parametrize("kind,bug", TGD.NEGATIVE_CONTROLS)
def test_planted_bugs_fail_in_both_packages(jax_cases, kind, bug):
    """Each negative control (``goldens.plant_bug``) planted in the JAX
    package's case and bundle and in the port's: the verdict False in
    both, the relative MSE over 0.1 and the same in both."""
    jb, tb = _pair(kind)
    name = f"self_{kind}"
    tcase, tbundle = TGD.plant_bug(TGD.load_case(jax_cases, name), tb, bug)
    jcase, jbundle = TGD.plant_bug(JGD.load_case(jax_cases, name), jb, bug)
    res, jres = TGD.run_case(tbundle, tcase), JGD.run_case(jbundle, jcase)
    assert res["final_rel_mse"] > 0.1 and jres["final_rel_mse"] > 0.1, (
        res["final_rel_mse"], jres["final_rel_mse"])
    assert not TGD.verdict(res) and not JGD.verdict(jres)
    np.testing.assert_allclose(res["final_rel_mse"], jres["final_rel_mse"],
                               rtol=1e-4)


def test_export_self_case_is_read_by_the_jax_package(tmp_path):
    """A case the port writes from its own pipeline (final_cn, every
    array of the format) loads in the JAX package as in the port, and the
    JAX package's runner reproduces its trajectory."""
    _, tb, _, _ = _bundles()
    jb = _bundles()[0]
    name = TGD.export_self_case(tb, str(tmp_path), "final_cn", num_steps=3,
                                seed=4)
    jc, tc = (JGD.load_case(str(tmp_path), name),
              TGD.load_case(str(tmp_path), name))
    np.testing.assert_array_equal(jc.latents_all, tc.latents_all)
    assert jc.frozen_steps == tc.frozen_steps == 1
    jres = JGD.run_case(jb, jc)
    assert jres["final_rel_mse"] <= REL_TOL and JGD.verdict(jres)
    assert os.path.exists(tmp_path / name / "image.png")


def test_psnr_and_verdict_edges():
    a = np.zeros((4, 4, 3), np.float32)
    assert TGD.psnr(a, a) == JGD.psnr(a, a) == float("inf")
    b = a + 0.1
    assert TGD.psnr(a, b) == JGD.psnr(a, b)
    for m in ({"final_rel_mse": 0.05}, {"final_rel_mse": 0.0501},
              {"final_rel_mse": 0.0, "image_psnr_db": 24.9}, {}):
        assert TGD.verdict(m) == JGD.verdict(m)
