"""The port's checkpoint files and key maps against the JAX package's
``models/weights.py`` on the CPU.

- The safetensors reader and writer in both directions against the JAX
  package's (F32, F16 and the integer dtypes; BF16 read back by the JAX
  reader as fp32) and against the ``safetensors`` package; ``.bin``
  pickles; bit for bit.
- Each ``port_*`` against the JAX ``port_*`` followed by ``from_flax``, on
  seeded state dicts in the published names: the same entries, bit for
  bit.  The dicts come from ``models/export.py::published_state_dicts``
  of a seeded tiny bundle; the full-size manifests of
  ``test_checkpoint_manifest.py`` (written from the published formats, not from either package's maps)
  then pin the names: the port's maps consume every manifest key and
  cover every parameter of the port's modules, shape for shape (zero-stride
  placeholders, modules on the meta device: nothing of GB size is
  allocated).
- ``load_bundle`` on a synthetic tiny directory against the JAX
  package's: every module equal to ``from_flax`` of its tree, exactly; the
  IP variant's inference, the warning for missing parts and the refusal
  of OWL-ViT's file.
"""

import dataclasses
import functools
import os
import re
from unittest import mock

import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models import weights as JW
from theatergen_tpu.pipelines import bundle as jbundle
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models import export as TE
from theatergen_tpu_torch.models import weights as TW
from theatergen_tpu_torch.pipelines.bundle import (build_lineart, build_sam,
                                                   init_bundle, sam_hf_config)

import test_checkpoint_manifest as manifests

torch.set_num_threads(1)

CFG = tcfg.tiny_config()


def _np(x):
    return np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x)


def _equal(port: dict, ref: dict):
    """Same keys, and every array equal bit for bit (compared in fp32)."""
    assert set(port) == set(ref), (sorted(set(ref) - set(port))[:5],
                                   sorted(set(port) - set(ref))[:5])
    for k, v in ref.items():
        np.testing.assert_array_equal(_np(port[k]), _np(v), err_msg=k)


# ------------------------------------------------------------------ files

DTYPES = [np.float32, np.float16, np.int64, np.int32, np.uint8, np.bool_]


def _arrays(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = (3, 5, 2)[: 1 + i % 3]
        if dt == np.bool_:
            out[f"t{i}.b"] = rng.rand(*shape) > 0.5
        elif np.issubdtype(dt, np.integer):
            out[f"t{i}.i"] = rng.randint(0, 200, shape).astype(dt)
        else:
            out[f"t{i}.f"] = rng.randn(*shape).astype(dt)
    out["scalar"] = np.array(1.5, np.float32)
    out["empty"] = np.zeros((0, 3), np.float16)
    return out


def test_port_writer_jax_reader(tmp_path):
    """Every dtype the JAX reader knows, and BF16 (which it widens to
    fp32), written by the port and read by the JAX package."""
    arrays = _arrays(0)
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors["half.bf16"] = torch.randn(4, 3, generator=torch.Generator(
        ).manual_seed(1)).to(torch.bfloat16)
    path = str(tmp_path / "a.safetensors")
    TW.save_safetensors(path, tensors)
    got = JW.load_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in tensors.items():
        assert got[k].shape == tuple(v.shape), k
        np.testing.assert_array_equal(got[k], _np(v) if v.dtype in (
            torch.bfloat16,) else v.numpy(), err_msg=k)
        if v.dtype != torch.bfloat16:
            assert got[k].dtype == v.numpy().dtype, k


def test_jax_writer_port_reader(tmp_path):
    """The JAX writer pads nothing, so most tensors sit at offsets that are
    no multiple of their element size: the port copies those, and reads
    every dtype back bit for bit."""
    arrays = _arrays(2)
    path = str(tmp_path / "b.safetensors")
    JW.save_safetensors(path, arrays)
    got = TW.load_safetensors(path)
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_safetensors_package_agrees(tmp_path):
    """Files of the ``safetensors`` package (the published format, BF16,
    I8, I16 and F64 included) read by the port, and the port's files read
    by the package."""
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(3)
    tensors = {"a.bf16": torch.randn(5, 7, generator=g).to(torch.bfloat16),
               "b.f64": torch.randn(3, generator=g).double(),
               "c.i8": torch.randint(-100, 100, (4, 4), generator=g,
                                     dtype=torch.int8),
               "d.i16": torch.randint(-999, 999, (6,), generator=g,
                                      dtype=torch.int16),
               "e.f16": torch.randn(2, 3, generator=g).half()}
    ref_path = str(tmp_path / "ref.safetensors")
    st.save_file(tensors, ref_path, metadata={"format": "pt"})
    for k, v in TW.load_safetensors(ref_path).items():
        assert v.dtype == tensors[k].dtype and torch.equal(v, tensors[k]), k
    ours = str(tmp_path / "ours.safetensors")
    TW.save_safetensors(ours, tensors)
    for k, v in st.load_file(ours).items():
        assert v.dtype == tensors[k].dtype and torch.equal(v, tensors[k]), k


def test_torch_bin_flattens_like_jax(tmp_path):
    """A nested ``.bin`` (the IP-Adapter file's layout) flattens into the
    same dotted names and values as the JAX reader's (which widens to
    fp32); the port keeps each dtype."""
    g = torch.Generator().manual_seed(4)
    nested = {"image_proj": {"proj.weight": torch.randn(8, 4, generator=g)
                             .half(), "norm.bias": torch.randn(2, generator=g)},
              "ip_adapter": {"1.to_k_ip.weight": torch.randn(3, 2,
                                                             generator=g)}}
    path = str(tmp_path / "ip.bin")
    torch.save(nested, path)
    port, ref = TW.load_state_dict(path), JW.load_state_dict(path)
    assert port["image_proj.proj.weight"].dtype == torch.float16
    _equal(port, ref)


# ----------------------------------------- published names: tiny parity

@pytest.fixture(scope="module")
def published():
    """Published-name state dicts of seeded tiny bundles (fp16, SAM and
    the annotator fp32): SD1.5 with SamHF and the annotator, its VAE also
    in the current attention names, each IP variant's file, and the tiny
    XL UNet (Linear projections) and its second tower."""
    b = init_bundle(CFG, 3, device="cpu", with_ip=True, with_vision=True,
                    with_controlnet=True)
    b.sam = build_sam(CFG, "cpu", torch.Generator().manual_seed(5),
                      hf_cfg=sam_hf_config(CFG))
    b.lineart = build_lineart("cpu", torch.Generator().manual_seed(6),
                              base=8, n_res=2)
    out = {"sd15": TE.published_state_dicts(b)}
    legacy = {"query": "to_q", "key": "to_k", "value": "to_v",
              "proj_attn": "to_out.0"}
    out["modern_vae"] = {
        re.sub(r"\.(query|key|value|proj_attn)\.",
               lambda m: f".{legacy[m[1]]}.", k): v
        for k, v in out["sd15"]["vae.safetensors"].items()}
    for variant in ("plus", "full"):
        bv = init_bundle(CFG, 4, device="cpu", with_ip=True,
                         ip_variant=variant)
        out[variant] = TE.published_state_dicts(bv)
    xl = init_bundle(tcfg.tiny_xl_config(), 7, device="cpu", with_ip=True)
    out["xl"] = TE.published_state_dicts(xl)
    out["bundles"] = {"sd15": b, "xl": xl}
    return out


def _np_dict(sd):
    return {k: _np(v) for k, v in sd.items()}


@pytest.mark.parametrize("case,fname,port,jport,kind", [
    ("sd15", "unet.safetensors", "port_unet", "port_unet", "unet"),
    ("xl", "unet.safetensors", "port_unet", "port_unet", "unet"),
    ("sd15", "vae.safetensors", "port_vae", "port_vae", "vae"),
    ("modern_vae", None, "port_vae", "port_vae", "vae"),
    ("sd15", "text_encoder.safetensors", "port_clip_text", "port_clip_text",
     "text"),
    ("xl", "text_encoder_2.safetensors", "port_clip_text", "port_clip_text",
     "text"),
    ("sd15", "controlnet.safetensors", "port_controlnet", "port_controlnet",
     "controlnet"),
    ("sd15", "image_encoder.safetensors", "port_clip_vision",
     "port_clip_vision", "vision"),
    ("sd15", "sam.safetensors", "port_sam", "port_sam", "sam_hf"),
    ("sd15", "lineart.safetensors", "port_lineart", "port_lineart",
     "lineart"),
])
def test_port_maps_match_jax(published, case, fname, port, jport, kind):
    """The port's map of a published dict equals from_flax of the JAX
    map's tree: the same entries (what the JAX map ignores, dropped),
    bit for bit.  The VAE in its 2022-era and current names, proj_in/out
    as 1×1 convolutions (SD1.5) and as Linears (XL), the text tower with
    HF's position_ids (ignored by both)."""
    sd = published[case] if fname is None else published[case][fname]
    sd = dict(sd)
    if kind == "text":
        sd["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    ported = getattr(TW, port)(sd)
    ref = TW.from_flax(kind, getattr(JW, jport)(_np_dict(sd)))
    _equal(ported, ref)
    if case == "xl" and kind == "unet":
        assert any(v.ndim == 2 for k, v in sd.items() if "proj_in" in k)
    if case == "sd15" and kind == "vae":
        assert any(".query." in k for k in sd)


@pytest.mark.parametrize("variant,port,jport,kind", [
    ("sd15", "port_image_proj", "port_image_proj", "image_proj"),
    ("plus", "port_resampler", "port_resampler", "resampler"),
    ("full", "port_mlp_proj", "port_mlp_proj", "mlp_proj")])
def test_projector_maps_match_jax(published, variant, port, jport, kind):
    """Each IP variant's ``image_proj`` group: the Resampler's
    ``latents [1, Q, D]`` and ``layers.{i}.{0,1}`` Sequentials, MLPProj's
    ``proj.{0,2,3}``."""
    stem = {"sd15": "ip-adapter_sd15", "plus": "ip-adapter-plus_sd15",
            "full": "ip-adapter-full-face_sd15"}[variant]
    group = {f"image_proj.{k}": v for k, v in
             published[variant][stem + ".bin"]["image_proj"].items()}
    ported = getattr(TW, port)(group)
    _equal(ported, TW.from_flax(kind, getattr(JW, jport)(_np_dict(group))))


@pytest.mark.parametrize("case", ["sd15", "xl"])
def test_ip_adapter_order_matches_jax(published, case):
    """The ``ip_adapter`` group, values stamped with their index, lands on
    the same cross-attentions as the JAX package installs it (down, up,
    mid last), and only there."""
    b = published["bundles"][case]
    unet_ip = b.unet_ip
    stem = "ip-adapter_sd15"
    group = published[case][stem + ".bin"]["ip_adapter"]
    stamped = {f"ip_adapter.{k}": torch.full_like(v, float(k.split(".")[0]))
               for k, v in group.items()}
    ported = TW.port_ip_adapter(stamped, unet_ip)
    jtree = JW.port_unet(_np_dict(TE.published_state_dicts(
        b)["unet.safetensors"] | {
            k.replace(".to_k_ip", ".processor.to_k_ip").replace(
                ".to_v_ip", ".processor.to_v_ip"): v
            for k, v in unet_ip.state_dict().items() if "_ip." in k}))
    ref = TW.from_flax("unet", JW.port_ip_adapter(_np_dict(stamped), jtree))
    assert set(ported) == {k for k in unet_ip.state_dict() if "_ip." in k}
    for k, v in ported.items():
        np.testing.assert_array_equal(_np(v), ref[k], err_msg=k)
    order = [int(k.split(".")[0]) for k in group][::2]
    assert order == sorted(order)
    paths = TW.cross_attention_paths(unet_ip)
    firsts = [p.split(".")[0] for p in paths]
    assert firsts == sorted(firsts, key=["down_blocks", "up_blocks",
                                         "mid_block"].index)


def test_ip_unet_processor_names(published):
    """The IP UNet's published ``attn2.processor.to_k_ip`` maps to the
    port's ``attn2.to_k_ip`` as the JAX map reads it."""
    b = published["bundles"]["sd15"]
    sd = {k.replace(".to_k_ip", ".processor.to_k_ip").replace(
        ".to_v_ip", ".processor.to_v_ip"): v
        for k, v in b.unet_ip.state_dict().items()}
    ported = TW.port_unet(sd)
    _equal(ported, TW.from_flax("unet", JW.port_unet(_np_dict(sd))))
    assert set(ported) == set(b.unet_ip.state_dict())


def test_unmatched_ip_group_raises(published):
    """A group with one processor index fewer than the UNet's IP
    cross-attentions raises, as the JAX package asserts."""
    b = published["bundles"]["sd15"]
    group = published["sd15"]["ip-adapter_sd15.bin"]["ip_adapter"]
    group = {k: v for k, v in group.items() if not k.startswith("1.")}
    with pytest.raises(ValueError, match="processor entries"):
        TW.port_ip_adapter(group, b.unet_ip)


# ---------------------------------------------- full-size manifests (meta)

def _placeholders(man: dict, stamp=None) -> dict:
    """Zero-stride tensors of the manifest's shapes (no storage)."""
    return {k: torch.full((), 0.0 if stamp is None else stamp(k)).expand(s)
            for k, s in man.items()}


def _shapes(sd: dict) -> dict:
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.fixture(scope="module")
def meta_bundles():
    return {
        "sd15": init_bundle(tcfg.sd15_config(), device="meta", with_ip=True,
                            with_controlnet=True, with_vision=True),
        "plus": init_bundle(tcfg.sd15_config(), device="meta", with_ip=True,
                            ip_variant="plus"),
        "full": init_bundle(tcfg.sd15_config(), device="meta", with_ip=True,
                            ip_variant="full"),
        "sdxl": init_bundle(tcfg.sdxl_config(), device="meta", with_ip=True),
    }


@pytest.mark.parametrize("name,port,case,field", [
    ("sd15_unet", "port_unet", "sd15", "unet"),
    ("sdxl_unet", "port_unet", "sdxl", "unet"),
    ("vae_legacy", "port_vae", "sd15", "vae"),
    ("vae_modern", "port_vae", "sd15", "vae"),
    ("controlnet", "port_controlnet", "sd15", "controlnet"),
    ("resampler", "port_resampler", "plus", "image_proj"),
    ("mlp_proj", "port_mlp_proj", "full", "image_proj"),
    ("image_proj", "port_image_proj", "sd15", "image_proj"),
])
def test_full_size_manifest_coverage(meta_bundles, name, port, case, field):
    """At ``sd15_config()``/``sdxl_config()`` each map consumes every key of
    the published manifest and yields exactly the port module's
    parameters, shape for shape (what ``strict=True`` then loads)."""
    man = {
        "sd15_unet": manifests.sd15_unet_manifest,
        "sdxl_unet": manifests.sdxl_unet_manifest,
        "vae_legacy": lambda: manifests.sd15_vae_manifest(True),
        "vae_modern": lambda: manifests.sd15_vae_manifest(False),
        "controlnet": manifests.sd15_controlnet_manifest,
        "resampler": manifests.ip_adapter_plus_image_proj_manifest,
        "mlp_proj": _mlp_proj_manifest,
        "image_proj": lambda: {k: s for k, s in
                               manifests.ip_adapter_sd15_manifest().items()
                               if k.startswith("image_proj.")},
    }[name]()
    ported = getattr(TW, port)(_placeholders(man))
    assert len(ported) == len(man)
    module = getattr(meta_bundles[case], field)
    assert _shapes(ported) == _shapes(module.state_dict())


def _mlp_proj_manifest():
    emb, cross = 1024, manifests.CROSS
    return {"image_proj.proj.0.weight": (emb, emb),
            "image_proj.proj.0.bias": (emb,),
            "image_proj.proj.2.weight": (cross, emb),
            "image_proj.proj.2.bias": (cross,),
            "image_proj.proj.3.weight": (cross,),
            "image_proj.proj.3.bias": (cross,)}


def test_full_size_ip_adapter_order(meta_bundles):
    """ip-adapter_sd15.bin's group, each entry stamped with its index,
    lands index for index on down → up → mid (the manifest's
    IP_SD15_PATHS, in the port's names), at each layer's width."""
    man = manifests.ip_adapter_sd15_manifest()
    group = _placeholders({k: s for k, s in man.items()
                           if k.startswith("ip_adapter.")},
                          stamp=lambda k: float(k.split(".")[1]))
    unet_ip = meta_bundles["sd15"].unet_ip
    ported = TW.port_ip_adapter(group, unet_ip)
    ref = unet_ip.state_dict()
    assert set(ported) == {k for k in ref if "_ip." in k}
    for pos, scope in enumerate(manifests.IP_SD15_PATHS):
        prefix = re.sub(r"(down|up|mid)_blocks?_(?:(\d+)_)?attentions_(\d+)",
                        lambda m: f"{m[1]}_block{'s' if m[2] else ''}."
                        f"{m[2] + '.' if m[2] else ''}attentions.{m[3]}",
                        scope[-1])
        for kv in ("to_k_ip", "to_v_ip"):
            key = f"{prefix}.transformer_blocks.0.attn2.{kv}.weight"
            assert tuple(ported[key].shape) == tuple(ref[key].shape) == (
                manifests.IP_SD15_HIDDEN[pos], manifests.CROSS)
            assert float(ported[key][0, 0]) == 2 * pos + 1, key


def test_full_size_ip_adapter_order_sdxl(meta_bundles):
    """The 70 IP cross-attentions of the XL UNet in processor order, as
    the JAX package's test writes them out from the architecture."""
    paths = TW.cross_attention_paths(meta_bundles["sdxl"].unet_ip)
    want = []
    for bi, depth in ((1, 2), (2, 10)):
        for ai in range(2):
            want += [f"down_blocks.{bi}.attentions.{ai}.transformer_blocks."
                     f"{d}.attn2" for d in range(depth)]
    for bi, depth in ((0, 10), (1, 2)):
        for ai in range(3):
            want += [f"up_blocks.{bi}.attentions.{ai}.transformer_blocks."
                     f"{d}.attn2" for d in range(depth)]
    want += [f"mid_block.attentions.0.transformer_blocks.{d}.attn2"
             for d in range(10)]
    assert paths == want and len(paths) == 70


def test_full_size_sam_coverage():
    """sam-vit-base: port_sam of the module's names plus the mask tower
    and the tied copy yields exactly SamHF's parameters."""
    from theatergen_tpu_torch.perception.sam_hf import SamHF, SamHFConfig
    from theatergen_tpu_torch.pipelines.bundle import build_module

    ref = build_module(SamHF, SamHFConfig(), torch.float32,
                       "meta").state_dict()
    man = _shapes(ref) | {
        "prompt_encoder.shared_embedding.positional_embedding": (2, 128),
        "prompt_encoder.mask_embed.conv1.weight": (4, 1, 2, 2)}
    ported = TW.port_sam(_placeholders(man))
    assert _shapes(ported) == _shapes(ref)
    assert sum(int(np.prod(s)) for s in _shapes(ref).values()) > 9e7


@pytest.mark.parametrize("size", ["base", "tiny", "other"])
def test_sam_config_from_file_shapes(size):
    """load_bundle builds the SamHF that the file's shapes give, whatever
    the bundle's config: a sam-vit-base file gives the JAX package's
    ``SamHFConfig()`` (which its load_bundle always builds), the tiny
    instance's file the tiny config, and a SAM of other shapes (here one
    vision layer more) raises."""
    from theatergen_tpu.perception import sam_hf as JHF
    from theatergen_tpu_torch.perception import sam_hf as THF
    from theatergen_tpu_torch.pipelines.bundle import build_module

    hf = {"base": THF.SamHFConfig(), "tiny": THF.tiny_sam_hf_config(),
          "other": dataclasses.replace(THF.tiny_sam_hf_config(),
                                       num_layers=4)}[size]
    man = _shapes(build_module(THF.SamHF, hf, torch.float32,
                               "meta").state_dict())
    ported = TW.port_sam(_placeholders(man))
    if size == "other":
        with pytest.raises(ValueError, match="neither sam-vit-base"):
            TW.sam_hf_config_of(ported)
        return
    got = dataclasses.asdict(TW.sam_hf_config_of(ported))
    assert got == dataclasses.asdict(hf)
    if size == "base":
        assert got == dataclasses.asdict(JHF.SamHFConfig())


# ------------------------------------------------------------ load_bundle

def _write_dir(tmp_path, name="w", **parts):
    """A tiny checkpoint directory of the seeded SD1.5 bundle, with SamHF
    and the full-width annotator; ``parts`` drops files (False)."""
    b = init_bundle(CFG, 3, device="cpu", with_ip=True, with_vision=True,
                    with_controlnet=True)
    b.sam = build_sam(CFG, "cpu", torch.Generator().manual_seed(5),
                      hf_cfg=sam_hf_config(CFG))
    b.lineart = build_lineart("cpu", torch.Generator().manual_seed(6))
    d = tmp_path / name
    TE.export_checkpoint_dir(b, str(d))
    for fname, keep in parts.items():
        if not keep:
            os.remove(d / fname)
    return str(d), b


def _jax_load(d, cfg=None):
    """The JAX package's load_bundle of ``d``, its random init abstract
    (``init_bundle(abstract=True)``: shapes only, no eager flax init).
    Every tree a test compares comes from the directory's files; a leaf
    left abstract would fail the comparison."""
    with mock.patch.object(jbundle, "init_bundle", functools.partial(
            jbundle.init_bundle, abstract=True)):
        return JW.load_bundle(cfg or jcfg.tiny_config(), d)


def test_load_bundle_matches_jax(tmp_path, capsys):
    """Every module of the port's load_bundle equals from_flax of the JAX
    package's load_bundle tree of the same directory, bit for bit: the
    IP UNet carries the UNet's weights and the file's to_k_ip/to_v_ip,
    SAM and the annotator are the files'."""
    d, src = _write_dir(tmp_path)
    tb = TW.load_bundle(CFG, d, device="cpu")
    jb = _jax_load(d)
    for field, kind, tree in (
            ("unet", "unet", jb.unet_params), ("vae", "vae", jb.vae_params),
            ("text", "text", jb.text_params),
            ("unet_ip", "unet", jb.unet_ip_params),
            ("image_proj", "image_proj", jb.image_proj_params),
            ("vision", "vision", jb.vision_params),
            ("controlnet", "controlnet", jb.controlnet_params),
            ("sam", "sam_hf", jb.sam_params),
            ("lineart", "lineart", jb.lineart_params)):
        _equal(getattr(tb, field).state_dict(), TW.from_flax(kind, tree))
    src_unet = src.unet.state_dict()
    for k, v in tb.unet_ip.state_dict().items():
        want = src.unet_ip.state_dict()[k] if "_ip." in k else src_unet[k]
        assert torch.equal(v, want.half().float()), k
    assert "WARNING" not in capsys.readouterr().out


def test_load_bundle_keeps_the_jax_flags(tmp_path):
    """As the JAX package builds it: a ControlNet also at the XL config, no
    T2I-Adapter, the hash tokenizer without merges.txt."""
    d = tmp_path / "empty"
    d.mkdir()
    xl = TW.load_bundle(tcfg.tiny_xl_config(), str(d), device="cpu")
    jxl = _jax_load(str(d), jcfg.tiny_xl_config())
    for field in ("controlnet", "t2i_adapter", "text2", "vision", "unet_ip",
                  "sam", "lineart", "detector"):
        assert ((getattr(xl, field) is None)
                == (getattr(jxl, field) is None)), field
    assert xl.controlnet is not None and xl.t2i_adapter is None
    assert type(xl.tokenizer).__name__ == "HashTokenizer"


def test_fp16_files_cast_to_each_module(tmp_path):
    """fp16 files (as most SD1.5 checkpoints ship) load into the tiny
    config's fp32 modules as the fp16-rounded source, bit for bit."""
    b = init_bundle(CFG, 3, device="cpu", with_ip=True, with_vision=True,
                    with_controlnet=True)
    TE.export_checkpoint_dir(b, str(tmp_path / "w"))
    tb = TW.load_bundle(CFG, str(tmp_path / "w"), device="cpu")
    for field in ("unet", "vae", "text", "vision", "controlnet",
                  "image_proj"):
        got = getattr(tb, field).state_dict()
        for k, v in getattr(b, field).state_dict().items():
            assert got[k].dtype == v.dtype, k
            assert torch.equal(got[k], v.half().to(v.dtype)), (field, k)


@pytest.mark.parametrize("files,want", [
    (("ip-adapter-plus_sd15.bin",), "plus"),
    (("ip-adapter-plus_sd15.bin", "ip-adapter_sd15.bin"), "base"),
    ((), "base")])
def test_ip_variant_inference(tmp_path, files, want):
    """"plus" where only a plus file is there, else "base", as the JAX
    package infers; the plus file's projector loads into the Resampler."""
    d = tmp_path / "ip"
    d.mkdir()
    for f in files:
        variant = "plus" if "plus" in f else "base"
        b = init_bundle(CFG, 8, device="cpu", with_ip=True,
                        ip_variant=variant)
        sd = TE.published_state_dicts(b)
        torch.save(sd[f], str(d / f))
    tb = TW.load_bundle(CFG, str(d), device="cpu")
    jb = _jax_load(str(d))
    assert tb.ip_variant == jb.ip_variant == want
    if files:
        kind = {"plus": "resampler", "base": "image_proj"}[want]
        _equal(tb.image_proj.state_dict(),
               TW.from_flax(kind, jb.image_proj_params))


def test_missing_parts_warn_as_jax(tmp_path, capsys):
    """With only the UNet and the VAE, the same warning line as the JAX
    package's names the parts that keep random weights."""
    d, _ = _write_dir(tmp_path, **{
        f: False for f in ("text_encoder.safetensors",
                           "controlnet.safetensors",
                           "image_encoder.safetensors",
                           "ip-adapter_sd15.bin", "sam.safetensors",
                           "lineart.safetensors")})
    capsys.readouterr()
    tb = TW.load_bundle(CFG, d, device="cpu")
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    _jax_load(d)
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert port_line == jax_line
    assert "['text', 'controlnet', 'vision', 'ip_adapter']" in port_line
    assert tb.sam is None and tb.lineart is None


@pytest.mark.parametrize("fname", ["owl.safetensors"])
def test_detector_files_are_refused(tmp_path, fname):
    """A detector file whose shapes are no detector the port builds is
    refused, not loaded partly (OWL-ViT loads:
    test_torch_port_owl.py; GroundingDINO: test_torch_port_gdino_turn.py)."""
    d = tmp_path / "w"
    d.mkdir()
    TW.save_safetensors(str(d / fname), {"x": torch.zeros(1)})
    with pytest.raises(ValueError, match=r"owl.safetensors: its shapes"):
        TW.load_bundle(CFG, str(d), device="cpu")


def test_load_bundle_needs_the_card_unless_asked(tmp_path):
    d = tmp_path / "empty"
    d.mkdir()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TW.load_bundle(CFG, str(d))
    assert TW.load_bundle(CFG, str(d), device="cpu").device.type == "cpu"
