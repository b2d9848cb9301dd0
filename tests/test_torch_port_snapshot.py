"""The port's bundle snapshots (``models/snapshot.py``) on the CPU, with the
JAX package's rules (``theatergen_tpu/models/snapshot.py``): the round trip
is exact and a rebuilt bundle computes the same images; a snapshot is not
overwritten, a half-written one is reclaimed, unknown fields and a
cfg/snapshot mismatch raise; the JAX package's own (orbax) snapshots are
refused, not misread."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from theatergen_tpu.config import tiny_config as jax_tiny_config
from theatergen_tpu.models import snapshot as JS
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models import snapshot as TS
from theatergen_tpu_torch.pipelines import sd
from theatergen_tpu_torch.pipelines.bundle import (build_lineart, build_sam,
                                                   init_bundle, sam_hf_config)

torch.set_num_threads(1)

CFG = tcfg.tiny_config()


def _bundle(sam_backend="lite", seed=1):
    cfg = dataclasses.replace(CFG, sam=dataclasses.replace(
        CFG.sam, backend=sam_backend))
    b = init_bundle(cfg, seed, device="cpu", with_ip=True, with_vision=True,
                    with_controlnet=True, with_sam=True)
    b.lineart = build_lineart("cpu", torch.Generator().manual_seed(seed),
                              base=8, n_res=1)
    return b


@pytest.mark.parametrize("backend", ["lite", "hf"])
def test_round_trip_is_exact(tmp_path, backend):
    """Every module, SAM of either kind and the annotator included, comes
    back bit for bit in its dtype (the skeleton is the config's; the seed
    differs, so equality shows the snapshot's tensors replaced it), nothing
    stays on the meta device, and a Text2Img request gives the same image
    bit for bit."""
    b = _bundle(backend)
    snap = str(tmp_path / "snap")
    fields = TS.save_bundle_snapshot(b, snap)
    assert set(fields) == {"unet", "vae", "text", "unet_ip", "image_proj",
                           "vision", "controlnet", "sam", "lineart"}
    b2 = TS.load_bundle_snapshot(CFG, snap, device="cpu")
    assert type(b2.sam) is type(b.sam) and b2.ip_variant == b.ip_variant
    for f in fields:
        want, got = getattr(b, f).state_dict(), getattr(b2, f).state_dict()
        assert set(got) == set(want), f
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), (f, k)
        assert not getattr(b2, f).training
        assert not any(p.requires_grad for p in getattr(b2, f).parameters())
    imgs = [sd.Text2Img(x, num_steps=2)(torch.Generator().manual_seed(7),
                                        "a red knight") for x in (b, b2)]
    assert torch.equal(imgs[0], imgs[1])


def test_xl_and_quantized_round_trip(tmp_path):
    """The tiny XL bundle (two towers, the T2I-Adapter) and a W8A8 UNet
    (int8 weights and scales as buffers) come back exactly."""
    xl = init_bundle(tcfg.tiny_xl_config(), 2, device="cpu", with_ip=True,
                     with_t2i_adapter=True)
    qcfg = dataclasses.replace(CFG, unet=dataclasses.replace(
        CFG.unet, quantized=True))
    q = init_bundle(qcfg, 2, device="cpu")
    for name, b, cfg in (("xl", xl, tcfg.tiny_xl_config()), ("q", q, qcfg)):
        TS.save_bundle_snapshot(b, str(tmp_path / name))
        b2 = TS.load_bundle_snapshot(cfg, str(tmp_path / name), device="cpu")
        for f in TS.MODULE_FIELDS:
            if getattr(b, f) is None:
                assert getattr(b2, f) is None, (name, f)
                continue
            want = getattr(b, f).state_dict()
            got = getattr(b2, f).state_dict()
            assert all(torch.equal(got[k], v) and got[k].dtype == v.dtype
                       for k, v in want.items()), (name, f)


def test_snapshot_is_not_overwritten(tmp_path):
    b = init_bundle(CFG, 0, device="cpu")
    snap = str(tmp_path / "snap")
    TS.save_bundle_snapshot(b, snap)
    with pytest.raises(FileExistsError):
        TS.save_bundle_snapshot(b, snap)


def test_half_written_snapshot_is_reclaimed(tmp_path):
    """A modules directory without the meta file (a save cut short) is
    cleared and the save completes; the meta file is the commit marker."""
    snap = tmp_path / "snap"
    (snap / "modules").mkdir(parents=True)
    (snap / "modules" / "unet.safetensors").write_bytes(b"truncated")
    (snap / "modules" / "stale.safetensors").write_bytes(b"x")
    b = init_bundle(CFG, 0, device="cpu")
    TS.save_bundle_snapshot(b, str(snap))
    assert sorted(os.listdir(snap / "modules")) == [
        "text.safetensors", "unet.safetensors", "vae.safetensors"]
    b2 = TS.load_bundle_snapshot(CFG, str(snap), device="cpu")
    assert torch.equal(b2.unet.conv_in.weight, b.unet.conv_in.weight)


def test_unknown_fields_are_rejected(tmp_path):
    b = init_bundle(CFG, 0, device="cpu")
    snap = str(tmp_path / "snap")
    TS.save_bundle_snapshot(b, snap)
    meta_path = os.path.join(snap, "bundle_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta["fields"].append("exotic")
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="unknown fields"):
        TS.load_bundle_snapshot(CFG, snap, device="cpu")


def test_cfg_and_snapshot_mismatch_raises(tmp_path):
    """A cfg that needs a module the snapshot lacks (the XL config's second
    tower) fails loudly, and so does a snapshot module the cfg does not
    build or builds at another shape."""
    b = init_bundle(CFG, 0, device="cpu")
    snap = str(tmp_path / "sd15")
    TS.save_bundle_snapshot(b, snap)
    xl_cfg = dataclasses.replace(tcfg.tiny_xl_config(), unet=CFG.unet)
    with pytest.raises(ValueError, match="does not cover 'text2'"):
        TS.load_bundle_snapshot(xl_cfg, snap, device="cpu")
    xl = init_bundle(tcfg.tiny_xl_config(), 0, device="cpu")
    xl_snap = str(tmp_path / "xl")
    TS.save_bundle_snapshot(xl, xl_snap)
    with pytest.raises(ValueError, match="does not build"):
        TS.load_bundle_snapshot(dataclasses.replace(
            tcfg.tiny_xl_config(), text2=None), xl_snap, device="cpu")
    with pytest.raises(ValueError, match="this cfg builds"):
        TS.load_bundle_snapshot(dataclasses.replace(
            tcfg.tiny_xl_config(), unet=dataclasses.replace(
                tcfg.tiny_xl_config().unet, block_out_channels=(16, 32))),
            xl_snap, device="cpu")


def test_orbax_snapshot_is_refused(tmp_path):
    """A snapshot the JAX package wrote (orbax param trees; small stand-in
    trees, as its save takes any) is refused with a message naming it."""
    jb = JBundle(cfg=jax_tiny_config(), tokenizer=None,
                 unet=None, unet_params={"conv_in": {"bias": np.ones(4)}},
                 vae=None, vae_params={"x": np.zeros(2)},
                 text=None, text_params={"y": np.zeros(3)})
    snap = str(tmp_path / "jax_snap")
    JS.save_bundle_snapshot(jb, snap)
    with pytest.raises(ValueError, match="JAX package"):
        TS.load_bundle_snapshot(CFG, snap, device="cpu")


def test_snapshot_needs_the_card_unless_asked(tmp_path):
    b = init_bundle(CFG, 0, device="cpu")
    snap = str(tmp_path / "snap")
    TS.save_bundle_snapshot(b, snap)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TS.load_bundle_snapshot(CFG, snap)
    b2 = TS.load_bundle_snapshot(CFG, snap, device="cpu")
    assert b2.device.type == "cpu"
    np.testing.assert_array_equal(b2.vae.post_quant_conv.weight.numpy(),
                                  b.vae.post_quant_conv.weight.numpy())


def test_loaded_samhf_snapshot_keeps_its_kind(tmp_path):
    """A bundle whose SamHF came from a checkpoint (whatever
    ``cfg.sam.backend`` says) reloads as a SamHF of the saved config."""
    b = init_bundle(CFG, 0, device="cpu")
    b.sam = build_sam(CFG, "cpu", torch.Generator().manual_seed(2),
                      hf_cfg=sam_hf_config(CFG))
    snap = str(tmp_path / "snap")
    TS.save_bundle_snapshot(b, snap)
    assert CFG.sam.backend == "lite"
    b2 = TS.load_bundle_snapshot(CFG, snap, device="cpu")
    assert type(b2.sam).__name__ == "SamHF" and b2.sam.cfg == b.sam.cfg
