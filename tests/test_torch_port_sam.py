"""The port's segmenters and lineart generators against the JAX package's on
the CPU, fp32, at the tiny sizes: ``SamHF`` (with ``port_sam`` weights in
transformers' names), ``SAMLite`` (through ``from_flax``), the mask
selection and refinement, both ``segment_with_box`` forms, and the
``LineartGenerator``/``LineartNet`` annotators.  Inputs are seeded numpy
arrays given to both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models import weights as JW
from theatergen_tpu.ops import geometry as JG
from theatergen_tpu.ops import lineart as JLA
from theatergen_tpu.perception import sam as JSM
from theatergen_tpu.perception import sam_hf as JHF
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models import weights as TW
from theatergen_tpu_torch.ops import geometry as TG
from theatergen_tpu_torch.ops import lineart as TLA
from theatergen_tpu_torch.perception import sam as TSM
from theatergen_tpu_torch.perception import sam_hf as THF
from theatergen_tpu_torch.pipelines.bundle import build_lineart, build_module

from test_torch_port_models import random_params

torch.set_num_threads(1)

HF = THF.tiny_sam_hf_config()
CFG = tcfg.tiny_config()
# fp32 through a 3-layer ViT (windowed and global attention with the
# rel-pos bias), the neck and the two-way decoder: 1e-6 measured
SAM_TOL = 2e-5


def _np(x):
    return np.asarray(x.detach().float().cpu() if torch.is_tensor(x) else x)


def hf_state_dict(seed: int = 0) -> dict:
    """A seeded ``SamModel`` state dict at the tiny config, in
    transformers' names: the port module's names (which ``port_sam`` of
    the JAX package must consume whole, see test_jax_port_sam_covers) plus
    what a real file adds and both maps ignore (the mask tower, the prompt
    encoder's tied positional embedding)."""
    rng = np.random.RandomState(seed)
    ref = build_module(THF.SamHF, HF, torch.float32, "meta").state_dict()
    sd = {k: rng.uniform(-0.08, 0.08, tuple(v.shape)).astype(np.float32)
          for k, v in ref.items()}
    pe = "shared_image_embedding.positional_embedding"
    sd[pe] = rng.randn(*sd[pe].shape).astype(np.float32)
    sd["prompt_encoder.shared_embedding.positional_embedding"] = sd[pe]
    sd["prompt_encoder.mask_embed.conv1.weight"] = rng.randn(
        2, 1, 2, 2).astype(np.float32)
    return sd


@pytest.fixture(scope="module")
def hf_pair():
    sd = hf_state_dict()
    jparams = JW.port_sam(sd)
    tm = TW.load_into(build_module(THF.SamHF, HF, torch.float32, "cpu"),
                      TW.port_sam({k: torch.from_numpy(v)
                                   for k, v in sd.items()}))
    return sd, jparams, tm


def test_sam_config_matches_the_jax_package():
    jf = {f.name: f.default for f in dataclasses.fields(jcfg.SAMConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tcfg.SAMConfig)}
    assert tf == jf
    for fn in ("tiny_config", "sd15_config", "tiny_xl_config",
               "sdxl_config"):
        assert (dataclasses.asdict(getattr(tcfg, fn)().sam)
                == dataclasses.asdict(getattr(jcfg, fn)().sam)), fn
    assert (dataclasses.asdict(THF.tiny_sam_hf_config())
            == dataclasses.asdict(JHF.tiny_sam_hf_config()))
    assert (dataclasses.asdict(THF.SamHFConfig())
            == dataclasses.asdict(JHF.SamHFConfig()))


def test_jax_port_sam_covers(hf_pair):
    """The JAX package's port_sam turns the dict into a whole SamHF tree
    (every leaf of its init, same shapes): the names are transformers'."""
    _, jparams, _ = hf_pair
    ref = jax.eval_shape(lambda: JHF.SamHF(HF).init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 1, 4))))["params"]
    want = {p: s.shape for p, s in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {p: np.shape(v) for p, v in
           jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert got == want


def test_port_sam_matches_jax_port_sam(hf_pair):
    """port_sam keeps exactly the entries the JAX map consumes, and equals
    from_flax of its tree bit for bit."""
    sd, jparams, tm = hf_pair
    ported = TW.port_sam({k: torch.from_numpy(v) for k, v in sd.items()})
    bridged = TW.from_flax("sam_hf", jparams)
    assert set(ported) == set(bridged) == set(tm.state_dict())
    for k, v in bridged.items():
        np.testing.assert_array_equal(_np(ported[k]), v, err_msg=k)


def test_samhf_vision_encoder_matches(hf_pair):
    _, jparams, tm = hf_pair
    rng = np.random.RandomState(1)
    pixels = np.asarray(JHF.preprocess(
        rng.rand(2, 64, 64, 3).astype(np.float32)))
    j = jax.jit(lambda p, x: JHF.SamVisionEncoder(HF).apply(
        {"params": p}, x))(jparams["vision_encoder"], pixels)
    with torch.no_grad():
        t = tm.vision_encoder(torch.from_numpy(pixels))
    np.testing.assert_allclose(_np(t), np.asarray(j), atol=SAM_TOL)


@pytest.mark.parametrize("multimask", [True, False])
def test_samhf_forward_matches(hf_pair, multimask):
    _, jparams, tm = hf_pair
    rng = np.random.RandomState(2)
    img = rng.rand(1, 64, 64, 3).astype(np.float32)
    boxes = np.array([[[4.0, 6.0, 40.0, 50.0], [10.0, 12.0, 30.0, 44.0]]],
                     np.float32)
    jm, ji = jax.jit(lambda p, x, b: JHF.SamHF(HF).apply(
        {"params": p}, x, b, multimask=multimask))(
        jparams, np.asarray(JHF.preprocess(img)), boxes)
    with torch.no_grad():
        tmask, tiou = tm(THF.preprocess(torch.from_numpy(img)),
                         torch.from_numpy(boxes), multimask=multimask)
    assert tmask.shape == jm.shape == (1, 2, 3 if multimask else 1, 32, 32)
    np.testing.assert_allclose(_np(tiou), np.asarray(ji), atol=SAM_TOL)
    np.testing.assert_allclose(_np(tmask), np.asarray(jm), atol=SAM_TOL)


def test_samhf_matches_transformers(hf_pair):
    """The transformers golden of the JAX package's SamHF test
    (tests/test_sam_hf.py), held to the port: the same seeded dict loaded
    into ``SamModel`` and the port's SamHF; where transformers is
    missing the test skips."""
    transformers = pytest.importorskip("transformers")
    from transformers.models.sam.configuration_sam import (
        SamMaskDecoderConfig, SamPromptEncoderConfig, SamVisionConfig)

    sd, _, tm = hf_pair
    cfg = transformers.SamConfig(
        vision_config=SamVisionConfig(
            hidden_size=HF.hidden_size, num_hidden_layers=HF.num_layers,
            num_attention_heads=HF.num_heads, image_size=HF.image_size,
            patch_size=HF.patch_size, window_size=HF.window_size,
            global_attn_indexes=list(HF.global_attn_indexes),
            output_channels=HF.output_channels,
            num_pos_feats=HF.num_pos_feats),
        prompt_encoder_config=SamPromptEncoderConfig(
            hidden_size=HF.prompt_hidden_size, image_size=HF.image_size,
            patch_size=HF.patch_size,
            mask_input_channels=HF.mask_input_channels),
        mask_decoder_config=SamMaskDecoderConfig(
            hidden_size=HF.decoder_hidden_size,
            num_attention_heads=HF.decoder_num_heads,
            mlp_dim=HF.decoder_mlp_dim,
            iou_head_hidden_dim=HF.iou_head_hidden_dim),
        attn_implementation="eager")
    ref = transformers.SamModel(cfg).eval()
    full = {k: torch.from_numpy(v) for k, v in sd.items()}
    for k, v in ref.state_dict().items():
        if k not in full:            # the mask tower: runs on no box path
            full[k] = v
    ref.load_state_dict({k: full[k] for k in ref.state_dict()}, strict=True)
    rng = np.random.RandomState(3)
    img = rng.rand(1, 64, 64, 3).astype(np.float32)
    boxes = torch.tensor([[[4.0, 6.0, 40.0, 50.0]]])
    pixels = THF.preprocess(torch.from_numpy(img))
    with torch.no_grad():
        out = ref(pixel_values=pixels.permute(0, 3, 1, 2),
                  input_boxes=boxes)
        masks, iou = tm(pixels, boxes)
    np.testing.assert_allclose(_np(iou), _np(out.iou_scores), atol=3e-5)
    np.testing.assert_allclose(_np(masks), _np(out.pred_masks), atol=5e-4)


# ---------------------------------------------------------------- SAMLite

@pytest.fixture(scope="module")
def lite_pair():
    jsam = JSM.SAMLite(jcfg.tiny_config().sam)
    jp = random_params(jsam, 7, jnp.zeros((1, 64, 64, 3)),
                       jnp.zeros((1, 1, 4)))
    tm = build_module(TSM.SAMLite, CFG.sam, torch.float32, "cpu")
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        TW.from_flax("sam_lite", jp).items()}, strict=True)
    return jsam, jp, tm


def test_samlite_matches(lite_pair):
    jsam, jp, tm = lite_pair
    rng = np.random.RandomState(4)
    img = rng.rand(2, 64, 64, 3).astype(np.float32)
    boxes = np.array([[[0.2, 0.2, 0.8, 0.8], [0.0, 0.1, 0.5, 0.6]],
                      [[0.1, 0.3, 0.9, 0.7], [0.4, 0.4, 0.6, 0.9]]],
                     np.float32)
    jm, ji = jax.jit(lambda p, x, b: jsam.apply({"params": p}, x, b))(
        jp, img, boxes)
    with torch.no_grad():
        tmask, tiou = tm(torch.from_numpy(img), torch.from_numpy(boxes))
    assert tmask.shape == jm.shape == (2, 2, 3, 16, 16)
    np.testing.assert_allclose(_np(tiou), np.asarray(ji), atol=SAM_TOL)
    np.testing.assert_allclose(_np(tmask), np.asarray(jm), atol=SAM_TOL)


# ------------------------------------------------------- selection rules

def _masks():
    h = w = 8
    big = np.ones((h, w), np.float32)
    mid = np.zeros((h, w), np.float32)
    mid[:4] = 1
    small = np.zeros((h, w), np.float32)
    small[:2, :2] = 1
    return np.stack([small, mid, big]), mid


@pytest.mark.parametrize("ious,coarse,min_coarse_iou", [
    ([0.9, 0.9, 0.9], False, 0.25), ([0.9, 0.9, 0.1], False, 0.25),
    ([0.9, 0.9, 0.9], True, 0.6), ([0.1, 0.1, 0.1], False, 0.25),
    ([0.1, 0.1, 0.1], True, 0.9)])
def test_select_mask_matches(ious, coarse, min_coarse_iou):
    """The rule's cases (largest, penalised below confidence, penalised off
    the coarse mask, all penalised: the largest of the rest) give the JAX
    index."""
    masks, mid = _masks()
    kw = dict(min_coarse_iou=min_coarse_iou)
    j = JSM.select_mask(jnp.asarray(masks), jnp.asarray(ious),
                        jnp.asarray(mid) if coarse else None, **kw)
    t = TSM.select_mask(torch.from_numpy(masks), torch.tensor(ious),
                        torch.from_numpy(mid) if coarse else None, **kw)
    assert int(t) == int(j)


def test_select_mask_ties_go_to_the_first():
    """Equal scores (three empty candidates, or two equal areas) pick the
    first index, as jnp.argmax does."""
    empty = np.zeros((3, 4, 4), np.float32)
    two = np.zeros((3, 4, 4), np.float32)
    two[1, :2] = two[2, 2:] = 1
    for masks in (empty, two):
        ious = np.full(3, 0.9, np.float32)
        j = JSM.select_mask(jnp.asarray(masks), jnp.asarray(ious))
        t = TSM.select_mask(torch.from_numpy(masks), torch.from_numpy(ious))
        assert int(t) == int(j) == (0 if masks is empty else 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_mask_matches(seed):
    """Binarise, min-pool with a border of ones, max-pool with a border of
    zeros: equal to the JAX package's, the border included."""
    m = np.random.RandomState(seed).rand(16, 12).astype(np.float32)
    np.testing.assert_array_equal(
        _np(TSM.refine_mask(torch.from_numpy(m))),
        np.asarray(JSM.refine_mask(jnp.asarray(m))))


def test_refine_mask_border_and_specks():
    m = np.zeros((16, 16), np.float32)
    m[4:12, 4:12] = 1
    m[0, 0] = 1
    full = np.ones((6, 6), np.float32)
    out = _np(TSM.refine_mask(torch.from_numpy(m)))
    assert out[0, 0] == 0 and out[6:10, 6:10].min() == 1
    # a full mask survives the erode: the min-pool's border is ones
    np.testing.assert_array_equal(_np(TSM.refine_mask(torch.from_numpy(
        full))), full)


def test_geometry_helpers_match():
    rng = np.random.RandomState(5)
    masks = (rng.rand(3, 8, 8) > 0.5).astype(np.float32)
    one = (rng.rand(8, 8) > 0.4).astype(np.float32)
    np.testing.assert_allclose(
        _np(TG.iou(torch.from_numpy(one), torch.from_numpy(masks))),
        np.asarray(JG.iou(jnp.asarray(one), jnp.asarray(masks))), rtol=1e-6)
    big = rng.rand(16, 24).astype(np.float32)
    np.testing.assert_array_equal(
        _np(TG.downsample_max(torch.from_numpy(big), 4, 6)),
        np.asarray(JG.downsample_max(jnp.asarray(big), 4, 6)))


# -------------------------------------------------------- segment_with_box

def _sam_inputs(seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(64, 64, 3).astype(np.float32)
    box = np.array([0.15, 0.2, 0.7, 0.9], np.float32)
    return img, box


@pytest.mark.parametrize("backend", ["lite", "hf"])
def test_segment_with_box_matches(lite_pair, hf_pair, backend):
    """One image and box through either backend (SamHF takes the box in
    pixels): both refined masks equal, the chosen IoU score within
    SAM_TOL; a coarse mask too; the counter counts one call each."""
    if backend == "lite":
        jsam, jp, tm = lite_pair
    else:
        _, jp, tm = hf_pair
        jsam = JHF.SamHF(HF)
    img, box = _sam_inputs(6)
    coarse = np.zeros((64, 64), np.float32)
    coarse[10:50, 12:40] = 1
    for cm in (None, coarse):
        # jitted: the JAX package's eager call compiles op by op (~12 s)
        (jl, jh), jc = jax.jit(lambda p, i, b, c: JSM.segment_with_box(
            jsam, p, i, b, out_sizes=(8, 16), coarse_mask=c))(
            jp, jnp.asarray(img), jnp.asarray(box),
            None if cm is None else jnp.asarray(cm))
        before = TSM.segments
        (tl, th), tc = TSM.segment_with_box(
            tm, torch.from_numpy(img), torch.from_numpy(box),
            out_sizes=(8, 16),
            coarse_mask=None if cm is None else torch.from_numpy(cm))
        assert TSM.segments == before + 1
        assert tl.shape == (8, 8) and th.shape == (16, 16)
        np.testing.assert_array_equal(_np(tl), np.asarray(jl))
        np.testing.assert_array_equal(_np(th), np.asarray(jh))
        np.testing.assert_allclose(float(tc), float(jc), atol=SAM_TOL)


@pytest.mark.parametrize("backend", ["lite", "hf"])
def test_segment_with_box_batch_matches(lite_pair, hf_pair, backend):
    if backend == "lite":
        jsam, jp, tm = lite_pair
    else:
        _, jp, tm = hf_pair
        jsam = JHF.SamHF(HF)
    rng = np.random.RandomState(8)
    imgs = rng.rand(3, 64, 64, 3).astype(np.float32)
    boxes = np.array([[0.1, 0.1, 0.6, 0.9], [0.3, 0.2, 0.9, 0.8],
                      [0.0, 0.0, 1.0, 1.0]], np.float32)
    (jl, jh), jc = jax.jit(lambda p, i, b: JSM.segment_with_box_batch(
        jsam, p, i, b, out_sizes=(8, 16)))(jp, jnp.asarray(imgs),
                                           jnp.asarray(boxes))
    before = TSM.segments
    (tl, th), tc = TSM.segment_with_box_batch(
        tm, torch.from_numpy(imgs), torch.from_numpy(boxes),
        out_sizes=(8, 16))
    assert TSM.segments == before + 3
    np.testing.assert_array_equal(_np(tl), np.asarray(jl))
    np.testing.assert_array_equal(_np(th), np.asarray(jh))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), atol=SAM_TOL)


# ------------------------------------------------------------------ lineart

# fp32 convolutions and instance norms over a 32² image: 1e-6 measured
LINEART_TOL = 1e-5


def test_instance_norm_matches():
    x = np.random.RandomState(9).randn(2, 5, 6, 7).astype(np.float32)
    np.testing.assert_allclose(
        _np(TLA.instance_norm(torch.from_numpy(x))),
        np.asarray(JLA.instance_norm(jnp.asarray(x.transpose(0, 2, 3, 1))))
        .transpose(0, 3, 1, 2), atol=1e-5)


@pytest.mark.parametrize("base,n_res", [(8, 2), (16, 3)])
def test_lineart_generator_matches(base, n_res):
    """Reflect padding and the ConvTranspose2d(3, 2, 1, output_padding 1)
    geometry: the port (torch layout) against the JAX generator (its
    flipped kernels) on the same weights."""
    jm = JLA.LineartGenerator(base=base, n_res=n_res)
    jp = random_params(jm, 10 + base, jnp.zeros((1, 32, 32, 3)))
    tm = build_lineart("cpu", base=base, n_res=n_res)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        TW.from_flax("lineart", jp).items()}, strict=True)
    img = np.random.RandomState(11).rand(2, 32, 24, 3).astype(np.float32)
    j = np.asarray(jm.apply({"params": jp}, jnp.asarray(img)))
    with torch.no_grad():
        t = tm(torch.from_numpy(img))
    assert t.shape == (2, 32, 24, 3)
    np.testing.assert_allclose(_np(t), j, atol=LINEART_TOL)


def sk_model_state_dict(base: int, n_res: int, seed: int) -> dict:
    """A seeded state dict in the names and layouts of ``sk_model.pth``
    (controlnet_aux's lineart Generator: Sequential indices, ConvTranspose
    weights ``[in, out, kh, kw]``), written from that module's layout."""
    shapes = {"model0.1": (base, 3, 7, 7), "model1.0": (2 * base, base, 3, 3),
              "model1.3": (4 * base, 2 * base, 3, 3),
              "model3.0": (4 * base, 2 * base, 3, 3),
              "model3.3": (2 * base, base, 3, 3), "model4.1": (1, base, 7, 7)}
    for i in range(n_res):
        for j in (1, 5):
            shapes[f"model2.{i}.conv_block.{j}"] = (4 * base, 4 * base, 3, 3)
    rng = np.random.RandomState(seed)
    sd = {}
    for name, shape in shapes.items():
        convt = name.startswith("model3")
        fan_in = (shape[0] if convt else shape[1]) * shape[2] * shape[3]
        sd[name + ".weight"] = (rng.randn(*shape)
                                / np.sqrt(fan_in)).astype(np.float32)
        sd[name + ".bias"] = 0.1 * rng.randn(
            shape[1] if convt else shape[0]).astype(np.float32)
    return sd


def test_port_lineart_matches_jax_port_lineart():
    """port_lineart equals from_flax of the JAX package's port_lineart bit
    for bit and covers the module; the two load into generators that agree
    on an image."""
    sd = sk_model_state_dict(8, 2, 12)
    ported = TW.port_lineart({k: torch.from_numpy(v) for k, v in sd.items()})
    jp = JW.port_lineart(sd)
    bridged = TW.from_flax("lineart", jp)
    tm = build_lineart("cpu", base=8, n_res=2)
    assert set(ported) == set(bridged) == set(tm.state_dict())
    for k, v in bridged.items():
        np.testing.assert_array_equal(_np(ported[k]), v, err_msg=k)
    TW.load_into(tm, ported)
    img = np.random.RandomState(15).rand(1, 32, 32, 3).astype(np.float32)
    j = np.asarray(JLA.LineartGenerator(base=8, n_res=2).apply(
        {"params": jp}, jnp.asarray(img)))
    with torch.no_grad():
        t = tm(torch.from_numpy(img))
    np.testing.assert_allclose(_np(t), j, atol=LINEART_TOL)


def test_lineart_net_matches():
    jm = JLA.LineartNet(base=8, n_res=1)
    jp = random_params(jm, 13, jnp.zeros((1, 32, 32, 3)))
    tm = build_module(TLA.LineartNet, None, torch.float32, "cpu", base=8,
                      n_res=1)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        TW.from_flax("lineart", jp).items()}, strict=True)
    img = np.random.RandomState(14).rand(1, 32, 32, 3).astype(np.float32)
    j = np.asarray(jm.apply({"params": jp}, jnp.asarray(img)))
    with torch.no_grad():
        t = tm(torch.from_numpy(img))
    assert t.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(_np(t), j, atol=LINEART_TOL)
