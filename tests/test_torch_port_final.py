"""The port's back half of a turn against the JAX package at
``tiny_config()``: the geometry, alignment, trajectory composition, the
collage, the lineart hint, the attention-mask fallback, the step mean of
the reference maps, the composition program, the ControlNet, the UNet
with ControlNet residuals and the whole ``make_final_pipeline`` run, on the
same weights (carried across by ``from_flax``) and the same numpy inputs.
Everything runs in fp32 on the CPU.  The kernel sites that the final pass
reaches at full size are counted on the meta device.
"""

import collections
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu import theater as jth
from theatergen_tpu.models.controlnet import ControlNet as JControlNet
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.ops import geometry as JG
from theatergen_tpu.ops import latents as JL
from theatergen_tpu.ops import lineart as JLA
from theatergen_tpu.pipelines import final as jfinal
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch import theater as tth
from theatergen_tpu_torch.models.controlnet import ControlNet as TControlNet
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.ops import flash_attention as tfa
from theatergen_tpu_torch.ops import geglu_matmul as tgg
from theatergen_tpu_torch.ops import geometry as TG
from theatergen_tpu_torch.ops import groupnorm as tgn
from theatergen_tpu_torch.ops import latents as TL
from theatergen_tpu_torch.ops import lineart as TLA
from theatergen_tpu_torch.pipelines import final as tfinal
from theatergen_tpu_torch.pipelines import sd as tsd
from theatergen_tpu_torch.pipelines.bundle import init_bundle

import test_torch_port_xl_turn as xl_tests
from test_torch_port_models import random_params

torch.set_num_threads(1)

CFG = jcfg.tiny_config()
H = W = CFG.pipeline.height          # 16 px canvas
h = w = CFG.pipeline.latent_height   # 8² latents


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# geometry, alignment, composition, collage, lineart
# ---------------------------------------------------------------------------

BOXES = np.array([[0.13, 0.27, 0.61, 0.93], [0.0, 0.0, 1.0, 1.0],
                  [0.55, 0.05, 0.95, 0.45], [0.3, 0.3, 0.3, 0.3]], np.float32)


@pytest.mark.parametrize("i", range(len(BOXES)))
def test_box_geometry_matches(i):
    """scale_box, box_mask and centered_box (both ways) of normalised boxes
    (an empty one too) on a 12×20 grid: integer results equal, the
    recentred box within 1e-6."""
    b = BOXES[i]
    np.testing.assert_array_equal(
        TG.scale_box(_t(b), 12, 20).numpy(), np.asarray(JG.scale_box(
            jnp.asarray(b), 12, 20)))
    np.testing.assert_array_equal(
        TG.box_mask(_t(b), 12, 20).numpy(), np.asarray(JG.box_mask(
            jnp.asarray(b), 12, 20)))
    for horizontal in (True, False):
        np.testing.assert_allclose(
            TG.centered_box(_t(b), horizontal).numpy(),
            np.asarray(JG.centered_box(jnp.asarray(b), horizontal)),
            atol=1e-6)


@pytest.mark.parametrize("density", [0.0, 0.05, 0.4])
def test_mask_geometry_matches(density):
    """mask_to_box (an empty mask gives the whole image), mask_center
    (normalised and not) of seeded binary masks: boxes equal, centres
    within 1e-5."""
    m = (np.random.RandomState(int(density * 100)).rand(12, 20)
         < density).astype(np.float32)
    for enlarge in (True, False):
        np.testing.assert_array_equal(
            TG.mask_to_box(_t(m), enlarge).numpy(),
            np.asarray(JG.mask_to_box(jnp.asarray(m), enlarge)))
    for norm in (True, False):
        for a, b in zip(TG.mask_center(_t(m), norm),
                        JG.mask_center(jnp.asarray(m), norm)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


@pytest.mark.parametrize("dy,dx", [(3, -5), (-20, 2), (0, 0), (12, 0),
                                   (-4, 19)])
def test_shift_and_paste_match(dy, dx):
    """shift2d by offsets inside and past the grid (given as 0-dim
    tensors), and paste_region of a patch under a mask at that offset:
    equal."""
    rng = np.random.RandomState(5)
    x = rng.rand(3, 12, 20).astype(np.float32)
    np.testing.assert_array_equal(
        TG.shift2d(_t(x), torch.tensor(dy), torch.tensor(dx)).numpy(),
        np.asarray(JG.shift2d(jnp.asarray(x), dy, dx)))
    patch = rng.rand(3, 5, 7).astype(np.float32)
    pm = (rng.rand(5, 7) > 0.3).astype(np.float32)
    got = TG.paste_region(_t(x), _t(patch), abs(dy) % 12, abs(dx) % 20,
                          _t(pm))
    ref = JG.paste_region(jnp.asarray(x), jnp.asarray(patch), abs(dy) % 12,
                          abs(dx) % 20, jnp.asarray(pm))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("out_hw", [(32, 24), (7, 5), (16, 30), (16, 12)])
def test_resize_matches(out_hw):
    """resize_bilinear of NCHW and HW inputs, up (plain interpolation),
    down (antialiased) and mixed, and upsample_nearest: 1e-5 (fp32
    resampling weights and sums)."""
    x = np.random.RandomState(1).rand(2, 3, 16, 12).astype(np.float32)
    for a in (x, x[0, 0]):
        np.testing.assert_allclose(
            TG.resize_bilinear(_t(a), *out_hw).numpy(),
            np.asarray(JG.resize_bilinear(jnp.asarray(a), *out_hw)),
            atol=1e-5)
    np.testing.assert_array_equal(
        TG.upsample_nearest(_t(x), 32, 36).numpy(),
        np.asarray(JG.upsample_nearest(jnp.asarray(x), 32, 36)))


# slot masks of the composition tests: two characters, one padded slot
def _slots(seed=0, zero_offsets=False):
    rng = np.random.RandomState(seed)
    k, s1 = 3, 5
    traj = rng.randn(k, s1, 1, h, w, 4).astype(np.float32)
    traj[2] = 0.0                                   # padded slot
    masks = np.zeros((k, h, w), np.float32)
    masks[0, 1:5, 1:4] = 1
    masks[1, 2:7, 3:8] = 1
    if zero_offsets:
        # layout boxes centred on the masks' mass centres: no shift
        boxes = np.array([[0.0, 0.125, 0.375, 0.625],
                          [0.3125, 0.25, 1.0, 0.875],
                          [0, 0, 0, 0]], np.float32)
    else:
        boxes = np.array([[0.5, 0.1, 0.9, 0.6], [0.0, 0.3, 0.5, 0.9],
                          [0, 0, 0, 0]], np.float32)
    return traj, masks, boxes


def test_compose_trajectories_matches():
    """Two characters and a padded slot (empty mask, zero trajectory),
    with and without the t = T box copy: composed trajectory and
    foreground index equal."""
    traj, masks, _ = _slots()
    bg = np.random.RandomState(1).randn(1, h, w, 4).astype(np.float32)
    for box_to_bg in (True, False):
        cj, fj = JL.compose_trajectories(jnp.asarray(traj),
                                         jnp.asarray(masks), jnp.asarray(bg),
                                         compose_box_to_bg=box_to_bg)
        ct, ft = TL.compose_trajectories(_t(traj), _t(masks), _t(bg),
                                         compose_box_to_bg=box_to_bg)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))


@pytest.mark.parametrize("horizontal_only", [False, True])
def test_align_with_boxes_matches(horizontal_only):
    """Masks and offsets equal the JAX function's.  The trajectories equal
    each NHWC trajectory shifted on its h and w axes by the JAX package's
    own shift2d (applied to the NCHW transpose): the JAX function's own
    trajectory output shifts the w and C axes instead (the next test)."""
    traj, masks, boxes = _slots()
    tj, mj, oj = JL.align_with_boxes(jnp.asarray(traj), jnp.asarray(masks),
                                     jnp.asarray(boxes),
                                     horizontal_only=horizontal_only)
    tt, mt, ot = TL.align_with_boxes(_t(traj), _t(masks), _t(boxes),
                                     horizontal_only=horizontal_only)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-6)
    assert np.abs(np.asarray(oj)).max() > 0.1
    for i in range(3):
        cx, cy = JG.mask_center(jnp.asarray(masks[i]), normalize=True)
        dx = int(np.round(float(oj[i, 0]) * 8)) * (w // 8)
        dy = int(np.round(float(oj[i, 1]) * 8)) * (h // 8)
        nchw = jnp.transpose(jnp.asarray(traj[i]), (0, 1, 4, 2, 3))
        want = jnp.transpose(JG.shift2d(nchw, dy, dx), (0, 1, 3, 4, 2))
        np.testing.assert_array_equal(tt[i].numpy(), np.asarray(want))


def test_jax_align_shifts_the_trailing_axes_of_a_trajectory():
    """Pins the JAX package's departure (ROADMAP §3): its align_with_boxes
    hands the [S+1, B, h, w, C] trajectory to shift2d, which shifts the
    trailing (w, C) axes, so a horizontal offset of a whole latent column
    block (≥ C) empties the trajectory, while its mask moves on (h, w)."""
    traj, masks, boxes = _slots()
    tj, mj, oj = JL.align_with_boxes(jnp.asarray(traj), jnp.asarray(masks),
                                     jnp.asarray(boxes))
    dx = int(np.round(float(oj[0, 0]) * 8)) * (w // 8)
    dy = int(np.round(float(oj[0, 1]) * 8)) * (h // 8)
    assert abs(dx) >= 4
    np.testing.assert_array_equal(
        np.asarray(tj[0]), np.asarray(JG.shift2d(jnp.asarray(traj[0]), dy,
                                                 dx)))
    assert not np.asarray(tj[0]).any()
    np.testing.assert_array_equal(
        np.asarray(mj[0]), np.asarray(JG.shift2d(jnp.asarray(masks[0]), dy,
                                                 dx)))


def _collage_inputs(seed=2):
    rng = np.random.RandomState(seed)
    imgs = rng.rand(3, 32, 32, 3).astype(np.float32)
    mp = np.zeros((3, 32, 32), np.float32)
    mp[0, 4:20, 6:18] = 1
    mp[1, 10:30, 2:25] = 1
    boxes = np.array([[0.5, 0.1, 0.9, 0.6], [0.0, 0.3, 0.5, 0.9],
                      [0, 0, 0, 0]], np.float32)
    return imgs, mp, boxes, np.array([True, True, False])


def test_collage_images_matches():
    """Two characters cut out, rescaled into their layout boxes (one
    shrinks, antialiased; one grows) and pasted, a padded slot skipped:
    union mask equal, collage within 1e-5."""
    imgs, mp, boxes, valid = _collage_inputs()
    cj, uj = JL.collage_images(jnp.asarray(imgs), jnp.asarray(mp),
                               jnp.asarray(boxes), jnp.asarray(valid))
    ct, ut = TL.collage_images(_t(imgs), _t(mp), _t(boxes), _t(valid))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    assert ut.sum() > 100
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-5)


@pytest.mark.parametrize("sigma", [1.0, 1.6])
def test_gaussian_blur_matches(sigma):
    """The separable blur of HW and HWC images: 1e-6 (fp32 taps; the two
    packages' exp and sums round apart by ~2e-7)."""
    img = np.random.RandomState(3).rand(24, 40, 3).astype(np.float32)
    for a in (img, img[..., 0]):
        np.testing.assert_allclose(
            TLA.gaussian_blur(_t(a), sigma).numpy(),
            np.asarray(JLA.gaussian_blur(jnp.asarray(a), sigma)), atol=1e-6)
    np.testing.assert_allclose(
        TLA.gaussian_kernel1d(sigma, 3).numpy(),
        np.asarray(JLA.gaussian_kernel1d(sigma, 3)), atol=1e-7)


@pytest.mark.parametrize("seed", [3, 4])
def test_dog_lineart_matches(seed):
    """The DoG sketch of a seeded image: 1e-4.  It multiplies the
    difference of the two blurs by phi·2.5 = 500 before the clip, so the
    blurs' 2e-7 rounding difference reaches ~1e-4 on the edge band (5.8e-5
    measured); everywhere else the two are equal or saturated."""
    img = np.random.RandomState(seed).rand(24, 40, 3).astype(np.float32)
    got = TLA.dog_lineart(_t(img)).numpy()
    ref = np.asarray(JLA.dog_lineart(jnp.asarray(img)))
    assert got.shape == ref.shape == (24, 40, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert 0.0 < ref.mean() < 1.0


# ---------------------------------------------------------------------------
# the mask fallback, the step mean, the composition program
# ---------------------------------------------------------------------------

def _maps_away_from_thresholds():
    """Seeded [heads, HW] maps at 2² and 4² tokens (cubed uniforms: a few
    strong tokens) whose normalised sum at 8² stays ≥ 1e-3 away from the
    0.3 and 0.1 thresholds and falls between them somewhere."""
    for seed in range(100):
        rng = np.random.RandomState(seed)
        maps = [(rng.rand(2, 4) ** 3).astype(np.float32),
                (rng.rand(2, 16) ** 3).astype(np.float32)]
        agg = sum(np.asarray(JG.resize_bilinear(
            jnp.asarray(m.mean(0).reshape(int(len(m[0]) ** 0.5), -1)), h, w))
            for m in maps)
        agg = agg / (agg.max() + 1e-8)
        if (min(np.abs(agg - 0.3).min(), np.abs(agg - 0.1).min()) > 1e-3
                and ((agg > 0.1) & (agg < 0.3)).any() and (agg < 0.1).any()):
            return maps
    raise AssertionError("no seed keeps the maps away from the thresholds")


def test_attn_mask_fallback_matches():
    """_attn_mask_fallback from two keys' step-mean maps and a box hint:
    latent and pixel masks equal (inputs kept away from the thresholds)."""
    maps = _maps_away_from_thresholds()
    hint = np.array([0.2, 0.1, 0.7, 0.8], np.float32)
    mj = jth._attn_mask_fallback([jnp.asarray(m) for m in maps],
                                 jnp.asarray(hint), h, w, H, W)
    mt = tth._attn_mask_fallback([_t(m) for m in maps], _t(hint), h, w, H,
                                 W)
    for a, b in zip(mt, mj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < mt[0].sum() < h * w
    # the hint widens the mask: without it fewer pixels hold
    far = tth._attn_mask_fallback([_t(m) for m in maps],
                                  torch.zeros(4), h, w, H, W)
    assert far[0].sum() < mt[0].sum()


@pytest.mark.parametrize("steps,batched", [(50, False), (4, False),
                                           (50, True)])
def test_aggregate_attn_matches(steps, batched):
    """The step mean over steps ≥ 10 (the last step of a shorter run) of
    [S, heads, HW] and batched [B, S, heads, HW] maps, against
    Theater._aggregate_attn itself: 1e-6."""
    rng = np.random.RandomState(steps)
    lead = (2, steps) if batched else (steps,)
    refs = tuple(rng.rand(*lead, 2, n).astype(np.float32) for n in (4, 16))
    stub = types.SimpleNamespace(
        char_sched=types.SimpleNamespace(num_steps=steps),
        bundle=types.SimpleNamespace(jitted=lambda key, fn: jax.jit(fn)))
    ref = jth.Theater._aggregate_attn(stub, tuple(jnp.asarray(r)
                                                  for r in refs))
    got = tth.aggregate_attn([_t(r) for r in refs], steps)
    for a, b in zip(got, ref):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _program_inputs(zero_offsets):
    traj, masks_lat, boxes = _slots(zero_offsets=zero_offsets)
    imgs, masks_pix, _, valid = _collage_inputs()
    imgs, masks_pix = imgs[:, ::2, ::2], masks_pix[:, ::2, ::2]   # 16 px
    bg = np.random.RandomState(9).randn(1, h, w, 4).astype(np.float32)
    return traj, masks_lat, masks_pix.copy(), imgs.copy(), boxes, valid, bg


@pytest.mark.parametrize("zero_offsets", [True, False])
def test_compose_program_matches(zero_offsets):
    """_compose_program (lineart None: the DoG sketch): collage and hint
    within 1e-4 (the sketch's bound), frozen mask equal.  The composed
    trajectory equals the JAX program's where the layout boxes need no
    shift; with shifts it equals the JAX composition of trajectories
    shifted on their h and w axes (see test_align_with_boxes_matches).
    With an annotator the hint is the annotator's output on the collage,
    ``[1, H, W, 3]`` in, the rest unchanged (its parity with the JAX
    annotator: test_torch_port_turn.py's perception turns)."""
    args = _program_inputs(zero_offsets)
    jrun = jth._compose_program(None)
    cj = jrun(None, *(jnp.asarray(a) for a in args))
    ct = tth._compose_program()(*(_t(a) for a in args))
    np.testing.assert_allclose(_np(ct[1]), np.asarray(cj[1]), atol=1e-5)
    np.testing.assert_allclose(_np(ct[2]), np.asarray(cj[2]), atol=1e-4)
    np.testing.assert_array_equal(_np(ct[3]), np.asarray(cj[3]))
    assert 0 < float(ct[3].sum()) < h * w
    if zero_offsets:
        np.testing.assert_array_equal(_np(ct[0]), np.asarray(cj[0]))
    else:
        traj, masks_lat, _, _, boxes, _, bg = args
        ta, ma, _ = TL.align_with_boxes(_t(traj), _t(masks_lat), _t(boxes))
        want, _ = JL.compose_trajectories(jnp.asarray(_np(ta)),
                                          jnp.asarray(_np(ma)),
                                          jnp.asarray(bg))
        np.testing.assert_array_equal(_np(ct[0]), np.asarray(want))
    seen = []
    cl = tth._compose_program(lambda x: seen.append(x.shape) or 1.0 - x)(
        *(_t(a) for a in args))
    assert seen == [(1, *ct[1].shape)]
    np.testing.assert_array_equal(_np(cl[2]), 1.0 - _np(ct[1]))
    for i in (0, 1, 3):
        np.testing.assert_array_equal(_np(cl[i]), _np(ct[i]))


# ---------------------------------------------------------------------------
# ControlNet, the UNet with residuals, the final pass
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bundles():
    """A JAX bundle and the port's bundle on the same random weights (the
    base UNet, the IP UNet with 4 IP tokens, the ControlNet and the VAE;
    random_params gives the zero-initialised convolutions nonzero
    weights, so every residual is exercised)."""
    zeros = functools.partial(jnp.zeros, dtype=jnp.float32)
    unet = JUNet(CFG.unet)
    up = random_params(unet, 0, zeros((1, h, w, 4)), jnp.zeros((1,),
                                                               jnp.int32),
                       zeros((1, 16, 32)))
    unet_ip = JUNet(dataclasses.replace(CFG.unet, ip_num_tokens=4))
    uip = random_params(unet_ip, 1, zeros((1, h, w, 4)),
                        jnp.zeros((1,), jnp.int32), zeros((1, 20, 32)))
    cn = JControlNet(CFG.controlnet)
    cp = random_params(cn, 2, zeros((1, h, w, 4)), jnp.zeros((1,), jnp.int32),
                       zeros((1, 16, 32)), zeros((1, H, W, 3)))
    vae = JVAE(CFG.vae)
    vp = random_params(vae, 3, zeros((1, H, W, 3)))
    jb = JBundle(cfg=CFG, tokenizer=jtok.HashTokenizer(1024), unet=unet,
                 unet_params=up, vae=vae, vae_params=vp, text=None,
                 text_params=None, unet_ip=unet_ip, unet_ip_params=uip,
                 controlnet=cn, controlnet_params=cp)
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu", with_ip=True,
                     with_controlnet=True).load_flax(
        unet=up, unet_ip=uip, controlnet=cp, vae=vp)
    return jb, tb


def _cn_inputs(seed=4):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, h, w, 4).astype(np.float32),
            np.array([501, 501], np.int32),
            rng.randn(2, 16, 32).astype(np.float32),
            rng.rand(2, H, W, 3).astype(np.float32))


def test_controlnet_state_dict_names():
    """from_flax of the JAX ControlNet fills every tensor of the port's
    under diffusers' names (load_state_dict is strict)."""
    _, tb = _bundles()
    names = set(tb.controlnet.state_dict())
    for n in ("controlnet_cond_embedding.conv_in.weight",
              "controlnet_cond_embedding.blocks.1.weight",
              "controlnet_cond_embedding.conv_out.bias",
              "controlnet_down_blocks.0.weight",
              "controlnet_down_blocks.5.bias", "controlnet_mid_block.weight",
              "conv_in.weight", "time_embedding.linear_1.weight",
              "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q"
              ".weight", "mid_block.resnets.1.conv2.weight"):
        assert n in names, n
    assert len(tb.controlnet.controlnet_down_blocks) == 6
    assert not any(n.startswith("up_blocks") for n in names)


@pytest.mark.parametrize("scale", [1.0, 0.7])
def test_controlnet_residuals_match(scale):
    """The tiny ControlNet's 6 down residuals and mid residual (one
    stride-2 hint stage, 16 px hint → 8² latents): 1e-4 absolute (fp32
    through 3 transformer blocks, O(1) outputs).  The hint embedded once
    and passed as cond_embed gives the same residuals."""
    jb, tb = _bundles()
    x, t, ctx, cond = _cn_inputs()
    dj, mj = jb.controlnet.apply({"params": jb.controlnet_params},
                                 *(jnp.asarray(a) for a in (x, t, ctx,
                                                            cond)), scale)
    cn = tb.controlnet
    with torch.no_grad():
        dt, mt = cn(_t(x).permute(0, 3, 1, 2), _t(t).long(), _t(ctx),
                    _t(cond).permute(0, 3, 1, 2), scale)
        emb = cn.embed_hint(_t(cond).permute(0, 3, 1, 2))
        de, me = cn(_t(x).permute(0, 3, 1, 2), _t(t).long(), _t(ctx),
                    conditioning_scale=scale, cond_embed=emb)
    assert len(dt) == len(dj) == 6
    for a, b in zip(dt + (mt,), tuple(dj) + (mj,)):
        np.testing.assert_allclose(_np(a.permute(0, 2, 3, 1)), np.asarray(b),
                                   atol=1e-4)
    for a, b in zip(de + (me,), dt + (mt,)):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)
    assert max(float(r.abs().max()) for r in dt) > 0.1
    with pytest.raises(ValueError):
        cn(_t(x).permute(0, 3, 1, 2), _t(t).long(), _t(ctx))


def test_unet_with_residuals_matches():
    """The tiny IP UNet at ip_scale 0.1 with the ControlNet's residuals
    added to its skips and mid block: eps 1e-4 absolute, and the residuals
    move it (more than 1e-2 from the UNet without them)."""
    jb, tb = _bundles()
    x, t, ctx, cond = _cn_inputs()
    ctx_ip = np.concatenate(
        [ctx, np.random.RandomState(5).randn(2, 4, 32).astype(np.float32)], 1)
    dj, mj = jb.controlnet.apply({"params": jb.controlnet_params},
                                 *(jnp.asarray(a) for a in (x, t, ctx, cond)))
    ref = jb.unet_ip.apply({"params": jb.unet_ip_params}, jnp.asarray(x),
                           jnp.asarray(t), jnp.asarray(ctx_ip), ip_scale=0.1,
                           down_residuals=dj, mid_residual=mj)
    down = tuple(_t(np.asarray(r)).permute(0, 3, 1, 2) for r in dj)
    mid = _t(np.asarray(mj)).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tb.unet_ip(_t(x).permute(0, 3, 1, 2), _t(t).long(), _t(ctx_ip),
                         ip_scale=torch.tensor(0.1), down_residuals=down,
                         mid_residual=mid)
        bare = tb.unet_ip(_t(x).permute(0, 3, 1, 2), _t(t).long(),
                          _t(ctx_ip), ip_scale=0.1)
        with pytest.raises(ValueError):
            tb.unet_ip(_t(x).permute(0, 3, 1, 2), _t(t).long(), _t(ctx_ip),
                       down_residuals=down[:3])
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), np.asarray(ref),
                               atol=1e-4)
    assert float((got - bare).abs().max()) > 1e-2


@functools.lru_cache(maxsize=None)
def _jax_runner(use_ip, end):
    jb, _ = _bundles()
    return jfinal.make_final_pipeline(jb, 4, use_ip=use_ip,
                                      control_guidance_end=end)[0]


def _final_inputs(seed=6):
    rng = np.random.RandomState(seed)
    latents_all = rng.randn(5, 1, h, w, 4).astype(np.float32)
    fm = np.zeros((h, w), np.float32)
    fm[2:6, 1:5] = 1.0
    return (latents_all, fm, rng.randn(2, 20, 32).astype(np.float32),
            rng.randn(2, 16, 32).astype(np.float32),
            rng.rand(H, W, 3).astype(np.float32))


@pytest.mark.parametrize("frozen_steps,use_ip,end", [
    (0, True, 1.0), (2, True, 1.0), (2, True, 0.5), (2, False, 1.0)])
def test_final_pass_matches(frozen_steps, use_ip, end):
    """make_final_pipeline, 4 DDIM steps at CFG 7.5, ip_scale 0.1, against
    the JAX runner from the same composed trajectory, mask, contexts and
    hint: final latents and trajectory 2e-4 absolute (CFG amplifies each
    step's eps difference; latents O(10)).  Frozen steps 0 and 2 (a
    device scalar), a ControlNet window that ends after step 1 (steps 2
    and 3 run without it), and the base UNet (use_ip=False, text
    context).  Below frozen_steps the masked latents of the trajectory
    are the composed trajectory's, bit for bit."""
    jb, tb = _bundles()
    la, fm, ctx, cn_ctx, cond = _final_inputs()
    ctx_in = ctx if use_ip else cn_ctx
    jp = jb.unet_ip_params if use_ip else jb.unet_params
    fj, trj = _jax_runner(use_ip, end)(
        jp, jb.controlnet_params, jnp.asarray(la), jnp.asarray(fm),
        jnp.int32(frozen_steps), jnp.asarray(ctx_in), jnp.asarray(cn_ctx),
        jnp.asarray(cond), jnp.float32(0.1))
    run, sched = tfinal.make_final_pipeline(tb, 4, use_ip=use_ip,
                                            control_guidance_end=end)
    ft, trt = run(_t(la), _t(fm), torch.tensor(frozen_steps), _t(ctx_in),
                  _t(cn_ctx), _t(cond), torch.tensor(0.1))
    assert sched.num_steps == 4 and tuple(trt.shape) == (5, 1, h, w, 4)
    np.testing.assert_array_equal(_np(trt[0]), la[0])
    np.testing.assert_allclose(_np(trt), np.asarray(trj), atol=2e-4)
    np.testing.assert_allclose(_np(ft), np.asarray(fj), atol=2e-4)
    on = fm > 0
    for i in range(1, frozen_steps + 1):
        np.testing.assert_array_equal(_np(trt[i, 0])[on], la[i, 0][on])
    if frozen_steps == 0:
        assert not np.array_equal(_np(trt[1, 0])[on], la[1, 0][on])


def test_final_pass_window_and_controlnet_off():
    """The window's steps (fraction i/(S-1) in [start, end], fp32), and a
    runner without the ControlNet differs from one with it."""
    assert tfinal.control_window(4, 0.0, 0.5) == [True, True, False, False]
    assert tfinal.control_window(5, 0.25, 0.75) == [False, True, True, True,
                                                    False]
    assert tfinal.control_window(1, 0.0, 1.0) == [True]
    _, tb = _bundles()
    la, fm, ctx, cn_ctx, cond = _final_inputs()
    outs = []
    for use_cn in (True, False):
        run, _ = tfinal.make_final_pipeline(tb, 2, use_controlnet=use_cn)
        outs.append(run(_t(la[:3]), _t(fm), 0, _t(ctx), _t(cn_ctx),
                        _t(cond), 0.1)[0])
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3


def test_back_half_matches():
    """The slice end to end on the CPU: the composition program's outputs
    (layout boxes that need no shift) into the final runner at
    frozen_steps 2, then the VAE decode, in both packages: trajectory and
    final latents 2e-4, image 1e-4 (decode of latents 2e-4 apart)."""
    jb, tb = _bundles()
    args = _program_inputs(zero_offsets=True)
    composed, _, cond, fm = jth._compose_program(None)(
        None, *(jnp.asarray(a) for a in args))
    _, ctx, cn_ctx, _ = _final_inputs()[1:]
    fj, trj = _jax_runner(True, 1.0)(
        jb.unet_ip_params, jb.controlnet_params, composed, fm, jnp.int32(2),
        jnp.asarray(ctx), jnp.asarray(cn_ctx), cond, jnp.float32(0.1))
    img_j = jsd.decode_with(jb.vae, jb.vae_params, CFG.vae.scaling_factor, fj)
    c_t, _, cond_t, fm_t = tth._compose_program()(*(_t(a) for a in args))
    run, _ = tfinal.make_final_pipeline(tb, 4)
    ft, trt = run(c_t, fm_t, 2, _t(ctx), _t(cn_ctx), cond_t, 0.1)
    img_t = tsd.decode_with(tb.vae, CFG.vae.scaling_factor, ft)
    np.testing.assert_allclose(_np(trt), np.asarray(trj), atol=2e-4)
    np.testing.assert_allclose(_np(ft), np.asarray(fj), atol=2e-4)
    assert tuple(img_t.shape) == (1, H, W, 3)
    np.testing.assert_allclose(_np(img_t), np.asarray(img_j), atol=1e-4)


@pytest.mark.parametrize("kw", [
    dict(cfg_cutoff_fraction=0.5), dict(deepcache_interval=2),
    dict(controlnet_interval=2)])
def test_final_knobs_run(kw):
    """CFG cutoff, DeepCache and the ControlNet interval (held to the JAX
    runner in test_torch_port_knobs.py): step 0 is a full CFG step with a
    fresh ControlNet forward under each, so the first step equals the
    exact run's bit for bit; the second (cond-only, shallow, or on cached
    residuals) moves the result off it; frozen replacement holds."""
    _, tb = _bundles()
    la, fm, ctx, cn_ctx, cond = _final_inputs()
    args = (_t(la[:3]), _t(fm), 1, _t(ctx), _t(cn_ctx), _t(cond), 0.1)
    exact, _ = tfinal.make_final_pipeline(tb, 2)
    run, _ = tfinal.make_final_pipeline(tb, 2, **kw)
    (fa, ta), (fb, tb_) = exact(*args), run(*args)
    torch.testing.assert_close(tb_[:2], ta[:2], rtol=0, atol=0)
    assert float((fb - fa).abs().max()) > 1e-4
    on = torch.from_numpy(fm > 0)
    torch.testing.assert_close(tb_[1, 0][on], _t(la[1, 0])[on], rtol=0,
                               atol=0)


def test_unported_final_inputs_raise():
    """A bundle without the ControlNet or the IP UNet raises.  The SDXL
    inputs and bundles run: the final pass on the tiny XL bundle with
    pooled text, time ids and the T2I-Adapter's features, exact CFG and
    Euler-Ancestral, matches the JAX runner (test_torch_port_xl_turn.py's
    bound and frozen-region check).  An LCM bundle runs and matches the
    JAX runner."""
    _, tb = _bundles()
    la, fm, ctx, cn_ctx, cond = _final_inputs()
    xl_tests.test_final_runner_xl_matches("euler_ancestral", None, None,
                                          False)
    # an LCM bundle runs (cond-only steps, consistency noise): held to the
    # JAX runner with its draws injected, bound 1e-5·max|ref| (no CFG)
    jb, _ = _bundles()
    lcm_cfg = lambda c: dataclasses.replace(c, pipeline=dataclasses.replace(
        c.pipeline, scheduler_type="lcm"))
    lcm = dataclasses.replace(tb, cfg=lcm_cfg(tb.cfg))
    run_j, _ = jfinal.make_final_pipeline(
        dataclasses.replace(jb, cfg=lcm_cfg(jb.cfg)), 2)
    key = jax.random.key(2)
    fj, trj = run_j(jb.unet_ip_params, jb.controlnet_params,
                    jnp.asarray(la[:3]), jnp.asarray(fm), jnp.int32(1),
                    jnp.asarray(ctx), jnp.asarray(cn_ctx), jnp.asarray(cond),
                    jnp.float32(0.1), rng=key)
    noise = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (1, h, w, 4), jnp.float32))
        for i in range(2)])
    run_t, sampler = tfinal.make_final_pipeline(lcm, 2)
    assert sampler.kind == "lcm"
    ft, trt = run_t(_t(la[:3]), _t(fm), 1, _t(ctx), _t(cn_ctx), _t(cond),
                    0.1, noise=_t(noise))
    bound = 1e-5 * float(np.abs(np.asarray(trj)).max())
    np.testing.assert_allclose(_np(trt), np.asarray(trj), rtol=0, atol=bound)
    np.testing.assert_allclose(_np(ft), np.asarray(fj), rtol=0, atol=bound)
    bare = init_bundle(tcfg.tiny_config(), 0, device="cpu", with_ip=True)
    with pytest.raises(ValueError, match="ControlNet"):
        tfinal.make_final_pipeline(bare, 2)
    with pytest.raises(ValueError, match="IP UNet"):
        tfinal.make_final_pipeline(
            init_bundle(tcfg.tiny_config(), 0, device="cpu",
                        with_controlnet=True), 2)


def test_controlnet_bundle_keeps_the_other_weights():
    """with_controlnet draws the ControlNet last: the other parts of a
    seed's bundle keep their weights; the bundle defaults to the card."""
    a = init_bundle(tcfg.tiny_config(), 3, device="cpu", with_ip=True)
    b = init_bundle(tcfg.tiny_config(), 3, device="cpu", with_ip=True,
                    with_controlnet=True)
    for name in ("unet", "unet_ip", "vae", "text"):
        for k, v in getattr(a, name).state_dict().items():
            assert torch.equal(v, getattr(b, name).state_dict()[k]), (name, k)
    assert a.controlnet is None and b.controlnet.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_bundle(tcfg.tiny_config(), 0, with_controlnet=True)


# ---------------------------------------------------------------------------
# kernel sites of the final pass at full size (meta device)
# ---------------------------------------------------------------------------

# per evaluation at 512 and 768 px (CFG batch 2): the IP UNet and the
# ControlNet.  768 px: level 0 self-attention at 96² = 9216 tokens takes
# the long route; level 1 (48² = 2304, not a multiple of 512) takes none;
# the mid block's FF (12²·2 = 288 rows) passes neither JAX FF gate; the
# GroupNorms at 96²×640 and 96²×960 (three in the UNet's up path) pass the
# TPU gate's size limit
FINAL_SITES = {
    512: {"unet": dict(flash=10, flash_long=0, ff=16, gn=61),
          "controlnet": dict(flash=4, flash_long=0, ff=7, gn=27)},
    768: {"unet": dict(flash=0, flash_long=5, ff=15, gn=58),
          "controlnet": dict(flash=0, flash_long=2, ff=6, gn=27)},
}


def test_final_pass_kernel_sites(monkeypatch):
    """The full-size SD1.5 IP UNet and ControlNet in bf16 on the meta
    device, with the GroupNorm switch at "1": the flash (short and long
    route), ff_matmul and group_norm calls of one evaluation at 512 and
    768 px (chip_smoke.py gates its requests on these counts)."""
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    calls = collections.Counter()
    real = (tfa.flash_attention, tgg.ff_matmul, tgn.fused_group_norm)
    monkeypatch.setattr(
        tfa, "flash_attention", lambda q, k, v, route=None: calls.update(
            ["flash_long" if route == "flat_online" else "flash"])
        or real[0](q, k, v, route=route))
    monkeypatch.setattr(tgg, "ff_matmul", lambda *a: calls.update(["ff"])
                        or real[1](*a))
    monkeypatch.setattr(tgn, "fused_group_norm", lambda *a, **k: calls.update(
        ["gn"]) or real[2](*a, **k))
    cfg = tcfg.sd15_config()
    with torch.device("meta"):
        unet = TUNet(dataclasses.replace(cfg.unet, ip_num_tokens=4)).to(
            torch.bfloat16)
        cn = TControlNet(cfg.controlnet).to(torch.bfloat16)
    for px, want in FINAL_SITES.items():
        with torch.device("meta"), torch.no_grad():
            x = torch.empty(2, 4, px // 8, px // 8)
            t = torch.empty(2, dtype=torch.long)
            calls.clear()
            down, mid = cn(x, t, torch.empty(2, 77, 768),
                           torch.empty(2, 3, px, px))
            got_cn = dict(calls)
            calls.clear()
            unet(x, t, torch.empty(2, 81, 768), ip_scale=0.1,
                 down_residuals=down, mid_residual=mid)
            got_unet = dict(calls)
        for got, key in ((got_cn, "controlnet"), (got_unet, "unet")):
            assert {k: got.get(k, 0) for k in want[key]} == want[key], (
                px, key, got)


def test_chip_smoke_768_kernel_shapes_are_the_sites(monkeypatch):
    """The ff_matmul and group_norm shapes that chip_smoke.py checks and
    times for the 768-px final pass (FF_SHAPES, GN_SHAPES) are the shapes,
    with their calls, that one evaluation of the full-size IP UNet and
    ControlNet makes on the meta device, and they add up to its launch
    counts per evaluation (PER_EVAL, GN_PER_EVAL)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(tgn, "FUSED_MODE", "1")
    ff, gn_ = collections.Counter(), collections.Counter()
    real_ff, real_gn = tgg.ff_matmul, tgn.fused_group_norm

    def spy_ff(x, w1, b1, w2):
        ff[(x.reshape(-1, x.shape[-1]).shape[0], x.shape[-1],
            w2.shape[1])] += 1
        return real_ff(x, w1, b1, w2)

    def spy_gn(x, *a, **k):
        gn_[(x.shape[0], x.shape[1], x.shape[2] * x.shape[3])] += 1
        return real_gn(x, *a, **k)

    monkeypatch.setattr(tgg, "ff_matmul", spy_ff)
    monkeypatch.setattr(tgn, "fused_group_norm", spy_gn)
    cfg = tcfg.sd15_config()
    with torch.device("meta"), torch.no_grad():
        unet = TUNet(dataclasses.replace(cfg.unet, ip_num_tokens=4)).to(
            torch.bfloat16)
        cn = TControlNet(cfg.controlnet).to(torch.bfloat16)
        x = torch.empty(2, 4, 96, 96)
        t = torch.empty(2, dtype=torch.long)
        down, mid = cn(x, t, torch.empty(2, 77, 768),
                       torch.empty(2, 3, 768, 768))
        unet(x, t, torch.empty(2, 81, 768), ip_scale=0.1,
             down_residuals=down, mid_residual=mid)
    for got, shapes, per_eval in (
            (ff, cs.FF_SHAPES, cs.PER_EVAL[cs.FINAL_768]["ff_geglu"]),
            (gn_, cs.GN_SHAPES, cs.GN_PER_EVAL[cs.FINAL_768])):
        listed = {tuple(s): n for model, s, n in shapes
                  if model == cs.FINAL_768}
        assert dict(got) == listed
        assert sum(listed.values()) == per_eval
