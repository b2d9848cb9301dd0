"""The port's txt2img slice against the JAX package's ``pipelines/sd.py``
at ``tiny_config()``: DDIM tables, tokenizer ids, and prompt encoding →
4-step DDIM/CFG denoise → VAE decode on the same weights, with the same
numpy initial latents handed to both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.clip import CLIPTextEncoder as JText
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.ops import scheduler as jsched
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.ops import scheduler as tsched
from theatergen_tpu_torch.pipelines import sd as tsd
from theatergen_tpu_torch.pipelines.bundle import init_bundle
from theatergen_tpu_torch.utils import tokenizer as ttok

torch.set_num_threads(1)

PROMPTS = ["a red knight rides through a dark forest", "two cats, one dog!"]


def random_params(module, seed, *args):
    """Flax tree of ``module`` with seeded numpy leaves (kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), the rest N(0, 0.1²))."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), *args))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.mark.parametrize("steps,fast,kw", [
    (50, None, {}), (4, None, {}), (20, 5, {}),
    (50, None, dict(beta_schedule="linear", set_alpha_to_one=True)),
    (25, None, dict(rescale_zero_terminal_snr=True))])
def test_ddim_tables_equal(steps, fast, kw):
    j = jsched.make_schedule(jcfg.SchedulerConfig(**kw), steps,
                             fast_after_steps=fast)
    t = tsched.make_schedule(tcfg.SchedulerConfig(**kw), steps,
                             fast_after_steps=fast)
    for name in ("timesteps", "alphas_cumprod", "alpha_prod",
                 "alpha_prod_prev"):
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))


@pytest.mark.parametrize("pred,eta", [("epsilon", 0.0), ("epsilon", 0.5),
                                      ("v_prediction", 0.0),
                                      ("sample", 0.0)])
def test_ddim_step_matches(pred, eta):
    """One step at every loop position (the port reading its device
    tables), with injected noise where eta > 0; fp32 elementwise: bound
    2e-6 relative to O(1) latents."""
    sched_j = jsched.make_schedule(
        jcfg.SchedulerConfig(prediction_type=pred), 10)
    tables = tsched.device_tables(tsched.make_schedule(
        tcfg.SchedulerConfig(prediction_type=pred), 10), "cpu")
    assert tables.prediction_type == pred
    rng = np.random.RandomState(3)
    x, eps, noise = (rng.randn(2, 4, 4, 4).astype(np.float32)
                     for _ in range(3))
    for i in range(10):
        ref = jsched.ddim_step(sched_j, jnp.asarray(eps), i, jnp.asarray(x),
                               eta=eta, noise=jnp.asarray(noise))
        got = tsched.ddim_step(tables, torch.from_numpy(eps), i,
                               torch.from_numpy(x), eta=eta,
                               noise=torch.from_numpy(noise))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6,
                                   rtol=2e-6)


@pytest.mark.parametrize("vocab", [1024, 49408])
def test_tokenizer_ids_equal(vocab):
    texts = PROMPTS + ["", "x " * 100, "Ünïcode &amp; HTML's"]
    j = jtok.HashTokenizer(vocab)
    t = ttok.HashTokenizer(vocab)
    np.testing.assert_array_equal(t(texts, max_length=16), j(texts, max_length=16))
    np.testing.assert_array_equal(t(texts), j(texts))
    assert type(ttok.load_tokenizer(None, vocab)).__name__ == "HashTokenizer"


def test_text2img_slice_matches():
    """encode_prompts → denoise (4 steps, CFG 7.5, same initial latents) →
    decode_with.  fp32 on both sides; CFG at 7.5 amplifies the eps
    difference of each step and the latents grow to O(10), so latents get
    2e-4 absolute and the [0, 1] image 5e-5."""
    cfg = jcfg.tiny_config()
    unet, vae, text = JUNet(cfg.unet), JVAE(cfg.vae), JText(cfg.text)
    up = random_params(unet, 0, jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 32)))
    vp = random_params(vae, 1, jnp.zeros((1, 16, 16, 3)))
    tp = random_params(text, 2, jnp.zeros((1, 16), jnp.int32))
    jb = JBundle(cfg=cfg, tokenizer=jtok.HashTokenizer(1024), unet=unet,
                 unet_params=up, vae=vae, vae_params=vp, text=text,
                 text_params=tp)
    tb = init_bundle(tcfg.tiny_config(), 0, device="cpu").load_flax(
        unet=up, vae=vp, text=tp)
    lat = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)

    ctx_j = jsd.encode_prompts(jb, PROMPTS)
    ctx_t = tsd.encode_prompts(tb, PROMPTS)
    np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j), atol=5e-5)

    sched_j = jsched.make_schedule(cfg.scheduler, 4)

    def unet_apply(x, t, ctx):
        return unet.apply({"params": up}, x,
                          jnp.broadcast_to(t[None], (x.shape[0],)), ctx)

    @jax.jit
    def run_j(lat, ctx):
        final, traj = jsd.denoise(unet_apply, sched_j, lat, ctx, 7.5,
                                  collect_trajectory=True)
        return traj, jsd.decode_with(vae, vp, cfg.vae.scaling_factor, final)

    traj_j, img_j = run_j(jnp.asarray(lat), ctx_j)
    final, traj_t = tsd.denoise(tb.unet, tsched.make_schedule(
        tb.cfg.scheduler, 4), torch.from_numpy(lat), ctx_t, 7.5,
        collect_trajectory=True)
    img_t = tsd.decode_with(tb.vae, tb.cfg.vae.scaling_factor, final)

    assert traj_t.shape == (5, 2, 8, 8, 4)
    np.testing.assert_array_equal(traj_t[0].numpy(), lat)
    np.testing.assert_allclose(traj_t.numpy(), np.asarray(traj_j), atol=2e-4)
    assert img_t.shape == (2, 16, 16, 3)
    assert 0.0 <= float(img_t.min()) and float(img_t.max()) <= 1.0
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=5e-5)


def test_text2img_runs_end_to_end():
    """The entry point a user calls: seeded, deterministic, [B, H, W, 3] in
    [0, 1]."""
    b = init_bundle(tcfg.tiny_config(), 0, device="cpu")
    pipe = tsd.Text2Img(b, num_steps=3)
    a = pipe(torch.Generator().manual_seed(5), "a knight")
    c = pipe(torch.Generator().manual_seed(5), "a knight")
    assert a.shape == (1, 16, 16, 3)
    assert torch.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0
    torch.testing.assert_close(a, c, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tsd.encode_prompts(b, ["a", "b"], ["only one", "two", "three"])
