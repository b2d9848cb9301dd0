"""The port's UNet, text tower and VAE against the JAX package at
``tiny_config()``, on the same weights.

The JAX parameter trees come from ``eval_shape`` filled with seeded numpy
values; the port's modules load them through ``Bundle.load_flax``, which
checks every key (``strict=True``).  Both sides run fp32 on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.clip import CLIPTextEncoder as JText
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.utils.tokenizer import HashTokenizer as JTok
from theatergen_tpu_torch.config import tiny_config
from theatergen_tpu_torch.models.weights import from_flax
from theatergen_tpu_torch.pipelines.bundle import init_bundle

torch.set_num_threads(1)


def random_params(module, seed, *args, **kwargs):
    """The module's flax tree with seeded numpy leaves: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), all else N(0, 0.1²)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.key(0), *args, **kwargs))["params"]
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


@pytest.fixture(scope="module")
def models():
    cfg = jcfg.tiny_config()
    unet, vae, text = JUNet(cfg.unet), JVAE(cfg.vae), JText(cfg.text)
    up = random_params(unet, 0, jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 32)))
    vp = random_params(vae, 1, jnp.zeros((1, 16, 16, 3)))
    tp = random_params(text, 2, jnp.zeros((1, 16), jnp.int32))
    bundle = init_bundle(tiny_config(), 0, device="cpu").load_flax(
        unet=up, vae=vp, text=tp)
    return dict(cfg=cfg, unet=(unet, up), vae=(vae, vp), text=(text, tp),
                bundle=bundle)


@pytest.mark.parametrize("kind", ["unet", "vae", "text"])
def test_bridge_maps_every_key(models, kind):
    module = getattr(models["bundle"], kind)
    sd = from_flax(kind, models[kind][1])
    ref = module.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(ref[k].shape), k
        np.testing.assert_array_equal(ref[k].numpy(), v)


def test_unet_matches(models):
    """eps at two timesteps; bound 5e-5 as test_torch_parity.py (fp32,
    summation order through ~40 layers)."""
    unet, up = models["unet"]
    rng = np.random.RandomState(10)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([999, 500], np.int32)
    ctx = rng.randn(2, 16, 32).astype(np.float32)
    ref = np.asarray(jax.jit(unet.apply)({"params": up}, jnp.asarray(x),
                                         jnp.asarray(t), jnp.asarray(ctx)))
    got = models["bundle"].unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                                torch.from_numpy(t), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=5e-5, rtol=1e-5)


def test_text_encoder_matches(models):
    """Hidden states and pooled output; fp32, 2 layers: bound 5e-5."""
    text, tp = models["text"]
    ids = JTok(1024)(["a knight in a forest", ""], max_length=16)
    h_ref, p_ref = jax.jit(text.apply)({"params": tp}, jnp.asarray(ids))
    h, p = models["bundle"].text(torch.from_numpy(ids).long())
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=5e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), atol=5e-5)


def test_vae_decode_matches(models):
    """Decoder incl. the mid attention; fp32: bound 5e-5."""
    vae, vp = models["vae"]
    z = np.random.RandomState(11).randn(1, 8, 8, 4).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, z: vae.apply(
        {"params": p}, z, method="decode"))(vp, jnp.asarray(z)))
    got = models["bundle"].vae.decode(torch.from_numpy(z).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               atol=5e-5, rtol=1e-5)


def test_vae_encode_matches(models):
    """Encoder → (mean, logvar); fp32: bound 5e-5."""
    vae, vp = models["vae"]
    x = np.random.RandomState(12).randn(1, 16, 16, 3).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: vae.apply(
        {"params": p}, x, method="encode"))(vp, jnp.asarray(x))
    m, lv = models["bundle"].vae.encode(
        torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(m.permute(0, 2, 3, 1).numpy(),
                               np.asarray(mean), atol=5e-5, rtol=1e-5)
    np.testing.assert_allclose(lv.permute(0, 2, 3, 1).numpy(),
                               np.asarray(logvar), atol=5e-5, rtol=1e-5)


def test_configs_match_the_jax_package():
    from theatergen_tpu_torch import config as tcfg

    for name in ("UNetConfig", "VAEConfig", "CLIPTextConfig",
                 "SchedulerConfig", "PipelineConfig"):
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jcfg, name))}
        tf = {f.name: f.default for f in dataclasses.fields(getattr(tcfg, name))}
        assert tf == jf, name
    for fn in ("tiny_config", "sd15_config"):
        j, t = getattr(jcfg, fn)(), getattr(tcfg, fn)()
        for part in ("unet", "vae", "text", "scheduler", "pipeline"):
            assert (dataclasses.asdict(getattr(t, part))
                    == dataclasses.asdict(getattr(j, part))), (fn, part)
