"""The port's SD1.5 layers against the JAX package's flax layers.

Each flax module is initialised, its parameters replaced by seeded numpy
values (non-trivial scales and biases), mapped onto the port's module
with ``models/weights.py::from_flax`` and both run on the same numpy
input in fp32.  Tolerances are stated per test: fp32 on both sides, so
the bound covers summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu.models import layers as jl
from theatergen_tpu_torch.models import layers as tl
from theatergen_tpu_torch.models.weights import from_flax

torch.set_num_threads(1)

# fp32 on both sides; the layers sum a few hundred terms at most
ATOL = 2e-5


def randomize(tree, seed):
    """Replace every leaf with seeded values: kernels N(0, 1/fan_in),
    norm scales 1 + N(0, 0.1²), biases N(0, 0.1²)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        shape = x.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(tree))


def port(module, flax_params):
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in from_flax("unet", flax_params).items()}
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nhwc(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 500, 999], np.int32)
    ref = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
    got = tl.timestep_embedding(torch.from_numpy(t), dim).numpy()
    # sin/cos of arguments up to 999 rad: fp32 argument rounding
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm(act):
    x = np.random.RandomState(0).randn(2, 6, 6, 16).astype(np.float32)
    fm = jl.GroupNorm(4, act=act)
    params = randomize(fm.init(jax.random.key(0), jnp.asarray(x))["params"],
                       1)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = tl.GroupNorm(4, 16, act=act)
    tm.load_state_dict({"weight": torch.from_numpy(params["norm"]["scale"]),
                        "bias": torch.from_numpy(params["norm"]["bias"])})
    np.testing.assert_allclose(to_nhwc(tm(nhwc(x))), ref, atol=ATOL)


def test_resnet_block():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    temb = rng.randn(2, 12).astype(np.float32)
    fm = jl.ResnetBlock2D(16, groups=4)
    params = randomize(fm.init(jax.random.key(0), jnp.asarray(x),
                               jnp.asarray(temb))["params"], 3)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(temb)))
    tm = port(tl.ResnetBlock2D(8, 16, 12, groups=4), params)
    np.testing.assert_allclose(
        to_nhwc(tm(nhwc(x), torch.from_numpy(temb))), ref, atol=ATOL)


@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention(cross):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 16).astype(np.float32)
    ctx = rng.randn(2, 7, 12).astype(np.float32) if cross else None
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    fm = jl.CrossAttention(2, 8, use_flash=False)
    params = randomize(fm.init(jax.random.key(0), *args)["params"], 5)
    ref = np.asarray(fm.apply({"params": params}, *args)[0])
    tm = port(tl.CrossAttention(16, 2, 8, 12 if cross else None,
                                use_flash=False), params)
    got = tm(torch.from_numpy(x), torch.from_numpy(ctx) if cross else None)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL)


def test_feed_forward():
    x = np.random.RandomState(6).randn(2, 5, 16).astype(np.float32)
    fm = jl.FeedForward()
    params = randomize(fm.init(jax.random.key(0), jnp.asarray(x))["params"],
                       7)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = port(tl.FeedForward(16), params)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), ref,
                               atol=ATOL)


def test_transformer_2d():
    rng = np.random.RandomState(8)
    x = rng.randn(1, 4, 4, 16).astype(np.float32)
    ctx = rng.randn(1, 7, 12).astype(np.float32)
    fm = jl.Transformer2D(2, 8, groups=4, use_flash=False)
    params = randomize(fm.init(jax.random.key(0), jnp.asarray(x),
                               jnp.asarray(ctx))["params"], 9)
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x),
                              jnp.asarray(ctx)))
    tm = port(tl.Transformer2D(16, 2, 8, 12, groups=4, use_flash=False),
              params)
    np.testing.assert_allclose(to_nhwc(tm(nhwc(x), torch.from_numpy(ctx))),
                               ref, atol=ATOL)
