"""The port's training checkpoints, and a JAX training state carried over
into the port, on the CPU.

The port's ``save_checkpoint``/``load_checkpoint`` round-trip a state and
its EMA bit for bit; ``latest_step_dir`` agrees with the JAX package's on
one directory listing; and a JAX ``TrainState`` saved with the JAX
package's own ``save_checkpoint`` (orbax, in this test only) and restored
there, carried over by ``from_flax_train_state``, takes one more step on
both sides with the same draws.  Each test states its bound.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu.training import checkpoint as jckpt
from theatergen_tpu.training import diffusion as jtrain
from theatergen_tpu_torch.training import checkpoint as tckpt
from theatergen_tpu_torch.training import diffusion as ttrain

from test_torch_port_train import (_compare_params, _np, flat_port, ip_filter,
                                   jax_draws, jax_step, port_unet, setup)

torch.set_num_threads(1)

__all__ = ["setup"]


def _stepped(setup, steps=2, trainable_filter=None):
    unet, cfg = port_unet(setup["params"])
    ts = ttrain.make_train_step(unet, ttrain.make_optimizer(lr=1e-3,
                                                            warmup=0),
                                cfg.scheduler, device="cpu",
                                trainable_filter=trainable_filter)
    state = ts.init_state()
    g = torch.Generator().manual_seed(0)
    lat, ctx = torch.from_numpy(setup["lat"]), torch.from_numpy(setup["ctx"])
    for _ in range(steps):
        state, _ = ts(state, lat, ctx, g)
    return ts, state


def _assert_trees_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (ttrain.TrainState, ttrain.AdamWState)):
        for f in a.__dataclass_fields__:
            _assert_trees_equal(getattr(a, f), getattr(b, f))
    else:
        assert a == b


def test_checkpoint_round_trip_is_bit_for_bit(setup, tmp_path):
    """A state after two steps (fp32 masters, moments, counts, step) and
    its EMA, saved and loaded: equal bit for bit, every tensor a copy;
    with a target, each tensor takes the target's dtype; force=False
    refuses an existing directory."""
    ts, state = _stepped(setup)
    ema = {n: p.clone() for n, p in state.params.items()}
    ttrain.ema_update(ema, state.params, 0.9)
    tree = {"state": state, "ema": ema,
            "meta": {"epoch": 1, "rate": 2.5, "note": None, "tag": "x"}}
    path = str(tmp_path / "ck" / "step_2")
    tckpt.save_checkpoint(path, tree)
    assert sorted(os.listdir(path)) == ["tensors.safetensors", "tree.json"]
    back = tckpt.load_checkpoint(path, device="cpu")
    _assert_trees_equal(back, tree)
    name = next(iter(state.params))
    assert back["state"].params[name].data_ptr() != \
        state.params[name].data_ptr()
    half = {"state": state, "ema": {n: p.half() for n, p in ema.items()},
            "meta": tree["meta"]}
    back = tckpt.load_checkpoint(path, target=half)
    assert back["ema"][name].dtype == torch.float16
    assert torch.equal(back["ema"][name], ema[name].half())
    with pytest.raises(FileExistsError):
        tckpt.save_checkpoint(path, tree, force=False)
    # the resumed step goes on from the loaded state as from the live one
    lat, ctx = torch.from_numpy(setup["lat"]), torch.from_numpy(setup["ctx"])
    g = torch.Generator().manual_seed(9)
    t = torch.randint(0, 1000, (2,), generator=g)
    noise = torch.randn(setup["lat"].shape, generator=g)
    loaded = tckpt.load_checkpoint(path, device="cpu")["state"]
    a, _ = ts(loaded, lat, ctx, t=t, noise=noise)
    b, _ = ts(state, lat, ctx, t=t, noise=noise)
    _assert_trees_equal(a, b)


def test_load_needs_the_card_unless_asked(setup, tmp_path):
    _, state = _stepped(setup, 1, ip_filter)
    tckpt.save_checkpoint(str(tmp_path / "s"), state)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tckpt.load_checkpoint(str(tmp_path / "s"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tckpt.from_flax_train_state({}, (), 0)
    back = tckpt.load_checkpoint(str(tmp_path / "s"), device="cpu")
    assert set(back.opt_state.mu) == set(state.opt_state.mu)


def test_latest_step_dir_agrees_with_jax(tmp_path):
    """The listing of tests/test_parallel.py:166-180 and more: step
    numbers compared as integers, names that do not parse skipped, a
    missing or empty root gives None."""
    assert tckpt.latest_step_dir(str(tmp_path / "none")) is None
    assert jckpt.latest_step_dir(str(tmp_path / "none")) is None
    root = tmp_path / "ck"
    root.mkdir()
    assert tckpt.latest_step_dir(str(root)) is None
    for name in ("step_7", "step_10", "step_9", "step_x", "other", "step_"):
        (root / name).mkdir()
    (root / "step_3.tmp").mkdir()
    got = tckpt.latest_step_dir(str(root))
    assert got == jckpt.latest_step_dir(str(root))
    assert got.endswith("step_10")


def test_a_jax_state_goes_on_in_the_port(setup, tmp_path):
    """A JAX TrainState after two steps of the IP recipe (lr 1e-3, no
    warmup), saved by the JAX package's save_checkpoint (orbax) and
    restored there, carried over by from_flax_train_state: its params and
    moments are from_flax's of the restored trees bit for bit, its counts
    2; one more step on both sides with the same draws gives the same
    loss within 1e-4 relative and parameters within _compare_params's
    bounds (the frozen ones bit-equal), and the same moments within 4e-4
    of each tensor's max|ref| (the moments take in this step's gradients,
    which agree within 2e-4 of max|ref|, the bound of
    test_loss_and_every_gradient_match_jax, and ν their squares)."""
    lr = 1e-3
    jopt = jtrain.make_optimizer(lr=lr, warmup=0)
    jstep = jax_step(setup, jopt, ip_filter)
    jstate = jtrain.TrainState(setup["params"], jopt.init(setup["params"]),
                               jnp.int32(0))
    lat, ctx = jnp.asarray(setup["lat"]), jnp.asarray(setup["ctx"])
    for i in range(2):
        jstate, _ = jstep(jstate, lat, ctx, jax.random.key(20 + i))
    path = str(tmp_path / "jax" / "step_2")
    jckpt.save_checkpoint(path, jstate)
    restored = jax.device_get(jckpt.load_checkpoint(path, target=jstate))
    state = tckpt.from_flax_train_state(restored.params, restored.opt_state,
                                        restored.step, device="cpu")
    assert state.step == 2 and state.opt_state.count == 2
    adam = restored.opt_state[1][0]
    for mine, tree in ((state.params, restored.params),
                       (state.opt_state.mu, adam.mu),
                       (state.opt_state.nu, adam.nu)):
        want = flat_port(tree)
        assert set(mine) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(_np(mine[k]), v, err_msg=k)

    unet, cfg = port_unet(setup["params"])
    ts = ttrain.make_train_step(unet, ttrain.make_optimizer(lr=lr, warmup=0),
                                cfg.scheduler, trainable_filter=ip_filter,
                                device="cpu")
    key = jax.random.key(22)
    jnew, jloss = jstep(jstate, lat, ctx, key)
    t, noise = jax_draws(key, setup["lat"].shape)
    new, loss = ts(state, torch.from_numpy(setup["lat"]),
                   torch.from_numpy(setup["ctx"]), t=t, noise=noise)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    assert new.step == 3 and new.opt_state.count == 3
    frozen = {n for n in setup["names"].values() if n not in ts.trainable}
    _compare_params(new.params, jnew.params, setup["names"], lr, 1,
                    frozen=frozen)
    jadam = jnew.opt_state[1][0]
    for mine, tree in ((new.opt_state.mu, jadam.mu),
                       (new.opt_state.nu, jadam.nu)):
        want = flat_port(tree)
        for k in ts.trainable:
            np.testing.assert_allclose(
                _np(mine[k]), want[k], rtol=0,
                atol=4e-4 * np.abs(want[k]).max(), err_msg=k)
