"""The port's dp runners and sharded train step over gloo ranks on the
CPU (``parallel/driver.py``, ``parallel/worker.py``,
``training/diffusion.shard_train_step`` with its ``load``,
``training/checkpoint.save_sharded``), against the JAX package's dp runners on
virtual devices and against the port on one rank.

Rank programs are ``tests/torch_mesh_ranks.py``'s (process-group timeout
``TIMEOUT_S``, join limit twice that).  Covered: the dp = 2 character
runner (four characters, DDIM, reference maps captured) against JAX's
``make_dp_character_runner`` on a ``make_mesh(dp=2)`` with the same
latents (2e-5·max(|ref|, 1) on the final latents: test_parallel.py:154-155's
bound scaled to the latents' size; the trajectory and maps under the
batched runners' bounds of
``test_torch_port_batched.py``); the dp = 2 final runner (two dialogues)
against JAX's the same way; both runners at tp = 2 against the port's
one-rank runners; ``shard_train_step`` at dp = 2 (five steps whose losses
match the one-rank step on the same batch and fall) and at tp = 2 (its
losses too, and a checkpoint resharded from the one-rank run's file and
written back equal to it byte for byte).
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from theatergen_tpu.parallel import driver as jdriver
from theatergen_tpu.parallel import mesh as jmesh
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.parallel import driver as tdriver
from theatergen_tpu_torch.training import checkpoint as tckpt
from theatergen_tpu_torch.training import diffusion as trainer

import test_torch_port_turn as turn_tests
import torch_mesh_ranks as ranks
from test_torch_port_batched import MAP_TOL, TRAJ_TOL
from test_torch_port_samplers import _close

torch.set_num_threads(1)

CFG = turn_tests.CFG
PL = CFG.pipeline
h = w = PL.latent_height
STEPS = 2
# the dp runner's final latents against JAX's: test_parallel.py:154-155's
# 2e-5, scaled by max(|ref|, 1) (JAX against JAX there; here two
# frameworks' fp32 sums, and CFG 7.5 carries the latents to |x| ~ 9)
DP_ATOL = 2e-5
# the losses of the sharded step against the one-rank step, fp32 (the
# dp mean and the tp partial sums reorder the same sums)
LOSS_RTOL = 1e-5
JOIN_S = 2 * ranks.TIMEOUT_S


def _spawn(fn, world, tmp_path, inputs, *args):
    torch.save(inputs, os.path.join(tmp_path, "inputs.pt"))
    from theatergen_tpu_torch.parallel import worker

    worker.spawn(fn, world, (str(tmp_path),) + args, timeout_s=JOIN_S)
    return torch.load(os.path.join(tmp_path, "results.pt"),
                      weights_only=False)


def _runner_inputs(tb, b=4, d=2):
    rng = np.random.RandomState(70)
    sam = tdriver.make_dp_character_runner(tb, STEPS)[1]
    lat = (rng.randn(b, 1, h, w, 4) * float(sam.init_noise_sigma)).astype(
        np.float32)
    ctx = rng.randn(b, 2, 20, 32).astype(np.float32)
    scales = [0.4, 0.0, 0.4, 0.0][:b]
    words = [3, 5, 2, 4][:b]
    la = rng.randn(d, STEPS + 1, 1, h, w, 4).astype(np.float32)
    fm = np.zeros((d, h, w), np.float32)
    fm[0, 2:6, 1:5] = 1.0
    fm[1, 1:4, 3:8] = 1.0
    frozen = [1, 2]
    fctx = rng.randn(d, 2, 20, 32).astype(np.float32)
    cn = rng.randn(d, 2, 16, 32).astype(np.float32)
    cond = rng.rand(d, PL.height, PL.width, 3).astype(np.float32)
    t = torch.from_numpy
    char = dict(steps=STEPS, kw={}, latents=t(lat), contexts=t(ctx),
                scales=scales, words=words, generators=None)
    final = dict(steps=STEPS, generators=None, args=(
        t(la), t(fm), frozen, t(fctx), t(cn), t(cond), 0.1, None))
    return char, final, (lat, ctx, scales, words, la, fm, frozen, fctx, cn,
                         cond)


def test_dp2_runners_match_jax_dp_runners(tmp_path):
    """Four characters and two dialogues over dp = 2 ranks: the character
    runner's final latents within DP_ATOL·max(|ref|, 1) of JAX's dp
    runner on a ``make_mesh(dp=2)`` of virtual devices (same latents,
    DDIM), its trajectory within TRAJ_TOL·max(|ref|, 1) and each step's
    maps within MAP_TOL; the final runner's latents within
    DP_ATOL·max(|ref|, 1).  Rows come back in order: group 1's rows are
    rows 2-3."""
    jb, tb = turn_tests._bundles()
    char, final, (lat, ctx, scales, words, la, fm, frozen, fctx, cn,
                  cond) = _runner_inputs(tb)
    res = _spawn(ranks.runners, 2, tmp_path,
                 dict(bundle=tb, char=char, final=final), 2, 1)
    jm = jmesh.make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    jrun, _ = jdriver.make_dp_character_runner(jb, STEPS, jm,
                                               capture_ref_attn=True)
    from test_torch_port_batched import _jax_gins

    jr = jrun(jb.unet_ip_params, jnp.asarray(lat), jnp.asarray(ctx),
              jnp.asarray(scales, jnp.float32), _jax_gins(words),
              jax.random.split(jax.random.key(0), 4))
    tr = res["char"]
    _close(tr.latents.numpy(), jr.latents, DP_ATOL, "final latents")
    _close(tr.trajectory.numpy(), jr.trajectory, TRAJ_TOL, "trajectory")
    for mt, mj in zip(tr.ref_attn, jr.ref_attn):
        _close(mt.numpy(), mj, MAP_TOL, "maps")
    jfrun, _ = jdriver.make_dp_final_runner(jb, STEPS, jm, guided=False)
    jf = jfrun(jb.unet_ip_params, jb.controlnet_params, jnp.asarray(la),
               jnp.asarray(fm), jnp.asarray(frozen, jnp.int32),
               jnp.asarray(fctx), jnp.asarray(cn), jnp.asarray(cond),
               jnp.float32(0.1), None,
               jax.random.split(jax.random.key(1), 2))
    _close(res["final"].numpy(), jf, DP_ATOL, "final pass")
    # the rows went out and came back through the host messages
    assert res["stats"]["scatter"]["count"] == 2
    assert res["stats"]["gather"]["count"] == 2


def test_tp2_runners_match_the_one_rank_runners(tmp_path):
    """The same batches at dp = 1 × tp = 2 (the IP UNet and the ControlNet
    sharded, the towers whole): within TRAJ_TOL·max(|ref|, 1) of the
    port's one-rank runners, maps within MAP_TOL."""
    _, tb = turn_tests._bundles()
    char, final, _ = _runner_inputs(tb, b=2, d=2)
    res = _spawn(ranks.runners, 2, tmp_path,
                 dict(bundle=tb, char=char, final=final), 1, 2)
    run, _ = tdriver.make_dp_character_runner(tb, STEPS,
                                              capture_ref_attn=True)
    ref = run(char["latents"], char["contexts"], char["scales"], None,
              word_tokens=char["words"])
    _close(res["char"].trajectory.numpy(), ref.trajectory.numpy(), TRAJ_TOL,
           "tp trajectory")
    for mt, mr in zip(res["char"].ref_attn, ref.ref_attn):
        _close(mt.numpy(), mr.numpy(), MAP_TOL, "tp maps")
    frun, _ = tdriver.make_dp_final_runner(tb, STEPS, guided=False)
    _close(res["final"].numpy(), frun(*final["args"]).numpy(), TRAJ_TOL,
           "tp final")
    assert res["stats"]["all-gather"]["count"] > 0     # the maps' heads


def _train_inputs(tmp_path, steps=5):
    cfg = tcfg.tiny_config()
    torch.manual_seed(11)
    unet = TUNet(cfg.unet)
    rng = np.random.RandomState(12)
    lat = torch.from_numpy((rng.randn(4, h, w, 4) * 0.2).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(4, cfg.text.max_length, 32)
                           .astype(np.float32))
    t = [torch.from_numpy(rng.randint(0, 1000, 4)) for _ in range(steps)]
    noise = [torch.from_numpy(rng.randn(4, h, w, 4).astype(np.float32))
             for _ in range(steps)]
    return dict(unet=unet, sched=cfg.scheduler, lat=lat, ctx=ctx, t=t,
                noise=noise, steps=steps)


def _one_rank(inp, ckpt_dir=None):
    import copy

    step = trainer.make_train_step(copy.deepcopy(inp["unet"]),
                                   trainer.make_optimizer(lr=1e-3, warmup=0),
                                   inp["sched"], device="cpu")
    state = step.init_state()
    ema = {n: p.clone() for n, p in state.params.items()}
    losses = []
    for i in range(inp["steps"]):
        state, loss = step(state, inp["lat"], inp["ctx"], t=inp["t"][i],
                           noise=inp["noise"][i])
        trainer.ema_update(ema, state.params, 0.9)
        losses.append(float(loss))
    if ckpt_dir:
        tckpt.save_checkpoint(ckpt_dir, {"state": state, "ema": ema})
    return losses


def test_shard_train_step_dp2_matches_one_rank(tmp_path):
    """``shard_train_step`` at dp = 2 (rows 0-1 and 2-3): five steps whose
    losses are the one-rank step's on the same batch and draws within
    LOSS_RTOL, and fall."""
    inp = _train_inputs(tmp_path)
    ref = _one_rank(inp)
    res = _spawn(ranks.train, 2, tmp_path, inp, 2, 1)
    np.testing.assert_allclose(res["losses"], ref, rtol=LOSS_RTOL)
    assert res["losses"][-1] < res["losses"][0]


def test_shard_train_step_tp2_and_its_checkpoint(tmp_path):
    """At tp = 2 the five steps' losses match the one-rank step's within
    LOSS_RTOL (the clip's norm sums each shard's squares once); the
    one-rank run's checkpoint (state and EMA), loaded resharded on two
    ranks and gathered back by ``save_sharded``, is the same two files
    byte for byte."""
    inp = _train_inputs(tmp_path)
    one = str(tmp_path / "one")
    ref = _one_rank(inp, one)
    inp.update(in_ckpt=one, out_ckpt=str(tmp_path / "tp2"))
    res = _spawn(ranks.train, 2, tmp_path, inp, 1, 2)
    np.testing.assert_allclose(res["losses"], ref, rtol=LOSS_RTOL)
    for f in (tckpt.TENSORS, tckpt.TREE):
        assert filecmp.cmp(os.path.join(one, f),
                           os.path.join(tmp_path / "tp2", f), shallow=False)
    back = tckpt.load_checkpoint(str(tmp_path / "tp2"), device="cpu")
    assert back["state"].step == inp["steps"]
    assert set(back["state"].params) == set(
        dict(inp["unet"].named_parameters()))
