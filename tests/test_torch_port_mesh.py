"""The port's ('dp', 'tp') mesh on the CPU (``parallel/mesh.py``,
``parallel/sp.py``, the tp layers of ``models/layers.py``) against the JAX
package's ``parallel/mesh.py`` and ``parallel/sp.py``.

Multi-rank cases spawn gloo ranks with one thread each
(``tests/torch_mesh_ranks.py``); every process group has a
``TIMEOUT_S`` timeout and every spawn a join limit of twice that, so a
deadlock fails its test instead of running the suite into its limit.
Covered: the tp rules and their coverage over the SD1.5 and SDXL UNets
(the same parameters as JAX at tp = 2, the head fallbacks pinned at SDXL
tp = 4), a tiny IP UNet's forward at tp = 2 against JAX's
``make_mesh(dp=1, tp=2)`` sharded forward and the unsharded one (and at
dp = 2 × tp = 2 on four ranks), two planted faults that must fail that
gate (GEGLU's halves cut contiguously, a row-parallel bias added on every
rank), the collective counts of the tiny forward, the W8A8 UNet at tp = 2
on both routes, chip_smoke's per-rank tp = 2 kernel shapes against one
rank's shard on the meta device, ``sp_attention`` on two ranks against
JAX's on 8 virtual devices, ``parse_mesh_arg``'s messages, and a rank that
raises.
"""

import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.ops import attention as jattn
from theatergen_tpu.parallel import mesh as jmesh
from theatergen_tpu.parallel import sp as jsp
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.cli import generate as tgen
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.models.weights import from_flax
from theatergen_tpu_torch.parallel import mesh as tmesh
from theatergen_tpu_torch.parallel import worker

import test_torch_port_turn as turn_tests
import torch_mesh_ranks as ranks

torch.set_num_threads(1)

h = w = turn_tests.h
# the tp forward against the unsharded one and JAX's sharded one: fp32,
# only the summation order of the row-parallel products differs
# (test_parallel.py:69)
TP_ATOL = 2e-4
# the W8A8 UNet at tp = 2 against the unsharded one: a 1e-6 relative
# change of the tiny W8A8 UNet's input moves its output by 1.9e-2 (route
# "0") and 1.1e-2 (route "1") of max|ref| (an int8 level flipped at a
# rounding boundary), and the partial sums' order is such a change
W8A8_TP_TOL = 5e-2
# a planted fault must move the output by far more than the gate
FAULT_MIN = 1e-2
JOIN_S = 2 * ranks.TIMEOUT_S


def _spawn(fn, world, tmp_path, inputs, *args):
    torch.save(inputs, os.path.join(tmp_path, "inputs.pt"))
    worker.spawn(fn, world, (str(tmp_path),) + args, timeout_s=JOIN_S)
    return torch.load(os.path.join(tmp_path, "results.pt"),
                      weights_only=False)


# ---------------------------------------------------------------- tp rules

def test_param_spec_rules_match_jax():
    """The port's rules, over the port's names, say what JAX's say over
    the same parameters' JAX paths (transposed: JAX kernels are [in,
    out], the port's weights [out, in])."""
    cases = [("down_blocks/x/attn1/to_q/kernel",
              "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
              ".weight"),
             ("mid/x/attn2/to_out_0/kernel",
              "mid_block.attentions.0.transformer_blocks.0.attn2.to_out.0"
              ".weight"),
             ("a/ff/net_0/proj/kernel", "a.ff.net.0.proj.weight"),
             ("a/ff/net_2/kernel", "a.ff.net.2.weight"),
             ("a/attn2/to_k_ip/kernel", "a.attn2.to_k_ip.weight"),
             ("a/attn2/to_q/scale", "a.attn2.to_q.scale"),
             # the UNet's time embedding sits at the top of its tree, where
             # neither package's rule (".*/", ".*\.") reaches it
             ("time_embedding/linear_1/kernel", "time_embedding.linear_1"
              ".weight"),
             ("time_embedding/linear_2/kernel", "time_embedding.linear_2"
              ".weight"),
             ("x/time_embedding/linear_1/kernel", "x.time_embedding"
              ".linear_1.weight"),
             ("x/time_embedding/linear_2/kernel", "x.time_embedding"
              ".linear_2.weight"),
             ("add_embedding/linear_1/kernel", "add_embedding.linear_1"
              ".weight"),
             ("conv_in/kernel", "conv_in.weight"),
             ("a/ff/net_0/proj/bias", "a.ff.net.0.proj.bias")]
    for jpath, tname in cases:
        jspec = tuple(jmesh.param_spec(jpath))
        tspec = tmesh.param_spec(tname)
        want = tuple(reversed(jspec)) if len(jspec) == 2 else jspec
        assert tspec == want, (jpath, jspec, tname, tspec)
    assert tmesh.param_spec("conv_in.weight") == ()
    assert jmesh.param_spec("conv_in/kernel") == P()


def _jax_paths(params) -> dict:
    """JAX path → port name of every leaf: each leaf replaced by a
    one-element array holding its index, through ``from_flax``."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    paths = ["/".join(str(getattr(k, "key", k)) for k in p)
             for p, _ in flat]
    marked = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [np.full((1,) * len(leaf.shape), i, np.float32)
         for i, (_, leaf) in enumerate(flat)])
    names = {int(np.asarray(v).reshape(-1)[0]): n
             for n, v in from_flax("unet", marked).items()}
    return {paths[i]: names[i] for i in range(len(paths))}


def _jax_unet_shapes(cfg):
    ucfg = cfg.unet
    kw = {}
    if ucfg.addition_embed_type == "text_time":
        pooled = (ucfg.projection_class_embeddings_input_dim
                  - 6 * ucfg.addition_time_embed_dim)
        kw = dict(pooled_text=jnp.zeros((1, pooled)),
                  time_ids=jnp.zeros((1, 6)))
    return jax.eval_shape(lambda: JUNet(ucfg).init(
        jax.random.key(0),
        jnp.zeros((1, ucfg.sample_size, ucfg.sample_size, ucfg.in_channels)),
        jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, cfg.text.max_length, ucfg.cross_attention_dim)),
        **kw)["params"])


@pytest.fixture(scope="module")
def full_unets():
    out = {}
    for name, jc, tc in (("sd15", jcfg.sd15_config(), tcfg.sd15_config()),
                         ("sdxl", jcfg.sdxl_config(), tcfg.sdxl_config())):
        with torch.device("meta"):
            tunet = TUNet(tc.unet)
        out[name] = (_jax_unet_shapes(jc), tunet)
    return out


@pytest.mark.parametrize("name,lo,hi", [("sd15", 0.25, 0.35),
                                        ("sdxl", 0.80, 0.90)])
def test_sharding_coverage_matches_jax_at_tp2(full_unets, name, lo, hi):
    """At tp = 2 the port shards exactly the parameters JAX shards (by
    their names through ``from_flax``), with the same fraction, inside
    JAX's bounds (test_parallel.py:229-230), and no fallback."""
    jshapes, tunet = full_unets[name]
    jmesh_2 = jmesh.make_mesh(dp=4, tp=2)
    jcov = jmesh.sharding_coverage(jmesh_2, jshapes)
    tcov = tmesh.sharding_coverage(2, tunet)
    assert jcov["fallback"] == [] and tcov["fallback"] == []
    assert tcov["total_params"] == jcov["total_params"]
    assert tcov["sharded_params"] == jcov["sharded_params"]
    assert lo < tcov["fraction"] < hi
    assert tcov["matched_fraction"] == tcov["fraction"]
    to_port = _jax_paths(jshapes)
    jsharded = {to_port[p] for p in to_port
                if any(s is not None for s in jmesh.param_spec(p))}
    tsharded = {n for n in tunet.state_dict() if tmesh.param_spec(n)}
    assert jsharded == tsharded
    assert set(tmesh.shard_specs(tunet, 2)) >= tsharded


def test_sdxl_tp4_head_fallbacks_pinned(full_unets):
    """At tp = 4 SDXL's 640-channel level has 10 heads, which do not split
    (JAX's guard passes it: 640 % 4 == 0): the port keeps those 20
    attention modules replicated whole, their 80 q/k/v/out weights listed
    under ``fallback`` with the reason; every other matched tensor
    shards."""
    jshapes, tunet = full_unets["sdxl"]
    assert jmesh.sharding_coverage(jmesh.make_mesh(dp=2, tp=4),
                                   jshapes)["fallback"] == []
    cov = tmesh.sharding_coverage(4, tunet)
    fb = cov["fallback"]
    assert len(fb) == 80
    units = {n.rsplit(".", 3)[0] if ".to_out." in n else n.rsplit(".", 2)[0]
             for n in fb}
    assert len(units) == 20
    for n in fb:
        assert n.startswith(("down_blocks.1.attentions.",
                             "up_blocks.1.attentions.")), n
        assert "10 heads do not split over tp=4" in cov["reasons"][n]
    assert cov["sharded_params"] + sum(
        tunet.state_dict()[n].numel() for n in fb) == round(
        cov["matched_fraction"] * cov["total_params"])


# -------------------------------------------------------------- tp forward

def _tp_inputs():
    jb, tb = turn_tests._bundles()
    rng = np.random.RandomState(5)
    x = rng.randn(4, h, w, 4).astype(np.float32)
    t = np.array([501, 300, 501, 999], np.int32)
    ctx = rng.randn(4, 20, 32).astype(np.float32)
    return jb, tb, x, t, ctx


def _jax_sharded(jb, x, t, ctx, dp, tp):
    """JAX's forward with the IP UNet's parameters on a ``make_mesh(dp,
    tp)`` of virtual devices (the batch over dp), and unsharded."""
    unet, params = jb.unet_ip, jb.unet_ip_params

    def fwd(p, a, b, c):
        return unet.apply({"params": p}, a, b, c, ip_scale=0.4)

    ref = fwd(params, x, t, ctx)
    mesh = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    data = jmesh.batch_sharding(mesh)
    out = jax.jit(fwd, in_shardings=(jmesh.param_shardings(mesh, params),
                                     data, data, data))(
        jmesh.shard_params(mesh, params), x, t, ctx)
    return np.asarray(ref), np.asarray(out)


def test_tp2_unet_forward_matches_jax_and_planted_faults_fail(tmp_path):
    """The tiny IP UNet (2 heads, ip_scale 0.4) sharded at tp = 2 on two
    ranks: within TP_ATOL of JAX's ``make_mesh(dp=1, tp=2)`` sharded
    forward and of the unsharded one; each planted fault moves it by more
    than FAULT_MIN.  One all-reduce per row-parallel layer (3 a
    transformer block, 7 blocks; the top-level time embedding stays
    replicated, as in JAX)."""
    jb, tb, x, t, ctx = _tp_inputs()
    ref, jout = _jax_sharded(jb, x, t, ctx, 1, 2)
    res = _spawn(ranks.unet_forward, 2, tmp_path, dict(
        unet=tb.unet_ip, x=torch.from_numpy(x).permute(0, 3, 1, 2),
        t=torch.from_numpy(t).long(), ctx=torch.from_numpy(ctx),
        ip_scale=0.4), 1, 2)
    got = res["out"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=TP_ATOL, rtol=0)
    np.testing.assert_allclose(got, jout, atol=TP_ATOL, rtol=0)
    for fault, out in res["faults"].items():
        moved = float(np.abs(out.permute(0, 2, 3, 1).numpy() - ref).max())
        assert moved > FAULT_MIN, (fault, moved)
    blocks = sum(1 for n, _ in tb.unet_ip.named_modules()
                 if n.endswith("transformer_blocks.0"))
    ar = res["stats"]["all-reduce"]
    assert ar["count"] == 3 * blocks, ar
    assert res["stats"]["all-gather"]["count"] == 0


def test_dp2_tp2_unet_forward_on_four_ranks(tmp_path):
    """dp = 2 × tp = 2 on four ranks (rank = dp·tp_size + tp, as JAX's
    reshape lays devices out): each dp group its two rows, the whole
    batch within TP_ATOL of JAX's ``make_mesh(dp=2, tp=2)`` forward and
    the unsharded one."""
    jb, tb, x, t, ctx = _tp_inputs()
    ref, jout = _jax_sharded(jb, x, t, ctx, 2, 2)
    res = _spawn(ranks.unet_forward, 4, tmp_path, dict(
        unet=tb.unet_ip, x=torch.from_numpy(x).permute(0, 3, 1, 2),
        t=torch.from_numpy(t).long(), ctx=torch.from_numpy(ctx),
        ip_scale=0.4), 2, 2)
    got = res["out"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=TP_ATOL, rtol=0)
    np.testing.assert_allclose(got, jout, atol=TP_ATOL, rtol=0)


@pytest.mark.parametrize("route", ["0", "1"])
def test_tp2_w8a8_unet_forward_matches_unsharded(tmp_path, route):
    """The tiny W8A8 UNet at tp = 2 on both ``THEATERGEN_FUSED_INT8``
    routes: a row-parallel layer quantizes its K half with the whole
    input's amax (all-reduced), so its int8 products are the unsharded
    layer's; the output is within W8A8_TP_TOL·max|ref| of the unsharded
    UNet's (only the fp32 partial sums' order differs, which may move an
    activation across a rounding boundary of the next quantization).  Each
    row-parallel layer adds one all-reduce of its amax."""
    from theatergen_tpu_torch.ops import quant as q_ops
    from theatergen_tpu_torch.pipelines.bundle import init_bundle

    cfg = tcfg.tiny_config()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, quantized=True))
    unet = init_bundle(cfg, 0, device="cpu").unet
    with torch.no_grad():
        for n, p in unet.named_parameters():
            if n.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                    .manual_seed(len(n))) * 0.02)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 4, h, w).astype(np.float32))
    t = torch.tensor([501, 300])
    ctx = torch.from_numpy(rng.randn(2, cfg.text.max_length, 32)
                           .astype(np.float32))
    prev, q_ops.FUSED_MODE = q_ops.FUSED_MODE, route
    try:
        with torch.no_grad():
            ref = unet(x, t, ctx).numpy()
    finally:
        q_ops.FUSED_MODE = prev
    res = _spawn(ranks.unet_forward, 2, tmp_path, dict(
        unet=unet, x=x, t=t, ctx=ctx, ip_scale=1.0, fused_int8=route), 1, 2)
    err = float(np.abs(res["out"].numpy() - ref).max())
    assert err <= W8A8_TP_TOL * float(np.abs(ref).max()), err
    blocks = sum(1 for n, _ in unet.named_modules()
                 if n.endswith("transformer_blocks.0"))
    assert res["stats"]["all-reduce"]["count"] == 2 * 3 * blocks


class _RankZeroOfTp2:
    """Rank 0 of a tp = 2 mesh with its collectives elided (every group
    None): what one rank's layers hold and launch, on one process."""
    tp, tp_index = 2, 0

    def group(self, axis):
        return None


def test_chip_smoke_tp2_kernel_shapes_are_a_ranks_sites(monkeypatch):
    """chip_smoke's per-rank tp = 2 tables (flash and the FF kernel of the
    SD1.5 IP UNet, flash and ``geglu_matmul`` of SDXL, ``quant_matmul`` of
    the W8A8 UNet with QMM_ROW_AMAX marking the row-parallel calls that
    take ``row_amax``) against the kernel calls of one rank's shard of the
    full-size UNets at CFG batch 2 on the meta device."""
    import collections

    from theatergen_tpu_torch.ops import flash_attention as tfa
    from theatergen_tpu_torch.ops import geglu_matmul as tgg
    from theatergen_tpu_torch.ops import quant as tqz
    from theatergen_tpu_torch.ops import quant_matmul as tqm

    import test_torch_port_knobs as knob_tests

    cs = knob_tests._chip_smoke()
    calls = collections.Counter()
    real = tfa.flash_attention, tgg.ff_matmul, tgg.geglu_matmul

    def flash(q, k, v, route=None):
        calls["flash", tuple(q.shape)] += 1
        return real[0](q, k, v, route=route)

    def ff(x, w1, b1, w2):
        calls["ff", (x.numel() // x.shape[-1], x.shape[-1], w2.shape[1])] += 1
        return real[1](x, w1, b1, w2)

    def geglu(hg, w):
        calls["geglu", (hg.numel() // hg.shape[-1], w.shape[1],
                        w.shape[0])] += 1
        return real[2](hg, w)

    def qmm(x, w, scale, bias, row_amax=None):
        calls["qmm", (x.numel() // x.shape[-1], w.shape[1], w.shape[0]),
              row_amax is not None] += 1
        return torch.empty(x.shape[:-1] + (w.shape[0],), dtype=x.dtype,
                           device=x.device)

    monkeypatch.setattr(tfa, "flash_attention", flash)
    monkeypatch.setattr(tgg, "ff_matmul", ff)
    monkeypatch.setattr(tgg, "geglu_matmul", geglu)
    monkeypatch.setattr(tqm, "quant_matmul", qmm)
    monkeypatch.setattr(tqz, "FUSED_MODE", "1")
    tables = {"flash": cs.FLASH_SHAPES, "ff": cs.FF_SHAPES,
              "geglu": cs.GEGLU_SHAPES}
    for model in (cs.SD15_TP2, cs.SDXL_TP2, cs.W8A8_TP2):
        cfg = cs.sdxl_config() if model == cs.SDXL_TP2 else cs.sd15_config()
        ucfg = cfg.unet
        kw = {}
        if model == cs.SD15_TP2:
            ucfg = dataclasses.replace(
                ucfg, ip_num_tokens=cfg.ip_adapter.num_tokens)
            kw["ip_scale"] = 0.4
        if model == cs.W8A8_TP2:
            ucfg = dataclasses.replace(ucfg, quantized=True)
        side = cfg.pipeline.latent_height
        calls.clear()
        with torch.device("meta"), torch.no_grad():
            if model == cs.SDXL_TP2:
                kw = dict(pooled_text=torch.empty(2, 1280),
                          time_ids=torch.empty(2, 6))
            unet = tmesh.shard_module(TUNet(ucfg).to(torch.bfloat16),
                                      _RankZeroOfTp2(), inplace=True)
            unet(torch.empty(2, 4, side, side),
                 torch.empty(2, dtype=torch.long),
                 torch.empty(2, cfg.text.max_length + ucfg.ip_num_tokens,
                             ucfg.cross_attention_dim), **kw)
        if model == cs.W8A8_TP2:
            want = {("qmm", mkn, (model, mkn) in cs.QMM_ROW_AMAX): n
                    for mod, mkn, n in cs.QMM_SHAPES if mod == model}
            got = {k: n for k, n in calls.items() if k[0] == "qmm"}
        else:
            want = {(kind, shape): n for kind, rows in tables.items()
                    for mod, shape, n in rows if mod == model}
            got = dict(calls)
        assert got == want, model


# ---------------------------------------------------------- sequence par.

def test_sp_attention_matches_jax_and_rejects_indivisible(tmp_path):
    """``sp_attention`` over two ranks (each a quarter... a half of Sq)
    against JAX's ``sp_attention(use_flash=False)`` over 8 virtual
    devices and the unsharded attention (1e-5, test_parallel.py:276);
    an Sq that does not divide raises ValueError on every rank, as in
    JAX."""
    b, s, hh, d = 2, 64, 2, 8
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(b, s, hh, d).astype(np.float32) for _ in range(3))
    jm = jmesh.make_mesh(dp=8, tp=1)
    jout = np.asarray(jsp.sp_attention(
        *(jsp.sp_sharded(jm, jnp.asarray(a)) for a in (q, k, v)), jm,
        use_flash=False))
    ref = np.asarray(jattn.multi_head_attention(q, k, v, use_flash=False)[0])
    res = _spawn(ranks.sp_attention, 2, tmp_path,
                 {n: torch.from_numpy(a) for n, a in zip("qkv", (q, k, v))})
    got = res["out"].numpy()
    np.testing.assert_allclose(got, jout, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert res["raised"]
    with pytest.raises(ValueError):
        jsp.sp_attention(jnp.zeros((1, 60, 2, 8)), jnp.zeros((1, 60, 2, 8)),
                         jnp.zeros((1, 60, 2, 8)), jm)


# ----------------------------------------------------------- the launcher

def test_parse_mesh_arg_keeps_jax_messages():
    """'dp=N[,tp=M]' → MeshConfig; an unknown axis and too few devices
    exit with the JAX CLI's messages (cli/generate.py:236-256)."""
    assert tgen.parse_mesh_arg(None) is None
    assert tgen.parse_mesh_arg("dp=2,tp=1", "cpu") == tcfg.MeshConfig(2, 1)
    assert tgen.parse_mesh_arg("tp=2", "cpu") == tcfg.MeshConfig(1, 2)
    with pytest.raises(SystemExit, match=r"unknown axis 'pp' \(use "
                       r"dp=N\[,tp=M\]\)"):
        tgen.parse_mesh_arg("dp=2,pp=2", "cpu")
    with pytest.raises(SystemExit, match=r"needs 100000 devices, have"):
        tgen.parse_mesh_arg("dp=100000", "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match=r"needs 2 devices, have 0"):
            tgen.parse_mesh_arg("dp=2", "cuda")


def test_cuda_mesh_without_nccl_raises():
    """The backend follows the device; a CUDA mesh with no NCCL and no
    explicit backend raises instead of taking gloo."""
    assert tmesh.backend_for("cpu") == "gloo"
    assert tmesh.backend_for("cuda", "gloo") == "gloo"
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match="needs NCCL"):
            tmesh.backend_for("cuda")


def test_a_rank_that_raises_ends_every_rank(tmp_path):
    """Rank 1's command raises: rank 0 gets the RankError, aborts the
    workers, and the run fails well within the join limit (no hang)."""
    import torch.multiprocessing as tmp

    t0 = time.monotonic()
    with pytest.raises((tmp.ProcessRaisedException,
                        tmp.ProcessExitedException)) as err:
        _spawn(ranks.rank_raises, 2, tmp_path, {})
    assert time.monotonic() - t0 < ranks.TIMEOUT_S
    assert "planted failure on rank 1" in str(err.value) or \
        "exit code 1" in str(err.value)
