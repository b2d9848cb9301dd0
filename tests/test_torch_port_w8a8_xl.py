"""The W8A8 SDXL UNet in the port against the JAX package: the quantized
sites of ``tiny_xl_config()`` (``add_embedding`` left float), the
quantized tiny XL UNet's eps on both routes, ``sdxl_config()``'s
QuantLinear count and launch derivation on the meta device, the seeded
bundle, ``qmm_plan`` at every SDXL shape, and the quantized GLIGEN tree,
which fails in both packages.

Inputs come from numpy seeds; both sides run on the CPU, the port with one
torch thread.  Route "1" of the JAX package is its Pallas kernel, which
runs on a TPU only; here it takes ``reference_quant_matmul``, the kernel's
arithmetic in plain XLA, as ``tests/test_torch_port_quant.py`` holds the
port's sites against it.
"""

import collections
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ScopeParamNotFoundError

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.ops import quant as JQ
from theatergen_tpu.ops import quant_matmul as JQM
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models import layers as tl
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.models.weights import from_flax
from theatergen_tpu_torch.ops import quant as TQ
from theatergen_tpu_torch.ops import quant_matmul as TQM
from theatergen_tpu_torch.pipelines.bundle import init_bundle

from test_torch_port_gligen import random_params

torch.set_num_threads(1)


def _quantized(cfg):
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, quantized=True))


def _cond(ucfg, batch, seed):
    rng = np.random.RandomState(seed)
    pooled = (ucfg.projection_class_embeddings_input_dim
              - 6 * ucfg.addition_time_embed_dim)
    return dict(pooled_text=rng.randn(batch, pooled).astype(np.float32),
                time_ids=rng.uniform(0, 64, (batch, 6)).astype(np.float32))


def _jax_params(jc, seed, **kw):
    ucfg = jc.unet
    cond = {k: jnp.asarray(v) for k, v in _cond(ucfg, 1, 0).items()}
    return random_params(JUNet(ucfg), seed, jnp.zeros((1, 8, 8, 4)),
                         jnp.zeros((1,), jnp.int32),
                         jnp.zeros((1, 16, ucfg.cross_attention_dim)),
                         **cond, **kw)


@pytest.fixture
def route(monkeypatch):
    """Set both packages' THEATERGEN_FUSED_INT8 route; at "1" the JAX
    QuantDense takes reference_quant_matmul (the Pallas kernel's
    arithmetic; its gate admits only a TPU backend)."""

    def set_route(mode):
        monkeypatch.setattr(TQ, "FUSED_MODE", mode)
        if mode == "1":
            monkeypatch.setattr(JQ, "_use_fused_kernel", lambda: True)
            monkeypatch.setattr(
                JQM, "quant_matmul",
                lambda x, w, s, out_dtype=None, **_: JQM.
                reference_quant_matmul(x.astype(jnp.float32), w, s).astype(
                    out_dtype or x.dtype))

    return set_route


def test_quantized_sites_match_jax_xl():
    """The QuantLinears of the quantized tiny XL UNet are the kernel_q
    subtrees of the JAX quantize_params tree, through the weight bridge,
    and the float UNet's linears the port's patterns name; the only float
    linears left are add_embedding's, as in the JAX package."""
    qtree = JQ.quantize_params(_jax_params(jcfg.tiny_xl_config(), 0))
    sd = from_flax("unet", qtree)
    from_jax = {k[:-len(".weight")] for k, v in sd.items()
                if v.dtype == np.int8}
    ucfg = tcfg.tiny_xl_config().unet
    with torch.device("meta"):
        q_unet = TUNet(dataclasses.replace(ucfg, quantized=True))
        f_unet = TUNet(ucfg)
    port = {n for n, m in q_unet.named_modules()
            if isinstance(m, tl.QuantLinear)}
    by_pattern = {n for n, m in f_unet.named_modules()
                  if isinstance(m, torch.nn.Linear) and TQ.is_quant_path(n)}
    assert port == from_jax == by_pattern and len(port) == 8 * 10 + 8 + 2
    left = {n for n, m in q_unet.named_modules()
            if isinstance(m, torch.nn.Linear)}
    assert left == {"add_embedding.linear_1", "add_embedding.linear_2"}
    assert sd["add_embedding.linear_1.weight"].dtype == np.float32
    assert set(sd) == set(q_unet.state_dict())


@pytest.fixture(scope="module")
def tiny_xl_w8a8():
    """The JAX float and quantized tiny XL UNets on one seeded tree, the
    port's UNets loaded with the same trees, and one CFG-batch input."""
    jc = jcfg.tiny_xl_config()
    params = _jax_params(jc, 0)
    qparams = JQ.quantize_params(params)
    port_q = init_bundle(_quantized(tcfg.tiny_xl_config()), 0, device="cpu")
    port_f = init_bundle(tcfg.tiny_xl_config(), 0, device="cpu")
    rng = np.random.RandomState(11)
    d = jc.unet.cross_attention_dim
    inputs = (rng.randn(2, 8, 8, 4).astype(np.float32),
              np.array([999, 500], np.int32),
              rng.randn(2, 16, d).astype(np.float32),
              _cond(jc.unet, 2, 12))
    return dict(jax_f=_jax_eps((JUNet(jc.unet), params), *inputs),
                jax_q=(JUNet(_quantized(jc).unet), qparams),
                port_q=port_q.load_flax(unet=qparams).unet,
                port_f=_port_eps(port_f.load_flax(unet=params).unet,
                                 *inputs), inputs=inputs)


def _jax_eps(model, x, t, ctx, cond):
    unet, params = model
    return np.asarray(jax.jit(lambda p, *a: unet.apply(
        {"params": p}, *a, pooled_text=jnp.asarray(cond["pooled_text"]),
        time_ids=jnp.asarray(cond["time_ids"])))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))


def _port_eps(unet, x, t, ctx, cond):
    with torch.no_grad():
        out = unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), torch.from_numpy(ctx),
                   **{k: torch.from_numpy(v) for k, v in cond.items()})
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mode", ["0", "1"])
def test_quantized_xl_unet_matches_jax(route, tiny_xl_w8a8, mode):
    """One quantized tiny XL evaluation (CFG batch 2, pooled text and time
    ids) against the JAX quantized UNet on the same quantize_params tree,
    held as the SD1.5 tiny UNet is
    (``test_torch_port_quant.py::test_quantized_unet_matches_jax``): the
    float UNets within 5e-5; each side's quantized-vs-float difference at
    least 1e-2·max|ref|, the port's within a factor 1.5 of the JAX
    package's, and port and JAX at most 1.5 times the JAX package's apart
    (the fp32 layers between the sites sum in another order, which can
    flip an int8 rounding tie, so the two are draws of the quantization
    error)."""
    route(mode)
    inputs = tiny_xl_w8a8["inputs"]
    ref = _jax_eps(tiny_xl_w8a8["jax_q"], *inputs)
    ref_f = tiny_xl_w8a8["jax_f"]
    got = _port_eps(tiny_xl_w8a8["port_q"], *inputs)
    got_f = tiny_xl_w8a8["port_f"]
    np.testing.assert_allclose(got_f, ref_f, atol=5e-5, rtol=1e-5)
    jax_err = np.abs(ref - ref_f).max()
    port_err = np.abs(got - got_f).max()
    assert jax_err >= 1e-2 * np.abs(ref).max()
    assert jax_err / 1.5 <= port_err <= 1.5 * jax_err
    assert np.abs(got - ref).max() <= 1.5 * jax_err


def test_sdxl_quantized_unet_has_719_quant_linears():
    """70 transformer blocks x 10, 17 time_emb_proj, 2 time_embedding;
    add_embedding's two linears stay float."""
    with torch.device("meta"):
        unet = TUNet(_quantized(tcfg.sdxl_config()).unet)
    names = [n for n, m in unet.named_modules()
             if isinstance(m, tl.QuantLinear)]
    assert len(names) == 719
    assert sum(".transformer_blocks." in n for n in names) == 700
    assert sum(n.endswith("time_emb_proj") for n in names) == 17
    assert sum(n.startswith("time_embedding.") for n in names) == 2
    assert isinstance(unet.add_embedding.linear_1, torch.nn.Linear)


def test_quantized_xl_init_bundle_is_the_float_bundle_quantized():
    """init_bundle of the quantized tiny XL config draws every weight where
    the float one does: its UNet's state dict is the float UNet's
    quantized, bit for bit, and the towers and the VAE are equal."""
    q = init_bundle(_quantized(tcfg.tiny_xl_config()), 3, device="cpu")
    f = init_bundle(tcfg.tiny_xl_config(), 3, device="cpu")
    want = TQ.quantize_state_dict(f.unet.state_dict())
    got = q.unet.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    for name in ("vae", "text", "text2"):
        for k, v in getattr(q, name).state_dict().items():
            assert torch.equal(v, getattr(f, name).state_dict()[k]), k


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sdxl_qmm_calls():
    """(M, K, N) → calls of one W8A8 SDXL evaluation at 1024 px, CFG
    batch 2, read by hooks on a meta-device forward at route "1"."""
    ucfg = _quantized(tcfg.sdxl_config()).unet
    with torch.device("meta"):
        unet = TUNet(ucfg).to(torch.bfloat16)
    calls = collections.Counter()

    def hook(mod, args, out):
        x = args[0]
        calls[(x.numel() // x.shape[-1], mod.in_features,
               mod.out_features)] += 1

    for m in unet.modules():
        if isinstance(m, tl.QuantLinear):
            m.register_forward_hook(hook)
    prev, TQ.FUSED_MODE = TQ.FUSED_MODE, "1"
    try:
        with torch.no_grad():
            unet(torch.zeros(2, 4, 128, 128, device="meta"),
                 torch.zeros(2, dtype=torch.long, device="meta"),
                 torch.zeros(2, 77, 2048, device="meta"),
                 pooled_text=torch.zeros(2, 1280, device="meta"),
                 time_ids=torch.zeros(2, 6, device="meta"))
    finally:
        TQ.FUSED_MODE = prev
    return calls


def test_chip_smoke_sdxl_w8a8_shapes_and_launches(sdxl_qmm_calls):
    """chip_smoke.py's W8A8 SDXL constants against the meta forward: its
    kernel rows are every (M, K, N) of one evaluation with its calls, 719
    in all, and eval_launches derives QMM_XL_PER_EVAL quant_matmul
    launches (with SDXL's flash, GroupNorm and cross-attention sites) at
    route "1"."""
    cs = _chip_smoke()
    rows = {shape: calls for model, shape, calls in cs.QMM_SHAPES
            if model == cs.W8A8_XL}
    assert rows == dict(sdxl_qmm_calls)
    assert sum(rows.values()) == cs.QMM_XL_PER_EVAL == 719
    prev_q, prev_gn = TQ.FUSED_MODE, cs.gn.FUSED_MODE
    TQ.FUSED_MODE, cs.gn.FUSED_MODE = "1", "1"
    try:
        got = cs.eval_launches(_quantized(tcfg.sdxl_config()).unet, 128, 2)
    finally:
        TQ.FUSED_MODE, cs.gn.FUSED_MODE = prev_q, prev_gn
    assert dict(got) == dict(flash_attention=70, group_norm=42,
                             quant_matmul=719, cross_attention=70)


@pytest.mark.parametrize("slots", [66, 132, 264])
def test_qmm_plan_valid_at_every_sdxl_shape(sdxl_qmm_calls, slots):
    """The split planner (fitted to SD1.5's 19 shapes) gives a launch the
    kernel takes at every SDXL shape: a built cluster size that divides
    the column tiles, the kernel's tiles, a split count that divides the
    K steps, K a multiple of BLOCK_K (no launch here)."""
    for m, k, n in sdxl_qmm_calls:
        c, bm, bn, splits = TQM.qmm_plan(m, n, k, slots)
        _, nt, steps = TQM.qmm_tiles(m, n, k)
        assert c in TQM.QMM_CLUSTERS and nt % c == 0, (m, k, n)
        assert (bm, bn) == (TQM.QMM_BM, TQM.QMM_BN)
        assert splits >= 1 and steps % splits == 0, (m, k, n, splits)
        assert k % TQM.BLOCK_K == 0


def test_quantized_gligen_tree_fails_in_both_packages():
    """JAX's quantize_params matches the fusers' attention and FF linears
    by their names (7 fusers x 6 on the tiny UNet), but a quantized UNet
    builds its fusers float, so the JAX UNet fails at its first call with
    objs (ScopeParamNotFoundError) and runs without them.  The port does
    the same: quantize_state_dict quantizes the same 42 sites (named as
    the bridge names JAX's), and the quantized GLIGEN UNet refuses that
    state dict (ValueError); a quantized GLIGEN UNet built whole keeps
    its fusers float and runs with objs."""
    jc = jcfg.tiny_config()
    d = jc.unet.cross_attention_dim
    params = _jax_params_sd15(jc, d)
    qtree = JQ.quantize_params(params)
    jq_sites = {k[:-len(".weight")] for k, v in from_flax("unet", qtree).items()
                if v.dtype == np.int8 and ".fuser." in k}
    assert len(jq_sites) == 42
    x, t, ctx = (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                 jnp.zeros((1, 16, d)))
    junet = JUNet(_quantized(jc).unet)
    # traced only (eval_shape): the failure is at trace time
    with pytest.raises(ScopeParamNotFoundError):
        jax.eval_shape(lambda: junet.apply({"params": qtree}, x, t, ctx,
                                           objs=jnp.zeros((1, 3, d))))
    assert jax.eval_shape(lambda: junet.apply(
        {"params": qtree}, x, t, ctx)).shape == (1, 8, 8, 4)

    fb = TUNet(tcfg.tiny_config().unet, gligen=True)
    fb.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                        for k, v in from_flax("unet", params).items()})
    qsd = TQ.quantize_state_dict(fb.state_dict())
    port_sites = {k[:-len(".scale")] for k in qsd
                  if ".fuser." in k and k.endswith(".scale")}
    assert port_sites == jq_sites
    qunet = TUNet(_quantized(tcfg.tiny_config()).unet, gligen=True)
    with pytest.raises(ValueError, match="fusers are float"):
        qunet.load_state_dict(qsd)
    assert not any(isinstance(m, tl.QuantLinear) for n, m in
                   qunet.named_modules() if ".fuser." in n)
    with torch.no_grad():
        out = qunet(torch.zeros(1, 4, 8, 8), torch.zeros(1, dtype=torch.long),
                    torch.zeros(1, 16, d), objs=torch.zeros(1, 3, d))
    assert out.shape == (1, 4, 8, 8)


def _jax_params_sd15(jc, d):
    return random_params(JUNet(jc.unet), 0, jnp.zeros((1, 8, 8, 4)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, d)),
                         objs=jnp.zeros((1, 3, d)))
