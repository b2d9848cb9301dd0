"""GLIGEN in the port against the JAX package: ``PositionNet`` (phrase
embeddings and boxes → grounding tokens), ``GatedSelfAttention`` (the
fuser) and the UNet's ``objs`` in the full and the DeepCache shallow
forward, at ``tiny_config()`` and ``tiny_xl_config()``; the zero-gate
identity, the constructor's refusals, the fuser's kernel routes and the tp
rules' coverage of a GLIGEN UNet.

The JAX trees come from ``eval_shape`` filled with seeded numpy values
(the scalar gates too, so they are non-zero); the port loads them through
``from_flax``.  Both sides run fp32 on the CPU, the port with one torch
thread.
"""

import collections
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.ip_adapter import PositionNet as JPositionNet
from theatergen_tpu.models.layers import GatedSelfAttention as JFuser
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.parallel import mesh as jmesh
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models import layers as tl
from theatergen_tpu_torch.models.ip_adapter import PositionNet
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.models.weights import from_flax
from theatergen_tpu_torch.ops import flash_attention as tfa
from theatergen_tpu_torch.ops import geglu_matmul as tgg
from theatergen_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

# objects per image (the tiny pipeline's max_objects)
N_OBJ = 3


def random_params(module, seed, *args, **kwargs):
    """The module's flax tree with seeded numpy leaves: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1²), all else (the scalar
    gates included) N(0, 0.1²)."""
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
        return np.asarray(0.1 * rng.randn(*s.shape), np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _load(module, kind, tree):
    module.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                            for k, v in from_flax(kind, tree).items()},
                           strict=True)
    return module.eval()


def torch_fourier(boxes, num_freqs=8):
    """GLIGEN's ``get_fourier_embeds_from_boundingbox`` (diffusers), the
    layout a checkpoint's ``linears.0`` rows follow."""
    emb = 100 ** (torch.arange(num_freqs) / num_freqs)
    emb = emb[None, None, None] * boxes.unsqueeze(-1)
    emb = torch.stack((emb.sin(), emb.cos()), dim=-1)
    return emb.permute(0, 1, 3, 4, 2).reshape(
        boxes.shape[0], boxes.shape[1], num_freqs * 2 * 4)


# ----------------------------------------------------------------- PositionNet

def _position_inputs(seed, b=2, n=N_OBJ, text_dim=16):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0.0, 0.5, (b, n, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.5, (b, n, 2))],
                           -1).astype(np.float32)
    masks = np.ones((b, n), np.float32)
    masks[0, -1] = 0.0                          # one padding slot
    return boxes, masks, rng.randn(b, n, text_dim).astype(np.float32)


@pytest.fixture(scope="module")
def position_nets():
    jnet = JPositionNet(out_dim=32, text_dim=16)
    params = random_params(jnet, 0, *map(jnp.asarray, _position_inputs(0)))
    return jnet, params, _load(PositionNet(32, text_dim=16), "position_net",
                               params)


def test_position_net_matches_jax(position_nets):
    """objs of two images, one slot masked, against the JAX module on the
    same tree; fp32, three 512-wide linears: bound 1e-5."""
    jnet, params, net = position_nets
    inputs = _position_inputs(1)
    ref = np.asarray(jnet.apply({"params": params}, *map(jnp.asarray,
                                                         inputs)))
    with torch.no_grad():
        got = net(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == (2, N_OBJ, 32)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert set(from_flax("position_net", params)) == set(net.state_dict())
    assert {"linears.0.weight", "linears.2.weight", "linears.4.weight",
            "null_positive_feature", "null_position_feature"} <= set(
        net.state_dict())


def test_position_net_fourier_order():
    """The boxes' Fourier features are GLIGEN's ``(freq, sin|cos, coord)``
    layout (JAX ``test_gdino.py::test_position_net_fourier_ordering``):
    the module's own and, through ``linears.0`` made a selector of the
    position slice, what the first linear reads."""
    boxes = torch.tensor([[[0.1, 0.2, 0.7, 0.9], [0.3, 0.0, 1.0, 0.5]]])
    ref = torch_fourier(boxes)
    net = PositionNet(out_dim=8, text_dim=4)
    torch.testing.assert_close(net.fourier(boxes), ref, atol=1e-6, rtol=0)
    seen = []
    net.linears[0].register_forward_hook(lambda m, a, o: seen.append(o))
    with torch.no_grad():
        net.linears[0].weight.zero_()
        net.linears[0].weight[:64, 4:].copy_(torch.eye(64))
        net.linears[0].bias.zero_()
        net(boxes, torch.ones(1, 2), torch.zeros(1, 2, 4))
    torch.testing.assert_close(seen[0][..., :64], ref, atol=1e-6, rtol=0)


def test_position_net_null_padding(position_nets):
    """A masked slot maps to the null features: its output does not depend
    on its (junk) box or phrase, the real slots do not move, and it
    differs from a real slot's (JAX ``test_models.py::
    test_position_net_null_padding``)."""
    _, _, net = position_nets
    boxes, masks, phr = map(torch.from_numpy, _position_inputs(2))
    boxes2, phr2 = boxes.clone(), phr.clone()
    boxes2[0, -1] = torch.tensor([0.0, 0.0, 1.0, 1.0])
    phr2[0, -1] = 0.0
    with torch.no_grad():
        out, out2 = net(boxes, masks, phr), net(boxes2, masks, phr2)
        nulls = net.linears(torch.cat([net.null_positive_feature,
                                       net.null_position_feature]))
    assert torch.equal(out[0, -1], out2[0, -1])
    assert torch.equal(out[:, :-1], out2[:, :-1])
    torch.testing.assert_close(out[0, -1], nulls, atol=1e-6, rtol=0)
    assert not torch.allclose(out[0, 0], out[0, -1])


# ----------------------------------------------------------------- the fuser

def test_gated_self_attention_matches_jax():
    """The fuser with non-zero gates (tanh(α) ≈ 0.60 and -0.38) against
    the JAX module on the same tree, 16 visual tokens, 3 objs, 2 heads;
    fp32: bound 1e-5."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 32).astype(np.float32)
    objs = rng.randn(2, N_OBJ, 24).astype(np.float32)
    jf = JFuser(num_heads=2, head_dim=16)
    params = random_params(jf, 4, jnp.asarray(x), jnp.asarray(objs))
    params = dict(params, alpha_attn=np.float32(0.7),
                  alpha_dense=np.float32(-0.4))
    ref = np.asarray(jax.jit(jf.apply)({"params": params}, jnp.asarray(x),
                                       jnp.asarray(objs)))
    fuser = _load(tl.GatedSelfAttention(32, 2, 16, 24), "unet", params)
    with torch.no_grad():
        got = fuser(torch.from_numpy(x), torch.from_numpy(objs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert fuser.norm1.eps == fuser.norm2.eps == 1e-6
    assert not fuser.attn.use_flash and not fuser.ff.fused_ff
    assert np.abs(got - x).max() > 0.1


# ----------------------------------------------------------------- the UNet

def _cond(ucfg, batch, seed):
    """SDXL's pooled text and time ids (numpy) where the config has
    text_time conditioning, else none."""
    if ucfg.addition_embed_type != "text_time":
        return {}
    rng = np.random.RandomState(seed)
    pooled = (ucfg.projection_class_embeddings_input_dim
              - 6 * ucfg.addition_time_embed_dim)
    return dict(pooled_text=rng.randn(batch, pooled).astype(np.float32),
                time_ids=rng.uniform(0, 64, (batch, 6)).astype(np.float32))


def _jax_gligen_params(jc, seed):
    ucfg = jc.unet
    d = ucfg.cross_attention_dim
    cond = {k: jnp.asarray(v[:1]) for k, v in _cond(ucfg, 1, 0).items()}
    return random_params(JUNet(ucfg), seed, jnp.zeros((1, 8, 8, 4)),
                         jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, d)),
                         objs=jnp.zeros((1, N_OBJ, d)), **cond)


@pytest.fixture(scope="module", params=["tiny_config", "tiny_xl_config"])
def gligen_unets(request):
    """The JAX GLIGEN UNet and its tree (gates non-zero), the port's
    GLIGEN UNet loaded with it, and one CFG-batch input with objs."""
    jc, tc = (getattr(jcfg, request.param)(), getattr(tcfg, request.param)())
    params = _jax_gligen_params(jc, 0)
    unet = _load(TUNet(tc.unet, gligen=True), "unet", params)
    d = tc.unet.cross_attention_dim
    rng = np.random.RandomState(5)
    inputs = dict(x=rng.randn(2, 8, 8, 4).astype(np.float32),
                  t=np.array([999, 500], np.int32),
                  ctx=rng.randn(2, 16, d).astype(np.float32),
                  objs=rng.randn(2, N_OBJ, d).astype(np.float32),
                  cond=_cond(tc.unet, 2, 6))
    return dict(name=request.param, jax=(JUNet(jc.unet), params),
                port=unet, cfg=tc, inputs=inputs)


def _port_eps(unet, inp, objs=True, **kw):
    extra = {k: torch.from_numpy(v) for k, v in inp["cond"].items()}
    if objs:
        extra["objs"] = torch.from_numpy(inp["objs"])
    with torch.no_grad():
        return unet(torch.from_numpy(inp["x"]).permute(0, 3, 1, 2),
                    torch.from_numpy(inp["t"]), torch.from_numpy(inp["ctx"]),
                    **extra, **kw)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_gligen_unet_matches_jax_full_and_shallow(gligen_unets):
    """eps of the GLIGEN UNet with objs (every fuser's gates non-zero)
    against the JAX UNet on the same tree: the full forward with its
    DeepCache cache, then the shallow forward from that cache.  fp32
    through ~40 layers: bound 5e-5, as the plain UNet's parity test; the
    objs move eps well past it."""
    g = gligen_unets
    inp = g["inputs"]
    unet, params = g["jax"]
    extra = {k: jnp.asarray(v) for k, v in inp["cond"].items()}
    args = (jnp.asarray(inp["x"]), jnp.asarray(inp["t"]),
            jnp.asarray(inp["ctx"]))
    @jax.jit
    def full_and_shallow(p, objs):
        eps, cache = unet.apply({"params": p}, *args, objs=objs,
                                return_deep_cache=True, **extra)
        return eps, cache, unet.apply({"params": p}, *args, objs=objs,
                                      deep_cache=cache, **extra)

    ref, cache, ref_shallow = full_and_shallow(params,
                                               jnp.asarray(inp["objs"]))
    got, got_cache = _port_eps(g["port"], inp, return_deep_cache=True)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), atol=5e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_nhwc(got_cache), np.asarray(cache),
                               atol=5e-5, rtol=1e-5)
    got_shallow = _port_eps(g["port"], inp, deep_cache=got_cache)
    np.testing.assert_allclose(_nhwc(got_shallow), np.asarray(ref_shallow),
                               atol=5e-5, rtol=1e-5)
    plain = _port_eps(g["port"], inp, objs=False)
    assert np.abs(_nhwc(plain) - np.asarray(ref)).max() > 1e-2


def test_zero_gates_are_the_plain_unet(gligen_unets):
    """With every gate at zero the GLIGEN UNet with objs equals, bit for
    bit, itself without objs and a UNet built without fusers on the same
    other weights, in the full and the shallow forward (JAX
    ``test_models.py::test_gligen_fuser_identity_at_init``); the fusers
    sit in every transformer block."""
    g = gligen_unets
    inp = g["inputs"]
    unet = g["port"]
    sd = unet.state_dict()
    zeroed = {k: (torch.zeros_like(v) if k.endswith((".alpha_attn",
                                                      ".alpha_dense")) else v)
              for k, v in sd.items()}
    gl = TUNet(g["cfg"].unet, gligen=True).eval()
    gl.load_state_dict(zeroed)
    plain = TUNet(g["cfg"].unet).eval()
    plain.load_state_dict({k: v for k, v in sd.items() if ".fuser." not in k})
    blocks = [m for m in gl.modules() if isinstance(m,
                                                    tl.BasicTransformerBlock)]
    assert blocks and all(isinstance(b.fuser, tl.GatedSelfAttention)
                          for b in blocks)
    eps, cache = _port_eps(gl, inp, return_deep_cache=True)
    for other in (_port_eps(gl, inp, objs=False, return_deep_cache=True),
                  _port_eps(plain, inp, objs=False, return_deep_cache=True)):
        assert torch.equal(eps, other[0]) and torch.equal(cache, other[1])
    shallow = _port_eps(gl, inp, deep_cache=cache)
    assert torch.equal(shallow, _port_eps(plain, inp, objs=False,
                                          deep_cache=cache))


def test_seeded_gligen_unet_starts_at_zero_gates():
    """A GLIGEN UNet drawn by the bundle's seeded init (``build_module``)
    has every gate at zero, as flax's zeros init, and every other fuser
    weight drawn."""
    from theatergen_tpu_torch.pipelines.bundle import build_module

    gen = torch.Generator().manual_seed(0)
    unet = build_module(TUNet, tcfg.tiny_config().unet, torch.float32, "cpu",
                        gen, gligen=True)
    gates = {k: v for k, v in unet.state_dict().items()
             if k.endswith(("alpha_attn", "alpha_dense"))}
    assert len(gates) == 2 * 7 and all(v.ndim == 0 and v == 0
                                       for v in gates.values())
    fuser = unet.mid_block.attentions[0].transformer_blocks[0].fuser
    assert fuser.linear.weight.std() > 0.05


def test_objs_without_fusers_and_fuser_weights_raise(gligen_unets):
    """A UNet built without fusers refuses objs and a state dict holding
    fuser weights (strict or not), with ValueError; a GLIGEN UNet refuses
    a state dict without them (the strict load's missing keys)."""
    g = gligen_unets
    plain = TUNet(g["cfg"].unet).eval()
    with pytest.raises(ValueError, match="gligen=True"):
        _port_eps(plain, g["inputs"])
    sd = g["port"].state_dict()
    for strict in (True, False):
        with pytest.raises(ValueError, match="fuser"):
            plain.load_state_dict(sd, strict=strict)
    with pytest.raises(RuntimeError, match="Missing key"):
        TUNet(g["cfg"].unet, gligen=True).load_state_dict(
            {k: v for k, v in sd.items() if ".fuser." not in k})


def test_fuser_routes_in_bf16():
    """In bf16 the fuser's FeedForward reaches geglu_matmul where the JAX
    gate takes its shape (one call per fuser at the tiny UNet's 128-row
    level) and its attention never reaches flash: with objs, flash is
    called as often as without, and geglu_matmul once more per fuser."""
    cfg = dataclasses.replace(tcfg.tiny_config().unet, dtype="bfloat16",
                              flash_attention=True)
    unet = TUNet(cfg, gligen=True).to(torch.bfloat16).eval()
    calls = {"geglu": 0, "flash": 0}
    real_geglu, real_flash = tgg.geglu_matmul, tfa.flash_attention

    def geglu(*a, **k):
        calls["geglu"] += 1
        return real_geglu(*a, **k)

    def flash(*a, **k):
        calls["flash"] += 1
        return real_flash(*a, **k)

    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(2, 4, 8, 8).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(2, 16, 32).astype(np.float32))
    objs = torch.from_numpy(rng.randn(2, N_OBJ, 32).astype(np.float32))
    got = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgg, "geglu_matmul", geglu)
        mp.setattr(tfa, "flash_attention", flash)
        for label, o in (("plain", None), ("objs", objs)):
            calls.update(geglu=0, flash=0)
            with torch.no_grad():
                unet(x, torch.tensor([500, 500]), ctx, objs=o)
            got[label] = dict(calls)
    fusers = [m for m in unet.modules()
              if isinstance(m, tl.GatedSelfAttention)]
    n_levels = len(cfg.block_out_channels)
    want = 0
    for name, m in unet.named_modules():
        if isinstance(m, tl.Transformer2D):
            place, idx = name.split(".")[:2]
            level = (n_levels - 1 if place == "mid_block" else int(idx)
                     if place == "down_blocks" else n_levels - 1 - int(idx))
            side = 8 >> level
            c = m.proj_in.in_channels
            want += len(m.transformer_blocks) * tgg.supported(
                2 * side * side, 4 * c, c)
    assert len(fusers) == 7 and want > 0
    assert got["objs"]["flash"] == got["plain"]["flash"]
    assert got["objs"]["geglu"] == got["plain"]["geglu"] + want


def test_gligen_sharding_coverage_matches_jax():
    """The tp rules over a tiny GLIGEN UNet at tp = 2: the port shards
    what JAX shards of the same tree, the fusers' attention and FF
    included and their ``linear`` replicated, with the same counts and
    no fallback; each fuser is a unit of the port's plan."""
    jc = jcfg.tiny_config()
    params = _jax_gligen_params(jc, 0)
    jcov = jmesh.sharding_coverage(jmesh.make_mesh(dp=4, tp=2), params)
    unet = TUNet(tcfg.tiny_config().unet, gligen=True)
    tcov = tmesh.sharding_coverage(2, unet)
    assert jcov["fallback"] == [] and tcov["fallback"] == []
    assert tcov["total_params"] == jcov["total_params"]
    assert tcov["sharded_params"] == jcov["sharded_params"]
    paths = ["/".join(str(k.key) for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    fuser_j = {p for p in paths if "/fuser/" in p
               and any(s is not None for s in jmesh.param_spec(p))}
    fuser_t = {n for n in unet.state_dict()
               if ".fuser." in n and tmesh.param_spec(n)}
    assert len(fuser_j) == len(fuser_t) == 7 * 6
    assert not any(".fuser.linear." in n for n in fuser_t)
    units = {n for n, *_ in tmesh.plan(unet, 2)}
    assert sum(n.endswith(".fuser.attn") for n in units) == 7
    assert sum(n.endswith(".fuser.ff") for n in units) == 7
    specs = tmesh.shard_specs(unet, 2)
    assert specs["mid_block.attentions.0.transformer_blocks.0.fuser.attn."
                 "to_out.0.weight"] == ("row", 1)
    assert specs["mid_block.attentions.0.transformer_blocks.0.fuser.ff.net."
                 "0.proj.weight"] == ("geglu", 0)


def test_shard_module_splits_the_fusers():
    """shard_module at tp = 2 (rank 1's shard, the mesh a stand-in: no
    collective runs here) swaps each fuser's q/k/v and GEGLU projection
    for column-parallel layers holding half the rows, to_out.0 and net.2
    for row-parallel ones holding half the input columns, halves the
    attention's heads, and leaves ``linear`` and the gates whole."""
    unet = TUNet(tcfg.tiny_config().unet, gligen=True)
    mesh = types.SimpleNamespace(tp=2, tp_index=1)
    sharded = tmesh.shard_module(unet, mesh)
    f0 = unet.mid_block.attentions[0].transformer_blocks[0].fuser
    f = sharded.mid_block.attentions[0].transformer_blocks[0].fuser
    assert f.attn.heads == f0.attn.heads // 2 and f.attn.tp_mesh is mesh
    assert isinstance(f.attn.to_q, tl.ColumnParallelLinear)
    assert isinstance(f.attn.to_out[0], tl.RowParallelLinear)
    assert isinstance(f.ff.net[0].proj, tl.ColumnParallelLinear)
    assert isinstance(f.ff.net[2], tl.RowParallelLinear)
    assert f.ff.tp_mesh is mesh
    half = f0.attn.to_q.out_features // 2
    assert torch.equal(f.attn.to_q.weight, f0.attn.to_q.weight[half:])
    assert f.ff.net[2].in_features == f0.ff.net[2].in_features // 2
    assert type(f.linear) is torch.nn.Linear
    assert torch.equal(f.linear.weight, f0.linear.weight)
    assert set(sharded.state_dict()) == set(unet.state_dict())


def test_chip_smoke_gligen_rows_are_the_fusers_sites():
    """chip_smoke.py's GLIGEN constants against a meta-device forward of
    the SD1.5 GLIGEN UNet in bf16 at 512 px (CFG batch 2) with objs: its
    geglu_matmul rows are the (M, K, N) of every fuser FF with their
    counts, one per fuser (GLIGEN_FUSERS), and eval_launches with
    ``gligen`` derives exactly those launches on top of the plain UNet's."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ucfg = tcfg.sd15_config().unet
    with torch.device("meta"):
        unet = TUNet(ucfg, gligen=True).to(torch.bfloat16)
    sites = collections.Counter()
    for m in unet.modules():
        if isinstance(m, tl.GatedSelfAttention):
            m.ff.register_forward_hook(lambda mod, a, o: sites.update([(
                a[0].numel() // a[0].shape[-1], mod.net[2].in_features,
                mod.net[2].out_features)]))
    with torch.no_grad():
        unet(torch.zeros(2, 4, 64, 64, device="meta"),
             torch.zeros(2, dtype=torch.long, device="meta"),
             torch.zeros(2, 77, 768, device="meta"),
             objs=torch.zeros(2, 8, 768, device="meta"))
    rows = {shape: n for model, shape, n in cs.GEGLU_SHAPES
            if model == cs.GLIGEN}
    assert rows == dict(sites)
    assert sum(rows.values()) == cs.GLIGEN_FUSERS == 16
    assert all(tgg.supported(*shape) for shape in rows)
    plain = cs.eval_launches(ucfg, 64, 2)
    got = cs.eval_launches(ucfg, 64, 2, gligen=True)
    assert got - plain == collections.Counter(geglu_matmul=16)
