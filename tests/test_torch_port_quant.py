"""The port's W8A8 serving path against the JAX package's at
``tiny_config()``: weight quantization, the quantized sites, the weight
bridge of ``quantize_params`` trees, ``quant_matmul``'s plain version
(against the XLA reference and the Pallas kernel in interpret mode),
``QuantLinear`` on both routes, the quantized UNet, and the whole
text2img slice on a quantized bundle.

Inputs come from numpy seeds; both sides run on the CPU, the port with one
torch thread.  The int8 sums are exact on both sides, so a bound covers
only the fp32 roundings around them, and, where activations come out of
fp32 layers that sum in another order, the int8 rounding ties that such a
difference can flip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theatergen_tpu import config as jcfg
from theatergen_tpu.models.unet import UNet2DCondition as JUNet
from theatergen_tpu.models.clip import CLIPTextEncoder as JText
from theatergen_tpu.models.vae import AutoencoderKL as JVAE
from theatergen_tpu.ops import quant as JQ
from theatergen_tpu.ops import quant_matmul as JQM
from theatergen_tpu.ops import scheduler as jsched
from theatergen_tpu.pipelines import sd as jsd
from theatergen_tpu.pipelines.bundle import Bundle as JBundle
from theatergen_tpu.utils import tokenizer as jtok
from theatergen_tpu_torch import config as tcfg
from theatergen_tpu_torch.models import layers as tl
from theatergen_tpu_torch.models.unet import UNet2DCondition as TUNet
from theatergen_tpu_torch.models.weights import from_flax
from theatergen_tpu_torch.ops import geglu_matmul as tgg
from theatergen_tpu_torch.ops import quant as TQ
from theatergen_tpu_torch.ops import quant_matmul as TQM
from theatergen_tpu_torch.ops import scheduler as tsched
from theatergen_tpu_torch.pipelines import sd as tsd
from theatergen_tpu_torch.pipelines.bundle import init_bundle

from test_torch_port_models import random_params

torch.set_num_threads(1)


def _quantized(cfg, **unet):
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, quantized=True, **unet))


@pytest.fixture
def route(monkeypatch):
    """Set both packages' THEATERGEN_FUSED_INT8 route: "1" sends the JAX
    QuantDense to the Pallas kernel in interpret mode (its gate admits
    only a TPU backend) and the port's QuantLinear to quant_matmul."""

    def set_route(mode):
        monkeypatch.setattr(TQ, "FUSED_MODE", mode)
        if mode == "1":
            monkeypatch.setattr(JQ, "_use_fused_kernel", lambda: True)
            monkeypatch.setattr(JQM, "INTERPRET", True)

    return set_route


def _jax_unet_params(cfg, seed):
    unet = JUNet(cfg.unet)
    return unet, random_params(
        unet, seed, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 16 + cfg.unet.ip_num_tokens, 32)))


@pytest.mark.parametrize("shape", [(64, 32), (320, 1280), (7, 3)])
def test_quantize_weight_equals_jax(shape):
    """The port's quantizer on a [out, in] weight gives the JAX package's
    int8 weights and fp32 scales of the [in, out] kernel bit for bit (a
    zero column takes the 1e-8 floor)."""
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * 0.3
    w[:, 0] = 0.0
    q_ref, s_ref = JQ.quantize_weight(w)
    qt, st = TQ.quantize_linear_weight(torch.from_numpy(w.T.copy()))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy().T, q_ref)
    np.testing.assert_array_equal(st.numpy(), s_ref)


@pytest.mark.parametrize("ip_tokens", [0, 4])
def test_quantized_sites_match_jax(ip_tokens):
    """The QuantLinears of a quantized port UNet (the IP UNet too) are the
    kernel_q subtrees of the JAX quantize_params tree, mapped through the
    weight bridge, and the float UNet's linears that the port's patterns
    name."""
    jc = jcfg.tiny_config()
    jc = dataclasses.replace(jc, unet=dataclasses.replace(
        jc.unet, ip_num_tokens=ip_tokens))
    _, params = _jax_unet_params(jc, 0)
    qtree = JQ.quantize_params(params)
    from_jax = {k[:-len(".weight")] for k, v in from_flax("unet", qtree).items()
                if v.dtype == np.int8}
    tc = tcfg.tiny_config()
    ucfg = dataclasses.replace(tc.unet, ip_num_tokens=ip_tokens)
    with torch.device("meta"):
        q_unet = TUNet(dataclasses.replace(ucfg, quantized=True))
        f_unet = TUNet(ucfg)
    port = {n for n, m in q_unet.named_modules()
            if isinstance(m, tl.QuantLinear)}
    by_pattern = {n for n, m in f_unet.named_modules()
                  if isinstance(m, torch.nn.Linear) and TQ.is_quant_path(n)}
    assert port == from_jax == by_pattern
    assert any(n.endswith("to_k_ip") for n in port) == bool(ip_tokens)
    # no other linear is left in the UNet but add_embedding's (none here)
    assert not any(isinstance(m, torch.nn.Linear) for m in q_unet.modules())


def test_sd15_quantized_unet_has_184_quant_linears():
    """16 transformer blocks x 10, 22 time_emb_proj, 2 time_embedding."""
    with torch.device("meta"):
        unet = TUNet(_quantized(tcfg.sd15_config()).unet)
    names = [n for n, m in unet.named_modules()
             if isinstance(m, tl.QuantLinear)]
    assert len(names) == 184
    assert sum(n.endswith("time_emb_proj") for n in names) == 22
    assert sum(n.startswith("time_embedding.") for n in names) == 2


def test_load_flax_quantized_tree_equals_port_quantization():
    """load_flax(unet=quantize_params(p)) into a quantized bundle and the
    port's quantize_state_dict of load_flax(unet=p) give the same state
    dict, int8 weights and fp32 scales bit for bit; the latter loads into
    the quantized UNet with every key matched."""
    _, params = _jax_unet_params(jcfg.tiny_config(), 0)
    qb = init_bundle(_quantized(tcfg.tiny_config()), 0, device="cpu")
    qb.load_flax(unet=JQ.quantize_params(params))
    fb = init_bundle(tcfg.tiny_config(), 0, device="cpu").load_flax(
        unet=params)
    ours = TQ.quantize_state_dict(fb.unet.state_dict())
    theirs = qb.unet.state_dict()
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert v.dtype == ours[k].dtype, k
        assert torch.equal(v, ours[k]), k
    assert sum(v.dtype == torch.int8 for v in theirs.values()) == 83
    qb.unet.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("with_ip", [False, True])
def test_quantized_init_bundle_is_the_float_bundle_quantized(with_ip):
    """init_bundle(quantized cfg, s) draws every weight where the float
    init_bundle(cfg, s) does: its state dicts equal the float ones
    quantized, bit for bit, the IP UNet's to_k_ip/to_v_ip included."""
    q = init_bundle(_quantized(tcfg.tiny_config()), 3, device="cpu",
                    with_ip=with_ip)
    f = init_bundle(tcfg.tiny_config(), 3, device="cpu", with_ip=with_ip)
    for name in ("unet", "unet_ip") if with_ip else ("unet",):
        want = TQ.quantize_state_dict(getattr(f, name).state_dict())
        got = getattr(q, name).state_dict()
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
    for name in ("vae", "text"):
        for k, v in getattr(q, name).state_dict().items():
            assert torch.equal(v, getattr(f, name).state_dict()[k]), k
    if with_ip:
        assert isinstance(q.unet_ip.mid_block.attentions[0]
                          .transformer_blocks[0].attn2.to_k_ip,
                          tl.QuantLinear)


def test_scale_stays_fp32_through_dtype_casts():
    """A bf16 model casts the bias but never the fp32 scale (the JAX
    package keeps scale fp32): a cast module, and a bundle built in bf16,
    hold the exact fp32 scales."""
    lin = tl.QuantLinear(64, 16)
    w = torch.from_numpy(np.random.RandomState(1).randn(16, 64)
                         .astype(np.float32)) * 0.123
    lin.set_float_weight(w)
    ref = lin.scale.clone()
    lin = lin.to(torch.bfloat16).half().to(dtype=torch.bfloat16)
    assert lin.scale.dtype == torch.float32 and torch.equal(lin.scale, ref)
    assert lin.bias.dtype == torch.bfloat16 and lin.weight.dtype == torch.int8
    cfg = _quantized(tcfg.tiny_config(), dtype="bfloat16")
    b = init_bundle(cfg, 0, device="cpu")
    ff = b.unet.down_blocks[0].attentions[0].transformer_blocks[0].ff
    down = ff.net[2]
    assert down.scale.dtype == torch.float32
    assert down.bias.dtype == torch.bfloat16
    f = init_bundle(dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, quantized=False)), 0, device="cpu")
    fw = f.unet.down_blocks[0].attentions[0].transformer_blocks[0].ff.net[2]
    q, s = TQ.quantize_linear_weight(fw.weight)
    assert torch.equal(down.weight, q) and torch.equal(down.scale, s)


@pytest.mark.parametrize("m,k,n", [(64, 320, 256), (40, 128, 384),
                                   (128, 256, 130), (154, 768, 320),
                                   (2, 1280, 320)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quant_matmul_plain_matches_jax(monkeypatch, m, k, n, dtype):
    """quant_matmul_plain vs the JAX reference_quant_matmul and the Pallas
    quant_matmul (interpret mode), from the same inputs.  The int32 sums
    are exact on every side, so against the reference (same division, same
    rounding) what is left is the fp32 epilogue: the port takes
    acc·(s·w_scale) as the Pallas kernel does, the reference
    (acc·s)·w_scale: each is two fp32 roundings, so they lie two fp32 ulps
    apart (2⁻²² relative), and a bf16 output can round them to neighbouring
    values, one bf16 ulp apart (2⁻⁷ relative).  The interpreted Pallas
    kernel divides x/s one ulp off in places, so a quotient within an ulp
    of a .5 tie (e.g. -63.499996) rounds to the other int8 neighbour there;
    each such flip moves its row by s·|w_q|·w_scale ≤ max|x_row|·max|w|.
    Bound against it: two flips per row, plus one output step."""
    monkeypatch.setattr(JQM, "INTERPRET", True)
    rng = np.random.RandomState(m + n)
    x = rng.randn(m, k).astype(np.float32) * 0.5
    x[0] = 0.0                                  # a row at the 1e-8 floor
    w = rng.randn(k, n).astype(np.float32) * 0.05
    wq, ws = JQ.quantize_weight(w)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    ref = np.asarray(JQM.reference_quant_matmul(xj, jnp.asarray(wq),
                                                jnp.asarray(ws)), np.float32)
    pallas = np.asarray(JQM.quant_matmul(xj, jnp.asarray(wq), jnp.asarray(ws),
                                         m_block=32, n_block=128),
                        np.float32)
    xf = np.asarray(xj.astype(jnp.float32))
    got = TQM.quant_matmul(torch.from_numpy(xf).to(getattr(torch, dtype)),
                           torch.from_numpy(wq.T.copy()), torch.from_numpy(ws))
    assert got.dtype == getattr(torch, dtype) and got.shape == (m, n)
    got = got.float().numpy()
    step = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22
    np.testing.assert_allclose(got, ref, rtol=step, atol=0)
    flips = 2 * np.abs(xf).max(1, keepdims=True) * np.abs(w).max()
    assert (np.abs(got - pallas) <= flips + step * np.abs(pallas)).all()
    assert not got[0].any()


def _per_row_reference(x, wq, ws, bias, dtype):
    """The "1" route in JAX: reference_quant_matmul on fp32 ``x`` (the
    Pallas kernel's arithmetic, plain XLA), plus the fp32 bias, one
    rounding to ``dtype`` (QuantDense's fused route); and the product
    without the bias."""
    prod = JQM.reference_quant_matmul(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(wq), jnp.asarray(ws))
    y = prod if bias is None else prod + jnp.asarray(bias, jnp.float32)
    return (np.asarray(y.astype(dtype), np.float32),
            np.asarray(prod, np.float32))


def _assert_per_row_close(got, ref, prod, step):
    """The port takes acc·(s·w_scale), the reference (acc·s)·w_scale: two
    fp32 roundings each, so the products lie within 2⁻²²·|prod|; the bias
    sum rounds once more on each side, and a bf16 output can round the two
    to neighbouring values.  So |got - ref| ≤ 2⁻²²·|prod| + step·|ref|,
    step 2⁻²² in fp32 and one bf16 ulp (2⁻⁷) in bf16.  No int8 tie may
    flip: both sides divide x / s exactly."""
    bound = 2.0 ** -22 * np.abs(prod) + step * np.abs(ref)
    assert (np.abs(got - ref) <= bound).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("mode", ["0", "1"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quant_linear_matches_quant_dense(route, mode, dtype):
    """QuantLinear vs the JAX package on the same int8 weights, scales and
    bias, on a [2, 77, 320] input (a CFG batch: the per-tensor scale of
    "0" spans both halves), in each route.  The port holds its bias in the
    model dtype (bf16-valued here) and JAX in fp32, same values.  "0":
    against QuantDense, the same fp32 operations in the same order, bit for
    bit.  "1": against reference_quant_matmul plus the bias
    (_assert_per_row_close); the interpreted Pallas kernel is held in
    test_quant_matmul_plain_matches_jax."""
    route(mode)
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 77, 320) * np.linspace(0.1, 3, 320)).astype(np.float32)
    x[1] *= 4.0                                 # the cond half dominates
    w = rng.randn(320, 640).astype(np.float32) * 0.05
    wq, ws = JQ.quantize_weight(w)
    b = torch.from_numpy(rng.randn(640).astype(np.float32) * 0.1).to(
        getattr(torch, dtype)).float().numpy()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(x, jdt)
    lin = tl.QuantLinear(320, 640).to(getattr(torch, dtype))
    lin.load_state_dict({"weight": torch.from_numpy(wq.T.copy()),
                         "scale": torch.from_numpy(ws),
                         "bias": torch.from_numpy(b)})
    xf = np.asarray(xj.astype(jnp.float32))
    with torch.no_grad():
        got = lin(torch.from_numpy(xf).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if mode == "0":
        ref = np.asarray(JQ.QuantDense(640, dtype=jdt).apply(
            {"params": {"kernel_q": jnp.asarray(wq),
                        "scale": jnp.asarray(ws), "bias": jnp.asarray(b)}},
            xj), np.float32)
        np.testing.assert_array_equal(got, ref)
        return
    ref, prod = _per_row_reference(xf, wq, ws, b, jdt)
    step = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -22
    _assert_per_row_close(got, ref, prod, step)


def test_per_tensor_int8_product_is_exact():
    """The "0" route's int8 product equals the float64 product of the same
    int8 values exactly, at M below and above the card's 16-row limit."""
    rng = np.random.RandomState(6)
    w = torch.from_numpy(rng.randint(-127, 128, (320, 1280)).astype(np.int8))
    for m in (2, 154):
        xq = torch.from_numpy(rng.randint(-127, 128, (m, 1280))
                              .astype(np.int8))
        got = TQ.int8_matmul(xq, w)
        assert got.dtype == torch.int32 and got.shape == (m, 320)
        want = xq.double() @ w.double().t()
        assert torch.equal(got.double(), want)


@pytest.fixture(scope="module")
def tiny_w8a8():
    """The JAX float and quantized tiny UNets on one seeded tree
    (quantize_params), the port's bundles loaded with the same trees, and
    one CFG-batch input."""
    jc = jcfg.tiny_config()
    unet_f, params = _jax_unet_params(jc, 0)
    qparams = JQ.quantize_params(params)
    port_q = init_bundle(_quantized(tcfg.tiny_config()), 0, device="cpu")
    port_f = init_bundle(tcfg.tiny_config(), 0, device="cpu")
    rng = np.random.RandomState(11)
    inputs = (rng.randn(2, 8, 8, 4).astype(np.float32),
              np.array([999, 500], np.int32),
              rng.randn(2, 16, 32).astype(np.float32))
    return dict(jax_f=(unet_f, params),
                jax_q=(JUNet(_quantized(jc).unet), qparams),
                port_q=port_q.load_flax(unet=qparams).unet,
                port_f=port_f.load_flax(unet=params).unet, inputs=inputs)


def _port_eps(unet, x, t, ctx):
    with torch.no_grad():
        out = unet(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(t), torch.from_numpy(ctx))
    return out.permute(0, 2, 3, 1).numpy()


def _jax_eps(model, x, t, ctx):
    unet, params = model
    return np.asarray(jax.jit(unet.apply)(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))


@pytest.mark.parametrize("mode", ["0", "1"])
def test_quantized_unet_sites_match_quant_dense(route, tiny_w8a8, mode):
    """Every QuantLinear of one quantized UNet evaluation against the JAX
    package on the same weights and the same input (the activation it met
    in the port's evaluation), all 83 sites.  "0": against QuantDense, the
    same fp32 operations in the same order, bit for bit.  "1": against
    reference_quant_matmul plus the bias, within the epilogue's fp32
    roundings (_assert_per_row_close)."""
    route(mode)
    seen = []

    def hook(name):
        def record(mod, args, out):
            seen.append((name, mod, args[0].detach().numpy(),
                         out.detach().numpy()))
        return record

    unet = tiny_w8a8["port_q"]
    handles = [m.register_forward_hook(hook(n)) for n, m in
               unet.named_modules() if isinstance(m, tl.QuantLinear)]
    try:
        _port_eps(unet, *tiny_w8a8["inputs"])
    finally:
        for h in handles:
            h.remove()
    assert len({n for n, *_ in seen}) == 83
    for name, mod, x, got in seen:
        wq, ws = mod.weight.numpy().T, mod.scale.numpy()
        bias = None if mod.bias is None else mod.bias.detach().numpy()
        if mode == "1":
            ref, prod = _per_row_reference(x, wq, ws, bias, jnp.float32)
            _assert_per_row_close(got, ref, prod, 2.0 ** -22)
            continue
        p = {"kernel_q": jnp.asarray(wq), "scale": jnp.asarray(ws)}
        if bias is not None:
            p["bias"] = jnp.asarray(bias)
        ref = np.asarray(JQ.QuantDense(
            mod.out_features, use_bias=bias is not None,
            dtype=jnp.float32).apply({"params": p}, jnp.asarray(x)))
        np.testing.assert_array_equal(got, ref, err_msg=name)


@pytest.mark.parametrize("mode", ["0", "1"])
def test_quantized_unet_matches_jax(route, tiny_w8a8, mode):
    """One quantized UNet evaluation (CFG batch 2, two timesteps) against
    the JAX quantized UNet on the same quantize_params tree.  The fp32
    layers between the quantized sites sum in another order on the two
    sides (5e-5 on the float UNet, test_torch_port_models.py); where that
    moves an activation across an int8 rounding tie, the layer's output
    moves by a whole quantization step, and every later site rounds a
    differently perturbed input.  So end to end the two evaluations are two
    draws of the quantization error, and the bound is its own size: each
    side's quantized-vs-float difference is at least 1e-2·max|ref|, the
    port's is within a factor 1.5 of the JAX package's, and port and JAX
    differ by at most 1.5 times the JAX package's.  (The sites themselves
    are held exactly by the test above.)"""
    route(mode)
    inputs = tiny_w8a8["inputs"]
    ref = _jax_eps(tiny_w8a8["jax_q"], *inputs)
    ref_f = _jax_eps(tiny_w8a8["jax_f"], *inputs)
    got = _port_eps(tiny_w8a8["port_q"], *inputs)
    got_f = _port_eps(tiny_w8a8["port_f"], *inputs)
    np.testing.assert_allclose(got_f, ref_f, atol=5e-5, rtol=1e-5)
    jax_err = np.abs(ref - ref_f).max()
    port_err = np.abs(got - got_f).max()
    assert jax_err >= 1e-2 * np.abs(ref).max()
    assert jax_err / 1.5 <= port_err <= 1.5 * jax_err
    assert np.abs(got - ref).max() <= 1.5 * jax_err


def test_plain_path_sends_quant_linear_to_the_plain_version(monkeypatch):
    """At "1" a QuantLinear calls the quant_matmul wrapper, and inside
    plain_path() its plain version; at "0" it calls neither."""
    calls = []
    monkeypatch.setattr(TQM, "quant_matmul",
                        lambda *a: calls.append("kernel") or
                        TQM.quant_matmul_plain(*a))
    real_plain = TQM.quant_matmul_plain
    monkeypatch.setattr(TQM, "quant_matmul_plain",
                        lambda *a: calls.append("plain") or real_plain(*a))
    lin = tl.QuantLinear(64, 32)
    x = torch.randn(4, 64)
    monkeypatch.setattr(TQ, "FUSED_MODE", "1")
    lin(x)
    with tl.plain_path():
        lin(x)
    assert tl._use_kernels and calls == ["kernel", "plain", "plain"]
    monkeypatch.setattr(TQ, "FUSED_MODE", "0")
    calls.clear()
    lin(x)
    with tl.plain_path():
        lin(x)
    assert calls == []


def test_quantized_feed_forward_never_fused(monkeypatch, route):
    """A quantized bf16 FF never reaches ff_matmul or geglu_matmul, with
    fused_ff on or off: it is net.2(GEGLU(x)) of two QuantLinears."""
    route("1")

    def boom(*a, **k):
        raise AssertionError("a quantized FF took a fused GEGLU route")

    monkeypatch.setattr(tgg, "ff_matmul", boom)
    monkeypatch.setattr(tgg, "geglu_matmul", boom)
    x = torch.randn(1, 16, 32).to(torch.bfloat16)
    for fused in (True, False):
        ff = tl.FeedForward(32, fused_ff=fused, quantized=True).to(
            torch.bfloat16)
        assert isinstance(ff.net[0].proj, tl.QuantLinear)
        want = ff.net[2](ff.net[0](x))
        assert torch.equal(ff(x), want)


@pytest.mark.parametrize("mode", ["0", "1"])
def test_w8a8_text2img_slice_matches(route, mode):
    """encode_prompts → denoise (3 steps, CFG 7.5, the same initial
    latents) → decode_with on a quantized tiny bundle against the JAX loop
    on the quantize_params tree, fp32, with the float slice of the same
    trees beside it.  The float slices agree as in
    test_torch_port_text2img.py (latents 2e-4, image 5e-5).  A quantized
    step carries the int8 tie flips of test_quantized_unet_matches_jax, so
    the quantized slices are held to the quantization error's own size, as
    the UNet is there: along the trajectory and in the image, the port's
    quantized-vs-float difference is within a factor 1.5 of the JAX
    package's, and port and JAX differ by at most 1.5 times the JAX
    package's."""
    route(mode)
    cfg = jcfg.tiny_config()
    vae, text = JVAE(cfg.vae), JText(cfg.text)
    unet_f, up = _jax_unet_params(cfg, 0)
    unet_q, qp = JUNet(_quantized(cfg).unet), JQ.quantize_params(up)
    vp = random_params(vae, 1, jnp.zeros((1, 16, 16, 3)))
    tp = random_params(text, 2, jnp.zeros((1, 16), jnp.int32))
    jb = JBundle(cfg=cfg, tokenizer=jtok.HashTokenizer(1024), unet=unet_q,
                 unet_params=qp, vae=vae, vae_params=vp, text=text,
                 text_params=tp)
    lat = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    prompts = ["a red knight rides through a dark forest", "two cats"]
    ctx_j = jsd.encode_prompts(jb, prompts)
    sched_j = jsched.make_schedule(cfg.scheduler, 3)

    def run_j(unet, params):
        def unet_apply(x, t, ctx):
            return unet.apply({"params": params}, x,
                              jnp.broadcast_to(t[None], (x.shape[0],)), ctx)

        @jax.jit
        def run(lat, ctx):
            final, traj = jsd.denoise(unet_apply, sched_j, lat, ctx, 7.5,
                                      collect_trajectory=True)
            return traj, jsd.decode_with(vae, vp, cfg.vae.scaling_factor,
                                         final)

        return [np.asarray(a) for a in run(jnp.asarray(lat), ctx_j)]

    def run_t(quantized, unet_params):
        c = _quantized(tcfg.tiny_config()) if quantized else tcfg.tiny_config()
        tb = init_bundle(c, 0, device="cpu").load_flax(
            unet=unet_params, vae=vp, text=tp)
        final, traj = tsd.denoise(tb.unet, tsched.make_schedule(
            tb.cfg.scheduler, 3), torch.from_numpy(lat),
            tsd.encode_prompts(tb, prompts), 7.5, collect_trajectory=True)
        img = tsd.decode_with(tb.vae, tb.cfg.vae.scaling_factor, final)
        assert traj.shape == (4, 2, 8, 8, 4)
        np.testing.assert_array_equal(traj[0].numpy(), lat)
        assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
        return traj.numpy(), img.numpy()

    (tq, iq), (tf, if_) = run_j(unet_q, qp), run_j(unet_f, up)
    (pq, piq), (pf, pif) = run_t(True, qp), run_t(False, up)
    np.testing.assert_allclose(pf, tf, atol=2e-4)
    np.testing.assert_allclose(pif, if_, atol=5e-5)
    for port_q, port_f, jax_q, jax_f in ((pq, pf, tq, tf),
                                         (piq, pif, iq, if_)):
        jax_err = np.abs(jax_q - jax_f).max()
        port_err = np.abs(port_q - port_f).max()
        assert jax_err / 1.5 <= port_err <= 1.5 * jax_err
        assert np.abs(port_q - jax_q).max() <= 1.5 * jax_err


def test_w8a8_text2img_runs_end_to_end(route):
    """The entry point a user calls on a quantized bundle, in each route:
    seeded, deterministic, [B, H, W, 3] in [0, 1]."""
    b = init_bundle(_quantized(tcfg.tiny_config()), 0, device="cpu")
    pipe = tsd.Text2Img(b, num_steps=3)
    for mode in ("0", "1"):
        route(mode)
        a = pipe(torch.Generator().manual_seed(5), "a knight")
        c = pipe(torch.Generator().manual_seed(5), "a knight")
        assert a.shape == (1, 16, 16, 3)
        assert torch.isfinite(a).all() and 0.0 <= a.min() and a.max() <= 1.0
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_bridge_maps_a_quantized_tree():
    """kernel_q [in, out] → weight [out, in] (int8), scale → scale; a
    GroupNorm's scale still maps to weight."""
    _, params = _jax_unet_params(jcfg.tiny_config(), 0)
    sd = from_flax("unet", JQ.quantize_params(params))
    blk = "down_blocks.0.attentions.0.transformer_blocks.0"
    q = params["encoder"]["down_blocks_0_attentions_0"][
        "transformer_blocks_0"]
    qq = JQ.quantize_params(params)["encoder"]["down_blocks_0_attentions_0"][
        "transformer_blocks_0"]
    np.testing.assert_array_equal(sd[f"{blk}.ff.net.2.weight"],
                                  np.asarray(qq["ff"]["net_2"]["kernel_q"]).T)
    np.testing.assert_array_equal(sd[f"{blk}.ff.net.2.scale"],
                                  np.asarray(qq["ff"]["net_2"]["scale"]))
    np.testing.assert_array_equal(sd[f"{blk}.ff.net.2.bias"],
                                  np.asarray(q["ff"]["net_2"]["bias"]))
    assert sd[f"{blk}.attn1.to_q.weight"].dtype == np.int8
    assert f"{blk}.attn1.to_q.bias" not in sd
    assert sd["conv_norm_out.weight"].dtype == np.float32
    assert "conv_norm_out.scale" not in sd
