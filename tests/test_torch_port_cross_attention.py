"""The denoisers' cross-attention route (``ops/attention.py``:
``cross_routes``, ``cross_attention``, ``CrossAttentionFn``,
``cross_plan``) on the CPU.

The kernel of ``csrc/cross_attention.cu`` runs only on the card (its tests
are in ``test_torch_port_cuda.py``); here the route's gate is held case by
case, a routed call on CPU tensors is the plain version bit for bit (its
wrapper runs ``cross_attention_plain``, which is ``multi_head_attention``
or ``decoupled_attention``), the autograd Function's backward is the plain
version's gradient, and nothing launches.
"""

import dataclasses

import pytest
import torch

from theatergen_tpu_torch.config import tiny_config
from theatergen_tpu_torch.models import layers
from theatergen_tpu_torch.models.unet import UNet2DCondition
from theatergen_tpu_torch.ops import attention as attn_ops

torch.set_num_threads(1)

B, SQ, H = 2, 24, 2


def _qkv(d=40, sk=77, si=4, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g).to(dtype)

    q, k, v = r(B, SQ, H, d), r(B, sk, H, d), r(B, sk, H, d)
    k_ip, v_ip = (r(B, si, H, d), r(B, si, H, d)) if si else (None, None)
    return q, k, v, k_ip, v_ip


# (case, change to the base call, routes)
GATE = [
    ("base", {}, True),
    ("no_ip", dict(si=0), True),
    ("fp32", dict(dtype=torch.float32), False),
    ("return_probs", dict(return_probs=True), False),
    ("fp16", dict(dtype=torch.float16), False),
    ("sk_128", dict(sk=128), True),
    ("sk_129", dict(sk=129), False),
    ("sip_16", dict(si=16), True),
    ("sip_17", dict(si=17), False),
    ("d_32", dict(d=32), False),
    ("d_64", dict(d=64), True),
    ("d_80", dict(d=80), True),
    ("d_160", dict(d=160), True),
    ("scale_requires_grad", dict(scale_grad=True), False),
]


@pytest.mark.parametrize("case,change,routes", GATE,
                         ids=[c[0] for c in GATE])
def test_cross_route_gate(case, change, routes):
    """cross_routes takes bf16 calls that ask for no probabilities,
    up to 128 text and 16 IP keys, at d 40/64/80/160, whose IP scale
    records no gradient; every other call keeps the plain route."""
    kw = dict(change)
    return_probs = kw.pop("return_probs", False)
    scale_grad = kw.pop("scale_grad", False)
    q, k, _, k_ip, _ = _qkv(**kw)
    scale = torch.tensor(0.4, requires_grad=True) if scale_grad else 0.4
    assert attn_ops.cross_routes(q, k, k_ip, scale,
                                 return_probs=return_probs) is routes


def _module(ip_tokens=4, dtype=torch.bfloat16, seed=1):
    torch.manual_seed(seed)
    m = layers.CrossAttention(80, H, 40, context_dim=48, ip_tokens=ip_tokens)
    return m.to(dtype)


def _reference(m, x, ctx, ip_scale):
    """The module's call spelled out on the plain functions."""
    b, lq, _ = x.shape
    shape = (b, -1, m.heads, m.head_dim)
    q = m.to_q(x).view(shape)
    if m.ip_tokens:
        n = ctx.shape[1] - m.ip_tokens
        out = attn_ops.decoupled_attention(
            q, m.to_k(ctx[:, :n]).view(shape), m.to_v(ctx[:, :n]).view(shape),
            m.to_k_ip(ctx[:, n:]).view(shape),
            m.to_v_ip(ctx[:, n:]).view(shape), ip_scale)
    else:
        out = attn_ops.multi_head_attention(
            q, m.to_k(ctx).view(shape), m.to_v(ctx).view(shape))
    return m.to_out[0](out.reshape(b, lq, -1))


SCALES = {"float": lambda: 0.4, "zero_dim": lambda: torch.tensor(0.4),
          "per_row": lambda: torch.tensor([0.4, 0.0])}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("scale", sorted(SCALES))
def test_cpu_module_is_the_plain_version(monkeypatch, dtype, scale):
    """On the CPU a CrossAttention call with a context equals the plain
    functions' bit for bit, for a float, a 0-dim and a [B] IP scale; in
    bf16 it takes the route (its wrapper runs the plain version), in fp32
    it does not, and neither launches."""
    calls = []
    real = attn_ops.cross_attention

    def spy(*a, **k):
        calls.append(a[0].dtype)
        return real(*a, **k)

    monkeypatch.setattr(attn_ops, "cross_attention", spy)
    monkeypatch.setattr(attn_ops, "launches_cross", 0)
    m = _module(dtype=dtype)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(B, SQ, 80, generator=g).to(dtype)
    ctx = torch.randn(B, 77 + 4, 48, generator=g).to(dtype)
    s = SCALES[scale]()
    with torch.no_grad():
        got = m(x, ctx, ip_scale=s)
        want = _reference(m, x, ctx, s)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert calls == ([dtype] if dtype == torch.bfloat16 else [])
    assert attn_ops.launches_cross == 0


def test_cpu_text_only_module_is_the_plain_version(monkeypatch):
    """Without IP tokens the routed call is multi_head_attention's."""
    monkeypatch.setattr(attn_ops, "launches_cross", 0)
    m = _module(ip_tokens=0)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, SQ, 80, generator=g).to(torch.bfloat16)
    ctx = torch.randn(B, 77, 48, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        assert torch.equal(m(x, ctx), _reference(m, x, ctx, None))
    assert attn_ops.launches_cross == 0


def test_context_free_calls_never_route(monkeypatch):
    """Self-attention (no context) never reaches cross_attention, in bf16
    and under return_probs; the captured layers' return_probs calls with
    a context stay on decoupled_attention."""
    def refuse(*a, **k):
        raise AssertionError("cross_attention took a call it must not")

    monkeypatch.setattr(attn_ops, "cross_attention", refuse)
    m = _module()
    selfattn = layers.CrossAttention(80, H, 40).to(torch.bfloat16)
    x = torch.randn(B, SQ, 80).to(torch.bfloat16)
    ctx = torch.randn(B, 81, 48).to(torch.bfloat16)
    with torch.no_grad():
        selfattn(x)
        selfattn(x, return_probs=True)
        out, probs = m(x, ctx, ip_scale=0.4, return_probs=True)
    assert probs.shape == (B, H, SQ, 77)


def test_plain_path_keeps_the_plain_route(monkeypatch):
    """Inside plain_path() no call reaches the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("cross_attention under plain_path()")

    monkeypatch.setattr(attn_ops, "cross_attention", refuse)
    m = _module()
    x = torch.randn(B, SQ, 80).to(torch.bfloat16)
    ctx = torch.randn(B, 81, 48).to(torch.bfloat16)
    with torch.no_grad(), layers.plain_path():
        m(x, ctx, ip_scale=0.4)


@pytest.mark.parametrize("ip", [True, False], ids=["ip", "text"])
def test_function_backward_is_the_plain_gradient(monkeypatch, ip):
    """CrossAttentionFn, with the launch swapped for the plain version:
    its output and the gradients of q, k, v (and k_ip, v_ip) equal the
    plain version's autograd ones bit for bit, with a [B] scale."""
    monkeypatch.setattr(attn_ops, "_launch_cross",
                        lambda *a: attn_ops.cross_attention_plain(*a))
    q, k, v, k_ip, v_ip = _qkv(si=4 if ip else 0, dtype=torch.float32)
    scale = torch.tensor([0.4, 0.0])
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    leaves = [t.clone().requires_grad_(True)
              for t in (q, k, v, k_ip, v_ip) if t is not None]
    args = leaves + [None, None] if not ip else leaves
    out = attn_ops.CrossAttentionFn.apply(*args, scale)
    got = torch.autograd.grad(out, leaves, g)
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref_args = ref_leaves + [None, None] if not ip else ref_leaves
    ref = attn_ops.cross_attention_plain(*ref_args, scale)
    want = torch.autograd.grad(ref, ref_leaves, g)
    assert torch.equal(out, ref)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bf16_unet_routes_and_launches_nothing_on_cpu(monkeypatch):
    """A bf16 UNet at head dims 40 and 80 with IP tokens: each of its 7
    cross-attention calls takes the route, its output equals the same
    UNet's with the route refused bit for bit, and launches_cross stays
    0."""
    calls = []
    real = attn_ops.cross_attention

    def spy(*a, **k):
        calls.append(tuple(a[0].shape))
        return real(*a, **k)

    monkeypatch.setattr(attn_ops, "cross_attention", spy)
    monkeypatch.setattr(attn_ops, "launches_cross", 0)
    ucfg = dataclasses.replace(tiny_config().unet,
                               block_out_channels=(80, 160, 160),
                               ip_num_tokens=4, dtype="bfloat16")
    torch.manual_seed(0)
    unet = UNet2DCondition(ucfg).to(torch.bfloat16)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 4, 8, 8, generator=g).to(torch.bfloat16)
    t = torch.tensor([10, 10])
    ctx = torch.randn(2, 16 + 4, 32, generator=g).to(torch.bfloat16)
    with torch.no_grad():
        got = unet(x, t, ctx, ip_scale=torch.tensor([0.4, 0.0]))
        monkeypatch.setattr(attn_ops, "cross_routes", lambda *a, **k: False)
        want = unet(x, t, ctx, ip_scale=torch.tensor([0.4, 0.0]))
    assert len(calls) == 7
    assert {s[-1] for s in calls} == {40, 80}
    assert torch.equal(got, want)
    assert attn_ops.launches_cross == 0


@pytest.mark.parametrize("b,sq,h,d", [
    (24, 4096, 8, 40), (24, 1024, 8, 80), (24, 256, 8, 160),
    (12, 4096, 10, 64), (12, 1024, 20, 64), (2, 4096, 8, 40),
    (1, 1024, 8, 80), (3, 100, 2, 40)])
def test_cross_plan(b, sq, h, d):
    """The plan's run of q tiles divides the head's tiles, and its CTAs
    cover every tile once."""
    p = attn_ops.cross_plan(b, sq, h, d)
    ntiles = -(-sq // 128)
    run = p["tiles_per_cta"]
    assert run >= 1 and ntiles % run == 0 and run & (run - 1) == 0
    assert p["ctas"] * run == b * h * ntiles
