"""The yardstick's arithmetic against hand counts."""

import types

import pytest

import harness_tiny  # noqa: F401  (puts the benchmark on the path)

from harness import roofline as R


@pytest.mark.parametrize("q,k,flops,nbytes", [
    # SD1.5 level 0 at batch 2: 4·2·8·4096·4096·40, 2·2·8·40·8192·2
    ((2, 4096, 8, 40), (2, 4096, 8, 40), 42949672960.0, 20971520.0),
    # SDXL level 2: 4·2·20·1024·1024·64, 2·2·20·64·2048·2
    ((2, 1024, 20, 64), (2, 1024, 20, 64), 10737418240.0, 20971520.0),
])
def test_flash(q, k, flops, nbytes):
    assert R.flash_cost(q, k) == (flops, nbytes)


@pytest.mark.parametrize("x,w2,flops,nbytes", [
    # M 8192 D 320 K 1280: 6·M·D·K; 2·(2·M·D + 3·D·K + 2·K)
    ((2, 4096, 320), (320, 1280), 20132659200.0, 12948480.0),
    ((24, 1024, 640), (640, 2560), 241591910400.0, 72755200.0),
])
def test_ff(x, w2, flops, nbytes):
    assert R.ff_cost(x, w2) == (flops, nbytes)


@pytest.mark.parametrize("hg,w,flops,nbytes", [
    # M 2048 K 5120 N 1280: 2·M·K·N; 2·(2·M·K + N·K + M·N)
    ((2, 1024, 10240), (1280, 5120), 26843545600.0, 60293120.0),
    ((8192, 5120), (640, 2560), 26843545600.0, 97648640.0),
])
def test_geglu(hg, w, flops, nbytes):
    assert R.geglu_cost(hg, w) == (flops, nbytes)


@pytest.mark.parametrize("x,nbytes", [
    ((2, 1280, 8, 8), 655360.0), ((24, 320, 64, 64), 125829120.0)])
def test_group_norm(x, nbytes):
    assert R.group_norm_cost(x) == (0.0, nbytes)


def test_bound_takes_the_larger_time():
    assert R.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert R.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert R.bound_s(989e9, 3.35e12) == pytest.approx(1.0)
    assert R.bound_s(989e12, 3.35e9) == pytest.approx(1.0)


def test_kernel_patterns():
    names = {"flash_attention": "void flash_fwd_kernel<40, 128>(CUtensorMap)",
             "ff_geglu": "void ff_geglu_kernel<2>(CUtensorMap)",
             "geglu_matmul": "geglu_matmul_kernel(CUtensorMap, int)",
             "group_norm": "group_norm_kernel(bf16 const*, int)"}
    for k, name in names.items():
        assert [n for n, kk in R.KERNELS.items()
                if kk.pattern.search(name)] == [k]


def test_roofline_share():
    run = types.SimpleNamespace(trace=dict(
        kernel_calls={"group_norm": 3, "flash_attention": 0},
        kernel_bound_s={"group_norm": 0.5, "flash_attention": 0.0},
        kernel_device_s={"group_norm": 2.0}))
    assert R.roofline_share(run, "group_norm") == 25.0
    assert R.roofline_share(run, "flash_attention") is None
    assert R.roofline_share(run, "ff_geglu") is None
    assert R.roofline_share(types.SimpleNamespace(trace=None),
                            "group_norm") is None
