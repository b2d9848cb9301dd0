"""Rules of the PyTorch port that hold whatever the numbers: it imports
neither JAX nor the JAX package (nor transformers or safetensors, which the
card's machine lacks), its entry points default to the card and
refuse to fall back to the CPU, and its kernels build from the repo's own
sources."""

import pathlib
import subprocess
import sys

import pytest
import torch

from theatergen_tpu_torch import _build
from theatergen_tpu_torch.config import tiny_config
from theatergen_tpu_torch.pipelines.bundle import init_bundle

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "theatergen_tpu_torch"


def _modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        parts = p.relative_to(ROOT).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return mods


def test_port_imports_no_jax():
    """A fresh interpreter imports every module of the port (and
    chip_smoke.py's source compiles) with none of jax, theatergen_tpu,
    transformers, safetensors, optax and orbax in sys.modules."""
    code = (
        "import sys, importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"compile(open({str(ROOT / 'chip_smoke.py')!r}).read(), 'chip_smoke.py', 'exec')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'theatergen_tpu', 'transformers', "
        "'safetensors', 'optax', 'orbax'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_the_turn_modules_are_covered():
    """The turn's modules (the SDXL turn's T2I-Adapter, the GroundingDINO
    and OWL-ViT detectors, the evaluation and the golden kit, the mesh,
    its workers and the sharded training too) are among those
    test_port_imports_no_jax imports in a fresh interpreter."""
    mods = set(_modules())
    for m in ("cli.generate", "db", "runtime.store", "perception.detector",
              "utils.parse", "utils.profiling", "utils.png", "theater",
              "models.t2i_adapter", "perception.gdino", "perception.swin",
              "perception.bert", "perception.owl", "eval", "eval.metrics",
              "eval.cmig", "eval.inception", "eval.goldens", "utils.vis",
              "parallel.mesh", "parallel.collectives", "parallel.sp",
              "parallel.worker",
              "parallel.driver", "training.diffusion",
              "training.checkpoint"):
        assert f"theatergen_tpu_torch.{m}" in mods, m


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_golden_parity.py"]))
def test_source_names_no_jax(path):
    text = (ROOT / path).read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            head = s.split()[1].split(".")[0]
            assert head not in ("jax", "jaxlib", "flax", "theatergen_tpu",
                                "transformers", "safetensors", "optax",
                                "orbax"), (path, line)


def test_init_bundle_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        b = init_bundle(tiny_config(), 0)
        assert b.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_bundle(tiny_config(), 0)
    assert init_bundle(tiny_config(), 0, device="cpu").device.type == "cpu"


def test_seeded_init_is_deterministic():
    a = init_bundle(tiny_config(), 3, device="cpu")
    b = init_bundle(tiny_config(), 3, device="cpu")
    c = init_bundle(tiny_config(), 4, device="cpu")
    for k, v in a.unet.state_dict().items():
        assert torch.equal(v, b.unet.state_dict()[k]), k
    assert not torch.equal(a.unet.conv_in.weight, c.unet.conv_in.weight)


def test_kernel_sources_and_targets():
    """Every kernel builds from csrc/ into build/torch_kernels/ under a
    name that changes with its source."""
    assert _build.kernel_names() == ["cross_attention", "ff_geglu",
                                     "flash_attention", "geglu_matmul",
                                     "group_norm", "quant_matmul"]
    for name in _build.kernel_names():
        t = _build._target(name)
        assert t.parent == ROOT / "build" / "torch_kernels"
        assert t.name.startswith(f"lib{name}-") and t.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_wrappers_take_the_plain_version_only_on_cpu(monkeypatch):
    """CPU tensors never reach the kernel library (nor nvcc)."""
    from theatergen_tpu_torch.models.layers import QuantLinear
    from theatergen_tpu_torch.ops import attention as attn_ops
    from theatergen_tpu_torch.ops import flash_attention as fa
    from theatergen_tpu_torch.ops import geglu_matmul as gg
    from theatergen_tpu_torch.ops import groupnorm as gn
    from theatergen_tpu_torch.ops import quant as qops
    from theatergen_tpu_torch.ops import quant_matmul as qm

    def boom(*a, **k):
        raise AssertionError("kernel library requested for CPU tensors")

    monkeypatch.setattr(_build, "library", boom)
    q = torch.randn(1, 1024, 2, 40, dtype=torch.bfloat16)
    assert fa.flash_attention(q, q, q).shape == q.shape
    k = torch.randn(1, 77, 2, 40, dtype=torch.bfloat16)
    assert attn_ops.cross_attention(q, k, k, k[:, :4], k[:, :4],
                                    0.4).shape == q.shape
    x = torch.randn(4, 320, dtype=torch.bfloat16)
    w1 = torch.randn(2560, 320, dtype=torch.bfloat16)
    out = gg.ff_matmul(x, w1, torch.zeros(2560, dtype=torch.bfloat16),
                       torch.randn(320, 1280, dtype=torch.bfloat16))
    assert out.shape == x.shape
    hg = torch.randn(2, 4, 2560, dtype=torch.bfloat16)
    out = gg.geglu_matmul(hg, torch.randn(640, 1280, dtype=torch.bfloat16))
    assert out.shape == (2, 4, 640)
    x = torch.randn(2, 320, 8, 8, dtype=torch.bfloat16)
    w = torch.ones(320, dtype=torch.bfloat16)
    assert gn.fused_group_norm(x, w, w, act="silu").shape == x.shape
    x = torch.randn(2, 77, 320, dtype=torch.bfloat16)
    wq = torch.randint(-127, 128, (640, 320), dtype=torch.int8)
    out = qm.quant_matmul(x, wq, torch.rand(640), torch.zeros(
        640, dtype=torch.bfloat16))
    assert out.shape == (2, 77, 640) and out.dtype == x.dtype
    lin = QuantLinear(320, 640).to(torch.bfloat16)
    for mode in ("0", "1"):
        monkeypatch.setattr(qops, "FUSED_MODE", mode)
        assert lin(x).shape == (2, 77, 640)


def test_port_modules_of_the_character_slice():
    """The character slice's modules are among those the import rule above
    covers, and the IP bundle's entry points default to the card too."""
    mods = _modules()
    for m in ("ops.groupnorm", "ops.guidance", "models.ip_adapter",
              "pipelines.character"):
        assert f"theatergen_tpu_torch.{m}" in mods
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_bundle(tiny_config(), 0, with_ip=True, with_vision=True)


def test_port_modules_of_the_w8a8_slice():
    """The W8A8 slice's modules are among those the import rule above
    covers, a quantized bundle defaults to the card too, and the port
    keeps the JAX package's default route ("0") for THEATERGEN_FUSED_INT8."""
    import dataclasses

    mods = _modules()
    for m in ("ops.quant", "ops.quant_matmul"):
        assert f"theatergen_tpu_torch.{m}" in mods
    code = ("import os; os.environ.pop('THEATERGEN_FUSED_INT8', None); "
            "from theatergen_tpu_torch.ops import quant; "
            "print(quant.FUSED_MODE)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "0", r.stderr
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, quantized=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_bundle(cfg, 0)


def test_port_modules_of_the_final_slice():
    """The final slice's modules are among those the import rule above
    covers, and a bundle with the ControlNet defaults to the card too."""
    mods = _modules()
    for m in ("theater", "ops.geometry", "ops.latents", "ops.lineart",
              "models.controlnet", "pipelines.final"):
        assert f"theatergen_tpu_torch.{m}" in mods
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_bundle(tiny_config(), 0, with_ip=True, with_vision=True,
                        with_controlnet=True)


def test_port_modules_of_the_checkpoint_slice():
    """The checkpoint slice's modules are among those the import rules
    above cover, and its entry points default to the card too:
    ``load_bundle``, ``load_bundle_snapshot`` and ``init_bundle`` with a
    segmenter."""
    import tempfile

    from theatergen_tpu_torch.models import snapshot, weights

    mods = _modules()
    for m in ("models.weights", "models.export", "models.snapshot",
              "perception.sam", "perception.sam_hf", "ops.lineart"):
        assert f"theatergen_tpu_torch.{m}" in mods
    if torch.cuda.is_available():
        return
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            weights.load_bundle(tiny_config(), d)
        snapshot.save_bundle_snapshot(
            init_bundle(tiny_config(), 0, device="cpu"), d + "/snap")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            snapshot.load_bundle_snapshot(tiny_config(), d + "/snap")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_bundle(tiny_config(), 0, with_sam=True)


def test_port_modules_of_the_training_slice():
    """The trainer, its checkpoints and the layout utilities are among the
    modules the import rules above cover; importing the trainer alone
    loads none of jax, optax, orbax or the JAX package; its entry points
    default to the card too: ``make_train_step``, ``load_checkpoint`` and
    ``from_flax_train_state``."""
    import tempfile

    from theatergen_tpu_torch.models.unet import UNet2DCondition
    from theatergen_tpu_torch.pipelines.bundle import build_module
    from theatergen_tpu_torch.training import checkpoint, diffusion

    mods = _modules()
    for m in ("training", "training.diffusion", "training.checkpoint",
              "utils.layout", "utils.cache"):
        assert f"theatergen_tpu_torch.{m}" in mods, m
    code = ("import sys\n"
            "import theatergen_tpu_torch.training.diffusion\n"
            "import theatergen_tpu_torch.training.checkpoint\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'theatergen_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    if torch.cuda.is_available():
        return
    cfg = tiny_config()
    unet = build_module(UNet2DCondition, cfg.unet, torch.float32, "cpu",
                        torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        diffusion.make_train_step(unet, diffusion.make_optimizer(),
                                  cfg.scheduler)
    state = diffusion.make_train_step(
        unet, diffusion.make_optimizer(), cfg.scheduler,
        device="cpu").init_state()
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save_checkpoint(d + "/step_0", state)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            checkpoint.load_checkpoint(d + "/step_0")
        assert checkpoint.load_checkpoint(d + "/step_0",
                                          device="cpu").step == 0

