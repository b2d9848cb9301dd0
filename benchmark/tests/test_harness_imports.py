"""Nothing of the benchmark loads JAX or the JAX package, and the plain
reference loads nothing of the program.  A module's top-level name (the
part before the first dot) is compared whole: the port's name begins
with the JAX package's."""

import ast
import subprocess
import sys

import pytest

from harness_tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "theatergen_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_neither_jax_nor_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_reference_sources_import_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        names = set(_imports(f))
        assert "theatergen_tpu_torch" not in names, f
        assert "harness" not in names, f


def _loaded(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{BENCH}:{ROOT}", "PATH": "/usr/bin:/bin",
             "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


@pytest.mark.parametrize("what", ["harness", "reference"])
def test_loaded_modules(what):
    code = {
        "harness": "import harness.main, harness.tracing, readings",
        "reference": "import reference.turn",
    }[what]
    loaded = _loaded(code)
    assert not loaded & FORBIDDEN
    if what == "reference":
        assert "theatergen_tpu_torch" not in loaded


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from harness.main import forbidden_modules

    monkeypatch.setitem(sys.modules, "theatergen_tpu_torch_x", sys)
    assert "theatergen_tpu_torch_x" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "theatergen_tpu.models", sys)
    assert "theatergen_tpu" in forbidden_modules()
