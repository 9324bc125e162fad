"""Static scan: neither the port nor ``chip_smoke.py`` nor ``chip_ab.py``
imports ``jax`` or the JAX package ``photon_ml_tpu`` (the port keeps its
own copies of what it needs). Static, so it does not depend on what else
the test process has already imported."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "photon_ml_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "chip_ab.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "photon_ml_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(os.path.relpath(f, ROOT) for f in files)


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value


def test_scan_covers_the_port():
    files = _port_files()
    assert "chip_smoke.py" in files and "chip_ab.py" in files
    assert os.path.join("photon_ml_tpu_torch", "cli", "score.py") in files
    assert os.path.join("photon_ml_tpu_torch", "kernels", "ell.py") in files
    for rel in (("cli", "train.py"), ("cli", "stages.py"), ("kernels", "fused.py"),
                ("ops", "objective.py"), ("ops", "stats.py"), ("solvers", "tron.py"),
                ("solvers", "lbfgs.py"), ("solvers", "linesearch.py"),
                ("models", "training.py"), ("core", "normalization.py"),
                ("kernels", "lab.py"), ("benchmarks", "sparse_kernel_lab.py"),
                ("game", "data.py"), ("game", "factored.py"), ("game", "scoring.py"),
                ("serving", "engine.py"), ("game", "coordinates.py"),
                ("game", "descent.py"), ("solvers", "batched.py"),
                ("cli", "game_train.py"), ("resilience", "shutdown.py"),
                ("resilience", "faults.py"), ("serving", "stats.py"),
                ("serving", "batcher.py"), ("serving", "registry.py"),
                ("serving", "cache.py"), ("cli", "serve.py"), ("obs", "__init__.py"),
                ("obs", "metrics.py"), ("obs", "sketches.py"), ("obs", "exemplars.py"),
                ("obs", "reqtrace.py"), ("obs", "trace.py"), ("obs", "device.py")):
        assert os.path.join("photon_ml_tpu_torch", *rel) in files


def test_scanner_flags_forbidden_imports():
    src = (
        "import jax\nfrom jax import numpy\nimport photon_ml_tpu.io\n"
        "from photon_ml_tpu.ops import sparse\nimport importlib\n"
        "importlib.import_module('jax.numpy')\n"
        "import photon_ml_tpu_torch\nfrom photon_ml_tpu_torch.io import avro\n"
    )
    bad = [m for _, m in _imported_modules(ast.parse(src)) if _forbidden(m)]
    assert bad == ["jax", "jax", "photon_ml_tpu.io", "photon_ml_tpu.ops", "jax.numpy"]


@pytest.mark.parametrize("rel", _port_files())
def test_no_jax_or_jax_package_import(rel):
    with open(os.path.join(ROOT, rel), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=rel)
    bad = [(line, m) for line, m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{rel} imports {bad}"
