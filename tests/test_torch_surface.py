"""Completeness and isolation of the PyTorch port, read from the sources.

Parses both packages with ``ast`` (imports neither's runtime):
- every public top-level ``def``/``class`` of each module of the JAX
  package ``nusiprop_tpu`` has a counterpart of the same name in the
  port's module at the same path, apart from the explicit exceptions in
  ``RENAMED`` and ``NOT_PORTED``, each with its reason;
- no module of ``nusiprop_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or ``nusiprop_tpu`` at any depth (function-local imports
  included).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "nusiprop_tpu"
PORT_PKG = ROOT / "nusiprop_tpu_torch"

# JAX modules with no counterpart, and why
NOT_PORTED = {
    "native_binding.py": "a ctypes binding to the C++ CPU engine in "
                         "native/, with no JAX code: the CPU cross-check",
    "ops/ds.py": "double-single f32 pairs emulate f64 only because Mosaic "
                 "has no f64; K2 runs in native fp64 on the card",
}
# (JAX module, name) -> the port's name in the same module, and why
RENAMED = {
    ("ops/march_tri.py", "march_tri_jax"): (
        "march_tri_plain", "the plain twin of K1 in PyTorch"),
    ("ops/march_ds.py", "march_pallas_batched"): (
        "march_ds_batched", "K2's batched launch, a CUDA kernel here"),
}

JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in PORT_PKG.rglob("*.py")) + ["chip_smoke.py"]


def _public(path: Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")}


def _imported(src: str) -> set:
    """Top-level package names of every import in the source, at any
    depth; relative imports count as the port itself."""
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_a_counterpart(module):
    if module in NOT_PORTED:
        assert not (PORT_PKG / module).exists()
        return
    port = PORT_PKG / module
    assert port.exists(), f"no port of nusiprop_tpu/{module}"
    theirs = _public(JAX_PKG / module)
    ours = _public(port)
    missing = set()
    for name in theirs - ours:
        alias = RENAMED.get((module, name))
        if alias is None or alias[0] not in ours:
            missing.add(name)
    assert not missing, f"{module}: {sorted(missing)}"


def test_exceptions_name_real_code():
    """Every exception still names a JAX module or function that exists."""
    for module in NOT_PORTED:
        assert (JAX_PKG / module).exists(), module
    for (module, name), (alias, why) in RENAMED.items():
        assert name in _public(JAX_PKG / module), (module, name)
        assert alias in _public(PORT_PKG / module), (module, alias)
        assert why


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_import(path):
    bad = _imported((ROOT / path).read_text()) & {"jax", "jaxlib",
                                                   "nusiprop_tpu"}
    assert not bad, f"{path} imports {sorted(bad)}"


def test_the_audit_sees_imports():
    """The import scan finds a function-local import, ``from`` form and
    ``__import__`` alike (the test above is not vacuous)."""
    src = ("def f():\n    import jax.numpy as jnp\n"
           "def g():\n    from nusiprop_tpu.models import grids\n"
           "h = __import__('jaxlib')\n")
    assert _imported(src) == {"jax", "nusiprop_tpu", "jaxlib"}
