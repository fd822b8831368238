"""What the benchmark imports, by the top-level name of each import (the
part before the first dot, compared whole): no module it runs imports
jax, jaxlib, flax or the JAX package, and the plain references import
nothing but torch, numpy, the standard library and each other."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "metropolismontecarlo_tpu"}
REFERENCE_ALLOWED = {"math", "numpy", "torch"}


def _modules(path):
    """The full name of every module the file imports ("." for a relative
    import)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                yield "."
            elif node.module:
                yield node.module


def _imports(path):
    return (m.split(".")[0] for m in _modules(path))


def _run_modules():
    return sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", _run_modules(),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & BANNED


def test_top_level_names_compared_whole():
    assert "metropolismontecarlo_tpu_torch" not in BANNED
    assert "jaxtyping".split(".")[0] not in BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_only_plain_libraries(path):
    for m in _modules(path):
        assert m.split(".")[0] in REFERENCE_ALLOWED \
            or m.startswith("benchmark.reference."), m
