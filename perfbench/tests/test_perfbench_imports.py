"""Nothing of the benchmark imports JAX or the JAX package, the references
import nothing of the program, and nothing reads the JAX package's
benchmark files or the bring-up's smoke script."""
from __future__ import annotations

import ast

import pytest

from perfbench.lib.manifest import PKG

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(PKG).as_posix())
def test_no_jax_and_no_jax_package(path):
    names = set(top_level_imports(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path.parent.name == "reference":
        assert "repro_torch" not in names


def test_whole_names_are_compared():
    """``repro_torch`` is the program, not the JAX package ``repro``."""
    from perfbench.lib.guard import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.models", "jaxtyping", "torch"]) == []
    assert forbidden_modules(["repro_torch", "repro.core", "jaxlib.xla", "flax"]) == \
        ["flax", "jaxlib", "repro"]


def test_reads_no_file_of_the_jax_package_or_the_bring_up():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        for word in ("benchmarks/", "BENCH_", "chip_smoke"):
            assert word not in text, (path, word)
