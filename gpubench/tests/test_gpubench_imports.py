"""What the benchmark may load: never JAX nor the JAX package, and the
reference nothing of the program."""

from __future__ import annotations

import ast
import sys

from gpubench.harness import cell, spec


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "evam_tpu_torch_probe", object())
    assert "evam_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "evam_tpu.engine", object())
    assert "evam_tpu" in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in cell.forbidden_modules()


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in spec.BENCH_DIR.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in cell.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").rglob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("__future__", "dataclasses", "itertools", "math",
                           "numpy", "torch", "gpubench"), (path, name)
            if top == "gpubench":
                assert name.startswith("gpubench.reference"), (path, name)
