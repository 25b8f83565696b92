"""The port imports nothing of JAX, flax or the reference package.

``evam_tpu_torch``, ``chip_smoke.py`` and ``tools/cuda_qgemm_bench.py``
must run on a machine that has
neither JAX nor flax. Two checks: every module imports in a subprocess
where ``jax``, ``flax`` and ``evam_tpu`` are blocked, and an AST scan
finds no import of them (``evam_tpu_torch`` itself starts with
``evam_tpu``, so names are matched exactly, not by prefix).
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "evam_tpu_torch"
BLOCKED = ("jax", "flax", "evam_tpu")


def _port_files() -> list[Path]:
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "tools" / "cuda_qgemm_bench.py"]


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_every_module_imports_with_jax_blocked():
    modules = [_module_name(p) for p in _port_files()]
    code = "\n".join([
        "import sys",
        *[f"sys.modules[{b!r}] = None" for b in BLOCKED],
        "import importlib",
        f"for name in {modules!r}:",
        "    importlib.import_module(name)",
        "import chip_smoke",
        "chip_smoke._import_port()",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'evam_tpu') and sys.modules[m] is not None)",
        "assert not bad, bad",
        "print('ok', len(sys.modules))",
    ])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_no_module_names_jax_flax_or_the_reference():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _blocked(n)]
    assert not offenders, offenders


def test_scan_matches_names_exactly():
    assert _blocked("evam_tpu.ops") and _blocked("jax.numpy")
    assert not _blocked("evam_tpu_torch.ops") and not _blocked("jaxlib_free")
