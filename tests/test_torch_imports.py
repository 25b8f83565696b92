"""The port imports nothing of JAX, flax or the reference package,
and needs none of the packages the card's machine lacks.

``evam_tpu_torch``, ``chip_smoke.py`` and ``tools/cuda_qgemm_bench.py``
must run on a machine that has neither JAX nor flax, nor aiohttp,
pydantic, msgpack, cv2 or zmq. Checks: every module imports in a
subprocess where all of those are blocked (and the server's route table
and the CLI's parser build there); an AST scan finds no import of
``jax``, ``flax`` or ``evam_tpu`` anywhere (``evam_tpu_torch`` itself
starts with ``evam_tpu``, so names are matched exactly, not by prefix)
and no import of the machine's missing packages at a module's top level
(``msgpack`` and ``cv2`` are imported inside the functions that use
them).
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "evam_tpu_torch"
BLOCKED = ("jax", "flax", "evam_tpu")
#: not installed on the card's machine
ABSENT = ("aiohttp", "pydantic", "msgpack", "cv2", "zmq")


def _port_files() -> list[Path]:
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "tools" / "cuda_qgemm_bench.py"]


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _blocked(name: str, names=BLOCKED) -> bool:
    return any(name == b or name.startswith(b + ".") for b in names)


def test_every_module_imports_with_jax_blocked():
    modules = [_module_name(p) for p in _port_files()]
    code = "\n".join([
        "import sys",
        *[f"sys.modules[{b!r}] = None" for b in BLOCKED + ABSENT],
        "import importlib",
        f"for name in {modules!r}:",
        "    importlib.import_module(name)",
        "import chip_smoke",
        "chip_smoke._import_port()",
        # the server's route table and the CLI's parser build without
        # them too
        "from evam_tpu_torch.cli.main import build_parser",
        "assert build_parser().parse_args(['serve']).command == 'serve'",
        "from evam_tpu_torch.config.settings import Settings",
        "from evam_tpu_torch.engine.hub import EngineHub",
        "from evam_tpu_torch.models.registry import ModelRegistry",
        "from evam_tpu_torch.server.app import App",
        "from evam_tpu_torch.server.registry import PipelineRegistry",
        "hub = EngineHub(ModelRegistry(device='cpu'), device='cpu')",
        "app = App(PipelineRegistry(Settings(device='cpu'), hub=hub))",
        "assert len(app.routes) == 13",
        "assert app.handle('GET', '/pipelines', b'').status == 200",
        "hub.stop()",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED + ABSENT!r} and sys.modules[m] is not None)",
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


def test_no_module_imports_a_missing_package_at_top_level():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:  # module level only: not inside functions
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _blocked(n, ABSENT)]
    assert not offenders, offenders


def test_scan_matches_names_exactly():
    assert _blocked("evam_tpu.ops") and _blocked("jax.numpy")
    assert not _blocked("evam_tpu_torch.ops") and not _blocked("jaxlib_free")


def test_the_scan_covers_every_module_of_the_port():
    """The checks above walk the package, so a new module is covered by
    being in it: the slice modules among them."""
    names = {_module_name(p) for p in _port_files()}
    assert {"evam_tpu_torch.modelproc", "evam_tpu_torch.modelproc.proc",
            "evam_tpu_torch.stages.track",
            "evam_tpu_torch.models.zoo.classifier", "chip_smoke"} <= names
