"""The port imports nothing of JAX, flax or the reference package,
and needs none of the packages the card's machine lacks.

``evam_tpu_torch``, ``chip_smoke.py``, ``tools/cuda_qgemm_bench.py`` and
``tools/cuda_host_stalls.py`` must run on a machine that has neither JAX nor flax, nor aiohttp,
pydantic, msgpack, cv2, zmq, cryptography or websockets. Checks: every module imports in a
subprocess where all of those are blocked (and the server's route table
and the CLI's parser build there); an AST scan finds no import of
``jax``, ``flax`` or ``evam_tpu`` anywhere (``evam_tpu_torch`` itself
starts with ``evam_tpu``, so names are matched exactly, not by prefix)
and no import of the machine's missing packages at a module's top level
(nor of the reference's training stack, ``optax`` and ``orbax``, at all;
the parallel package is scanned on its own for them too)
(``cv2`` is imported inside the function that uses it), nor of
``msgpack`` anywhere: the port reads and writes weights files with the
standard library; and the WebRTC egress (``publish/webrtc.py``,
``publish/rtc/``) imports none of ``cv2``, ``cryptography`` and
``websockets`` anywhere, not even inside a function. No module calls
``torch.cuda.Stream()``: every engine owns its streams.
"""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "evam_tpu_torch"
BLOCKED = ("jax", "flax", "evam_tpu")
#: the reference's training stack: the port's trainer uses torch's own
#: optimizer and checkpoint file, and the card's machine has neither
TRAINING = ("optax", "orbax")
#: not installed on the card's machine
ABSENT = ("aiohttp", "pydantic", "msgpack", "cv2", "zmq", "cryptography",
          "websockets")
#: what the reference's WebRTC media plane and signalling stand on
WEBRTC_ABSENT = ("cv2", "cryptography", "websockets")


def _port_files() -> list[Path]:
    return sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tools" / "cuda_qgemm_bench.py",
        ROOT / "tools" / "cuda_host_stalls.py"]


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
        *[f"sys.modules[{b!r}] = None" for b in BLOCKED + ABSENT + TRAINING],
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
        f"{BLOCKED + ABSENT + TRAINING!r} and sys.modules[m] is not None)",
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
                          for n in names if _blocked(n, BLOCKED + TRAINING)]
    assert not offenders, offenders


def test_the_parallel_package_imports_no_optax_or_orbax_anywhere():
    files = sorted((PKG / "parallel").rglob("*.py"))
    assert {p.stem for p in files} >= {"mesh", "ring", "ulysses", "moe",
                                       "train", "pipeline", "dryrun"}
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names
                          if _blocked(n, BLOCKED + TRAINING)]
    assert not offenders, offenders


def _calls(tree, dotted: str):
    """Line numbers of calls to ``dotted`` (written out in full)."""
    def name(node):
        if isinstance(node, ast.Name):
            return node.id
        if isinstance(node, ast.Attribute):
            inner = name(node.value)
            return inner and f"{inner}.{node.attr}"
        return None

    return [n.lineno for n in ast.walk(tree)
            if isinstance(n, ast.Call) and name(n.func) == dotted]


def test_no_module_of_the_port_takes_a_pooled_cuda_stream():
    """``torch.cuda.Stream()`` hands out 32 streams a device round robin,
    so two engines could share one; every engine creates and destroys
    its own (``engine/streams.py``)."""
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        offenders += [f"{path.relative_to(ROOT)}:{line}"
                      for line in _calls(tree, "torch.cuda.Stream")]
        offenders += [f"{path.relative_to(ROOT)}:{n.lineno} import Stream"
                      for n in ast.walk(tree)
                      if isinstance(n, ast.ImportFrom)
                      and n.module == "torch.cuda"
                      and any(a.name == "Stream" for a in n.names)]
    assert not offenders, offenders
    code = "import torch\ns = torch.cuda.Stream(device)\n"
    assert _calls(ast.parse(code), "torch.cuda.Stream") == [2]


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


def test_no_module_imports_msgpack_anywhere():
    offenders = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):  # inside functions too
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _blocked(n, ("msgpack",))]
    assert not offenders, offenders


def _webrtc_files() -> list[Path]:
    return [PKG / "publish" / "webrtc.py",
            *sorted((PKG / "publish" / "rtc").rglob("*.py"))]


def test_webrtc_modules_import_no_cv2_cryptography_or_websockets():
    files = _webrtc_files()
    assert len(files) >= 11
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):  # inside functions too
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _blocked(n, WEBRTC_ABSENT)]
    assert not offenders, offenders


#: the accuracy harness: the reference fits with optax and flax and
#: shrinks scenes with cv2; the port's copy uses none of them, not even
#: inside a function (its fit runs on the card's machine)
ACCURACY_ABSENT = ("cv2", "optax", "flax", "jax", "evam_tpu")


def test_the_accuracy_harness_imports_no_cv2_optax_or_flax_anywhere():
    path = PKG / "models" / "accuracy.py"
    offenders, imported = [], set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        imported.update(names)
        offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                      for n in names if _blocked(n, ACCURACY_ABSENT)]
    assert not offenders, offenders
    assert {"numpy", "torch"} <= imported


def test_scan_matches_names_exactly():
    assert _blocked("evam_tpu.ops") and _blocked("jax.numpy")
    assert not _blocked("evam_tpu_torch.ops") and not _blocked("jaxlib_free")


def test_the_scan_covers_every_module_of_the_port():
    """The checks above walk the package, so a new module is covered by
    being in it: the slice modules among them (slice 8's EII modules
    and its ZeroMQ wire too, so none imports ``zmq`` or ``cv2`` at its
    top level, slice 11a's codec, sources, pool, demux, re-stream and
    painter, slice 11b's WebRTC modules, and slice 12a's accuracy
    harness, imported where ``cv2`` and ``optax`` are blocked)."""
    names = {_module_name(p) for p in _port_files()}
    assert {"evam_tpu_torch.modelproc", "evam_tpu_torch.modelproc.proc",
            "evam_tpu_torch.stages.track",
            "evam_tpu_torch.models.zoo.classifier", "chip_smoke",
            "evam_tpu_torch.media.luma", "evam_tpu_torch.stages.gate",
            "evam_tpu_torch.stages.misc", "evam_tpu_torch.stages.udf",
            "evam_tpu_torch.extensions",
            "evam_tpu_torch.extensions.event_convert",
            "evam_tpu_torch.extensions.object_line_crossing",
            "evam_tpu_torch.extensions.object_zone_count",
            "evam_tpu_torch.models.zoo.action",
            "evam_tpu_torch.models.zoo.aclnet",
            "evam_tpu_torch.media.audio", "evam_tpu_torch.eii",
            "evam_tpu_torch.eii.zmtp", "evam_tpu_torch.eii.msgbus",
            "evam_tpu_torch.eii.configmgr", "evam_tpu_torch.eii.manager",
            "evam_tpu_torch.publish.encode",
            "evam_tpu_torch.publish.zmq_dest",
            # slice 11a's ingest and re-stream: cv2 only inside the
            # functions that fall back to it
            "evam_tpu_torch.media.jpeg", "evam_tpu_torch.media.h264",
            "evam_tpu_torch.media.decode", "evam_tpu_torch.media.pool",
            "evam_tpu_torch.media.demux", "evam_tpu_torch.media.source",
            "evam_tpu_torch.publish.rtsp",
            "evam_tpu_torch.publish.annotate",
            # slice 11b's WebRTC egress
            "evam_tpu_torch.publish.webrtc", "evam_tpu_torch.publish.rtc",
            "evam_tpu_torch.publish.rtc.openssl",
            "evam_tpu_torch.publish.rtc.stun",
            "evam_tpu_torch.publish.rtc.srtp",
            "evam_tpu_torch.publish.rtc.rtcp",
            "evam_tpu_torch.publish.rtc.dtls",
            "evam_tpu_torch.publish.rtc.vp8",
            "evam_tpu_torch.publish.rtc.session",
            "evam_tpu_torch.publish.rtc.ws",
            "evam_tpu_torch.publish.rtc.signaling",
            "evam_tpu_torch.publish.rtc.viewer",
            # slice 9's parallel training path
            "evam_tpu_torch.parallel", "evam_tpu_torch.parallel.comm",
            "evam_tpu_torch.parallel.mesh", "evam_tpu_torch.parallel.ring",
            "evam_tpu_torch.parallel.ulysses", "evam_tpu_torch.parallel.moe",
            "evam_tpu_torch.parallel.train",
            "evam_tpu_torch.parallel.pipeline",
            "evam_tpu_torch.parallel.dryrun",
            "evam_tpu_torch.engine.streams",
            # slice 12a's accuracy harness (cv2 and optax blocked above)
            "evam_tpu_torch.models.accuracy"} <= names
