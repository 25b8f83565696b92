"""Hot-loop hygiene pass.

The dispatcher/launcher/completer/watchdog threads run per-batch at
the serving rate; anything slow or syscall-shaped inside their loop
bodies is paid thousands of times per second.  History: the fault
injector once read ``os.environ`` per batch.

Starting from the configured entry methods (``BatchEngine._run*`` and
its loop threads, ``FleetEngine``, ``SupervisedEngine._monitor*``),
this pass walks a lexical intra-package call graph (``self.method`` →
same class, bare name → same module, ``mod.fn`` / from-imports across
modules) and flags, for code that executes inside a ``while``/``for``
body on those paths:

- ``os.environ`` reads / ``os.getenv``
- ``open()``
- ``time.sleep`` (event waits like ``self._stop.wait()`` are fine)
- metric registration (``register_metric`` / ``metrics.register``)

Calls through non-self objects (``inj.maybe_wedge(...)``) are not
resolvable lexically and are deliberately skipped — keep hot-path
helpers boring or take an allowlist entry with a justification.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import PACKAGE, Finding, SourceFile, is_package_module

# (file regex, class name, method regex) — the thread entry points:
# BatchEngine's _run, _launch, _launch_loop, _launch_sched, the three
# _dispatch_loop_* variants, _completion_loop and _watchdog_loop;
# SupervisedEngine._monitor_loop; every FleetEngine method.
ENTRY_POINTS = (
    (r"evam_tpu_torch/engine/batcher\.py", "BatchEngine",
     r"^(_run|_dispatch_loop|_launch|_completion_loop|_watchdog_loop)"),
    (r"evam_tpu_torch/engine/supervisor\.py", "SupervisedEngine",
     r"^_monitor"),
    (r"evam_tpu_torch/fleet/engine\.py", "FleetEngine", r".*"),
)

_BANNED_DOTTED = {
    "os.getenv": "os.getenv",
    "getenv": "os.getenv",
    "time.sleep": "time.sleep",
    "metrics.register": "metric registration",
    "register_metric": "metric registration",
}


def _dotted(node: ast.expr) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _banned_call(node: ast.Call) -> str | None:
    name = _dotted(node.func)
    if name is None:
        return None
    if name == "open":
        return "file I/O (open)"
    if name.endswith("environ.get") or name.endswith("environ.setdefault"):
        return "os.environ read"
    return _BANNED_DOTTED.get(name)


class _FuncInfo:
    def __init__(self, sf: SourceFile, cls: str | None,
                 node: ast.FunctionDef | ast.AsyncFunctionDef):
        self.sf = sf
        self.cls = cls
        self.node = node

    @property
    def key(self) -> tuple[str, str | None, str]:
        return (self.sf.rel, self.cls, self.node.name)


class _ModuleIndex:
    """Per-module lexical name resolution: functions, classes, imports."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.functions: dict[str, _FuncInfo] = {}
        self.classes: dict[str, dict[str, _FuncInfo]] = {}
        # local name → (module rel path, remote name | None)
        self.imports: dict[str, tuple[str, str | None]] = {}
        assert sf.tree is not None
        pkg_parts = sf.rel.split("/")[:-1]  # e.g. ["evam_tpu_torch", "engine"]
        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = _FuncInfo(sf, None, node)
            elif isinstance(node, ast.ClassDef):
                methods = {}
                for m in node.body:
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        methods[m.name] = _FuncInfo(sf, node.name, m)
                self.classes[node.name] = methods
            elif isinstance(node, ast.ImportFrom):
                base = self._resolve_from(node, pkg_parts)
                if base is not None:
                    for alias in node.names:
                        self.imports[alias.asname or alias.name] = \
                            (base, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.startswith(PACKAGE + "."):
                        self.imports[alias.asname or alias.name.split(".")[-1]] \
                            = (alias.name.replace(".", "/") + ".py", None)

    @staticmethod
    def _resolve_from(node: ast.ImportFrom, pkg_parts: list[str]) -> str | None:
        if node.level:
            base_parts = pkg_parts[:len(pkg_parts) - (node.level - 1)]
            if node.module:
                base_parts = base_parts + node.module.split(".")
            return "/".join(base_parts) + ".py"
        if node.module and is_package_module(node.module):
            return node.module.replace(".", "/") + ".py"
        return None


def _module_candidates(rel: str) -> list[str]:
    # "evam_tpu_torch/obs/faults.py" or package __init__
    return [rel, rel[:-3] + "/__init__.py"]


class _Walker(ast.NodeVisitor):
    """One function body: report banned calls in loop context, collect
    resolvable callees with their loop context."""

    def __init__(self, index: _ModuleIndex, fn: _FuncInfo, in_loop: bool):
        self.index = index
        self.fn = fn
        self.in_loop = in_loop
        self.banned: list[tuple[int, str]] = []
        self.callees: list[tuple[_FuncInfo | tuple[str, str | None], bool]] = []

    def visit_While(self, node: ast.While) -> None:
        self.visit(node.test)
        outer, self.in_loop = self.in_loop, True
        for child in node.body + node.orelse:
            self.visit(child)
        self.in_loop = outer

    def visit_For(self, node: ast.For) -> None:
        self.visit(node.iter)
        outer, self.in_loop = self.in_loop, True
        for child in node.body + node.orelse:
            self.visit(child)
        self.in_loop = outer

    visit_AsyncFor = visit_For

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if self.in_loop and isinstance(node.ctx, ast.Load):
            name = _dotted(node.value)
            if name is not None and name.endswith("environ"):
                self.banned.append((node.lineno, "os.environ read"))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        if self.in_loop:
            why = _banned_call(node)
            if why is not None:
                self.banned.append((node.lineno, why))
        self._collect_callee(node)
        self.generic_visit(node)

    def _collect_callee(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.value.id == "self" and self.fn.cls is not None:
                target = self.index.classes.get(self.fn.cls, {}).get(f.attr)
                if target is not None:
                    self.callees.append((target, self.in_loop))
            elif f.value.id in self.index.imports:
                base, remote = self.index.imports[f.value.id]
                if remote is None:  # `import evam_tpu_torch.x as y` → y.fn()
                    self.callees.append(((base, f.attr), self.in_loop))
        elif isinstance(f, ast.Name):
            if f.id in self.index.functions:
                self.callees.append((self.index.functions[f.id], self.in_loop))
            elif f.id in self.index.imports:
                base, remote = self.index.imports[f.id]
                if remote is not None:
                    self.callees.append(((base, remote), self.in_loop))


def run(root: Path, files: list[SourceFile]) -> list[Finding]:
    indexes: dict[str, _ModuleIndex] = {}
    for sf in files:
        if sf.tree is not None:
            indexes[sf.rel] = _ModuleIndex(sf)

    # seed the worklist from the entry points
    work: list[tuple[_FuncInfo, bool]] = []
    for file_re, cls, meth_re in ENTRY_POINTS:
        for rel, idx in indexes.items():
            if not re.fullmatch(file_re, rel):
                continue
            for name, info in idx.classes.get(cls, {}).items():
                if re.match(meth_re, name):
                    work.append((info, False))

    findings: list[Finding] = []
    seen: set[tuple] = set()
    while work:
        fn, in_loop = work.pop()
        state = (fn.key, in_loop)
        if state in seen:
            continue
        seen.add(state)
        walker = _Walker(indexes[fn.sf.rel], fn, in_loop)
        for child in fn.node.body:
            walker.visit(child)
        where = f"{fn.cls + '.' if fn.cls else ''}{fn.node.name}"
        for line, why in walker.banned:
            findings.append(Finding(
                "hotloop", fn.sf.rel, line, f"hotloop:{why.split(' ')[0]}",
                f"{why} inside a hot loop body (reached via {where}); "
                f"hoist it out of the per-batch path"))
        for callee, loop_ctx in walker.callees:
            if isinstance(callee, _FuncInfo):
                work.append((callee, loop_ctx))
            else:
                base, name = callee
                for cand in _module_candidates(base):
                    idx = indexes.get(cand)
                    if idx is not None and name in idx.functions:
                        work.append((idx.functions[name], loop_ctx))
                        break
    # dedupe (a line can be reached via several paths)
    uniq: dict[tuple, Finding] = {}
    for f in findings:
        uniq.setdefault((f.file, f.line, f.ident), f)
    return list(uniq.values())
