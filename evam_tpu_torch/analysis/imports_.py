"""Package-level import-cycle pass.

A hub⇄fleet knot only surfaces at import time, and its fix is a
deliberate function-level deferred import.  This pass builds the
module graph from *top-level* imports only (deferred imports inside
function bodies are exactly the sanctioned cycle breakers and are
ignored) and reports every strongly-connected component of size > 1.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .core import Finding, SourceFile, is_package_module


def _top_level_imports(tree: ast.Module) -> list[ast.stmt]:
    """Module-body imports, descending through top-level try/if blocks
    (conditional imports still execute at import time)."""
    out: list[ast.stmt] = []
    stack: list[ast.stmt] = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            out.append(node)
        elif isinstance(node, ast.Try):
            stack.extend(node.body + node.orelse + node.finalbody)
            for h in node.handlers:
                stack.extend(h.body)
        elif isinstance(node, ast.If):
            stack.extend(node.body + node.orelse)
    return out


def _edges(sf: SourceFile, known: set[str]) -> set[str]:
    """Outgoing intra-package edges as repo-relative paths."""
    assert isinstance(sf.tree, ast.Module)
    self_pkg = sf.rel.split("/")[:-1]
    targets: set[str] = set()

    def add_module(parts: list[str], names: list[str] | None) -> None:
        base = "/".join(parts)
        if names is None:
            for cand in (base + ".py", base + "/__init__.py"):
                if cand in known:
                    targets.add(cand)
            return
        # `from pkg import name`: a name that is itself a submodule
        # binds WITHOUT requiring pkg/__init__'s body to finish (the
        # interpreter falls back to the submodule in sys.modules), so
        # it depends only on the submodule.  A plain symbol, on the
        # other hand, must exist on the module object — that is a real
        # edge to the module (or package __init__) body.
        for n in names:
            sub = None
            for cand in (f"{base}/{n}.py", f"{base}/{n}/__init__.py"):
                if cand in known:
                    sub = cand
                    break
            if sub is not None:
                targets.add(sub)
            else:
                for cand in (base + ".py", base + "/__init__.py"):
                    if cand in known:
                        targets.add(cand)

    for node in _top_level_imports(sf.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if is_package_module(alias.name):
                    add_module(alias.name.split("."), None)
        else:
            names = [a.name for a in node.names]
            if node.level:
                base = self_pkg[:len(self_pkg) - (node.level - 1)]
                if node.module:
                    base = base + node.module.split(".")
                add_module(base, names)
            elif node.module and is_package_module(node.module):
                add_module(node.module.split("."), names)
    targets.discard(sf.rel)
    return targets


def _tarjan_sccs(graph: dict[str, set[str]]) -> list[list[str]]:
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan (the package is deep enough to bust the
        # recursion limit on pathological graphs)
        work = [(v, iter(sorted(graph.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(graph.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


def run(root: Path, files: list[SourceFile]) -> list[Finding]:
    known = {sf.rel for sf in files}
    graph = {sf.rel: _edges(sf, known) for sf in files
             if isinstance(sf.tree, ast.Module)}
    findings: list[Finding] = []
    for scc in _tarjan_sccs(graph):
        if len(scc) < 2:
            continue
        cycle = sorted(scc)
        findings.append(Finding(
            "imports", cycle[0], 1,
            "import-cycle:" + "+".join(cycle),
            "package-level import cycle: " + " <-> ".join(cycle)
            + "; break it with a function-level deferred import"))
    return findings
