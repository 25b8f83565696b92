"""Lock-discipline pass.

Classes declare thread-shared attributes with ``SHARED_UNDER``
(attr name → guarding lock attr) or mark callers-hold-the-lock
methods with ``@locked_by`` (see ``annotations.py``).  This pass then
flags every mutation of a declared attribute — assignment, ``+=``,
item/field assignment, ``del``, or a method call on the object —
that is not lexically inside ``with self.<lock>:``.

The check is lexical and intra-class by design: no alias tracking, no
cross-function lock inference beyond ``@locked_by``.  ``__init__`` is
exempt (construction happens-before publication to other threads).

Motivating history: an unlocked ``+=`` drop-counter race and stale
queue gauges on a wedged engine both came from exactly this bug shape.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .core import Finding, SourceFile

# Receiver methods treated as reads: tolerated outside the lock.
# Everything else called on a declared attribute counts as a mutation
# (containers mutate via .append/.add/.pop/...; unknown methods are
# assumed mutating — lock them or whitelist here).
_READ_METHODS = {"get", "items", "keys", "values", "copy", "count", "index"}

# Methods exempt from the check: construction happens-before the
# worker threads exist.
_EXEMPT_METHODS = {"__init__", "__post_init__"}


def _root_self_attr(node: ast.expr) -> str | None:
    """`self.stats.bucket_batches[b]` → "stats"; None if the chain is
    not rooted at `self`."""
    chain: list[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            chain.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Name):
            return chain[-1] if node.id == "self" and chain else None
        else:
            return None


def _locked_by_decorator(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> str | None:
    for dec in fn.decorator_list:
        if (isinstance(dec, ast.Call)
                and isinstance(dec.func, (ast.Name, ast.Attribute))):
            name = (dec.func.id if isinstance(dec.func, ast.Name)
                    else dec.func.attr)
            if name == "locked_by" and dec.args \
                    and isinstance(dec.args[0], ast.Constant) \
                    and isinstance(dec.args[0].value, str):
                return dec.args[0].value
    return None


def _shared_under(cls: ast.ClassDef) -> dict[str, str]:
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "SHARED_UNDER" \
                    and isinstance(stmt.value, ast.Dict):
                out = {}
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                        out[str(k.value)] = str(v.value)
                return out
    return {}


class _MethodChecker(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, cls_name: str, method: str,
                 declared: dict[str, str], held0: frozenset[str],
                 findings: list[Finding]):
        self.sf = sf
        self.cls_name = cls_name
        self.method = method
        self.declared = declared
        self.held = held0
        self.findings = findings

    # ---- lock tracking -------------------------------------------------

    def _with_locks(self, node: ast.With | ast.AsyncWith) -> frozenset[str]:
        acquired = set()
        for item in node.items:
            attr = _root_self_attr(item.context_expr)
            if attr is not None:
                acquired.add(attr)
        return self.held | acquired

    def visit_With(self, node: ast.With) -> None:
        outer, self.held = self.held, self._with_locks(node)
        for child in node.body:
            self.visit(child)
        self.held = outer

    visit_AsyncWith = visit_With

    def _enter_scope(self, node, held: frozenset[str]) -> None:
        # a nested def/lambda body runs later, on whatever thread calls
        # it — the enclosing `with` is NOT held there
        outer, self.held = self.held, held
        for child in ast.iter_child_nodes(node):
            self.visit(child)
        self.held = outer

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        dec = _locked_by_decorator(node)
        self._enter_scope(node, frozenset({dec} if dec else ()))

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._enter_scope(node, frozenset())

    # ---- mutation detection --------------------------------------------

    def _flag(self, node: ast.AST, attr: str, what: str) -> None:
        lock = self.declared[attr]
        if lock in self.held:
            return
        self.findings.append(Finding(
            "locks", self.sf.rel, node.lineno, f"unlocked:{attr}",
            f"{what} of self.{attr} (shared under self.{lock}) outside "
            f"`with self.{lock}:` in {self.cls_name}.{self.method}"))

    def _check_target(self, t: ast.expr, what: str, node: ast.AST) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._check_target(el, what, node)
            return
        attr = _root_self_attr(t)
        if attr in self.declared:
            self._flag(node, attr, what)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_target(t, "assignment", node)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, "augmented assignment", node)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_target(node.target, "assignment", node)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._check_target(t, "del", node)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr not in _READ_METHODS:
            attr = _root_self_attr(node.func.value)
            if attr in self.declared:
                self._flag(node, attr, f"call .{node.func.attr}()")
        self.generic_visit(node)


def run(root: Path, files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    for sf in files:
        if sf.tree is None:
            continue
        for cls in [n for n in ast.walk(sf.tree) if isinstance(n, ast.ClassDef)]:
            declared = _shared_under(cls)
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            decorated = any(_locked_by_decorator(m) for m in methods)
            if not declared and not decorated:
                continue
            for m in methods:
                if m.name in _EXEMPT_METHODS:
                    continue
                dec = _locked_by_decorator(m)
                if dec is not None and declared:
                    unknown_locks = {dec} - set(declared.values())
                    if unknown_locks:
                        findings.append(Finding(
                            "locks", sf.rel, m.lineno,
                            f"locked-by-unknown:{dec}",
                            f"@locked_by({dec!r}) on {cls.name}.{m.name} "
                            f"names a lock absent from SHARED_UNDER values"))
                checker = _MethodChecker(
                    sf, cls.name, m.name, declared,
                    frozenset({dec} if dec else ()), findings)
                for child in m.body:
                    checker.visit(child)
    return findings
