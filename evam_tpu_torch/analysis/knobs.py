"""Knob-plumbing pass.

``EVAM_*`` knobs get re-plumbed across settings, compose, helm and
docs by hand — and the surfaces drift.  This pass derives the knob
inventory from the port's code:

- every ``EVAM_*`` string constant in ``config/settings.py``, plus
- every NON-``EVAM_`` env key registered in a ``from_env`` mapping
  dict (``RUN_MODE``, ``PY_LOG_LEVEL``, ``PROFILING_MODE``, ... —
  reference-parity keys that an ``EVAM_``-prefix match would miss),
  plus
- ``obs.faults.ENV_KEYS`` (the fault-injection env surface, exported
  programmatically so compose/helm/docs derive from one source),

and requires each key to appear (word-bounded, comments count — the
point is that an operator grepping the file finds the knob) in:

- ``deploy/docker-compose.yml``
- ``deploy/helm/values.yaml``
- ``deploy/helm/templates/evam-deployment.yaml``
- ``README.md``

It also enforces the read-side rule: no environment read of an
inventoried key (``EVAM_*`` or registered non-``EVAM_``) outside
``config/settings.py`` + ``obs/faults.py``.  Construction-time
fallbacks that tests monkeypatch are real reads — they take an
allowlist entry with a justification, they don't get a free pass.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from .core import Finding, SourceFile

SETTINGS = "evam_tpu_torch/config/settings.py"
FAULTS = "evam_tpu_torch/obs/faults.py"

SURFACES = (
    ("compose", "deploy/docker-compose.yml"),
    ("helm-values", "deploy/helm/values.yaml"),
    ("helm-template", "deploy/helm/templates/evam-deployment.yaml"),
    ("readme", "README.md"),
)

_KEY_RE = re.compile(r"^EVAM_[A-Z0-9_]+$")
#: shape of any plausible env-var name — used only for keys that sit
#: in a from_env mapping dict, so "INFO"-style defaults don't match
_ENV_KEY_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def settings_keys(files: list[SourceFile]) -> set[str]:
    """The env inventory of config/settings.py: every EVAM_* string
    constant anywhere in the file, plus every mapping-dict key — a
    dict whose values are ``(field, conv)`` tuples is a ``from_env``
    env mapping, and its non-EVAM keys (RUN_MODE, PROFILING_MODE, ...)
    are knobs too."""
    keys: set[str] = set()
    for sf in files:
        if sf.rel == SETTINGS and sf.tree is not None:
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str) \
                        and _KEY_RE.match(node.value):
                    keys.add(node.value)
                if isinstance(node, ast.Dict):
                    for k, v in zip(node.keys, node.values):
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str) \
                                and isinstance(v, ast.Tuple) \
                                and _ENV_KEY_RE.match(k.value):
                            keys.add(k.value)
    return keys


def fault_keys(files: list[SourceFile]) -> tuple[set[str], Finding | None]:
    """obs.faults.ENV_KEYS, read from the AST (the analyzer never
    imports the code it checks)."""
    for sf in files:
        if sf.rel != FAULTS or sf.tree is None:
            continue
        for node in sf.tree.body:
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target] if isinstance(node, ast.AnnAssign) else []
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "ENV_KEYS" \
                        and isinstance(node.value, (ast.Tuple, ast.List)):
                    return ({el.value for el in node.value.elts
                             if isinstance(el, ast.Constant)}, None)
        return (set(), Finding(
            "knobs", FAULTS, 1, "faults-env-keys-missing",
            "obs/faults.py must export ENV_KEYS (the programmatic "
            "fault-injection env surface)"))
    return (set(), None)


class _EnvReadScan(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, findings: list[Finding],
                 registered: set[str] = frozenset()):
        self.sf = sf
        self.findings = findings
        #: the full knob inventory — reads of a REGISTERED non-EVAM
        #: key (PY_LOG_LEVEL, DEV_MODE, ...) are in scope even though
        #: the key lacks the EVAM_ prefix
        self.registered = registered

    def _dotted(self, node: ast.expr) -> str:
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
        return ".".join(reversed(parts))

    def _flag(self, node: ast.AST, key_node: ast.expr | None) -> None:
        if isinstance(key_node, ast.Constant) and isinstance(key_node.value, str):
            if not _KEY_RE.match(key_node.value) \
                    and key_node.value not in self.registered:
                return  # unregistered non-EVAM key: out of scope
            ident, what = f"env-read:{key_node.value}", key_node.value
        else:
            ident, what = "env-read:dynamic", "a non-literal key"
        self.findings.append(Finding(
            "knobs", self.sf.rel, node.lineno, ident,
            f"environment read of {what} outside config/settings.py + "
            f"obs/faults.py; route it through get_settings() or "
            f"allowlist with a justification"))

    def visit_Call(self, node: ast.Call) -> None:
        name = self._dotted(node.func)
        if name.endswith("environ.get") or name.endswith("environ.setdefault") \
                or name in ("os.getenv", "getenv"):
            self._flag(node, node.args[0] if node.args else None)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if isinstance(node.ctx, ast.Load) \
                and self._dotted(node.value).endswith("environ"):
            self._flag(node, node.slice)
        self.generic_visit(node)


def run(root: Path, files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []

    keys = settings_keys(files)
    fkeys, missing = fault_keys(files)
    if missing is not None:
        findings.append(missing)
    if not keys:
        findings.append(Finding(
            "knobs", SETTINGS, 1, "no-settings-keys",
            "could not extract any EVAM_* keys from config/settings.py"))
        return findings

    for short, rel in SURFACES:
        path = root / rel
        if not path.exists():
            findings.append(Finding(
                "knobs", rel, 1, "surface-missing",
                f"deploy/doc surface {rel} does not exist"))
            continue
        text = path.read_text(encoding="utf-8", errors="replace")
        for key in sorted(keys | fkeys):
            if not re.search(re.escape(key) + r"(?![A-Z0-9_])", text):
                findings.append(Finding(
                    "knobs", rel, 1, f"unplumbed:{key}:{short}",
                    f"{key} is part of the settings/faults env surface "
                    f"but absent from {rel}"))

    for sf in files:
        if sf.tree is None or sf.rel in (SETTINGS, FAULTS):
            continue
        _EnvReadScan(sf, findings, registered=keys | fkeys).visit(sf.tree)
    return findings
