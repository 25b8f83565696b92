"""Shared plumbing for the evamlint passes: findings, the allowlist,
repo walking, and the function that runs the passes."""

from __future__ import annotations

import ast
import dataclasses
import json
import tomllib
from pathlib import Path
from typing import Iterable

PASS_IDS = ("locks", "hotloop", "knobs", "contracts", "imports")

#: the package the passes walk and check
PACKAGE = "evam_tpu_torch"


def is_package_module(name: str) -> bool:
    """True for ``evam_tpu_torch`` and its submodules — matched exactly,
    since ``evam_tpu`` (the reference) is a prefix of the name."""
    return name == PACKAGE or name.startswith(PACKAGE + ".")


def repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location.

    ``ident`` is the stable allowlist key: it names *what* is wrong
    ("env-read:EVAM_NMS"), never *where* by line number, so entries
    survive unrelated edits to the file.
    """

    pass_id: str
    file: str          # repo-relative, forward slashes
    line: int
    ident: str
    message: str

    def location(self) -> str:
        return f"{self.file}:{self.line}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class AllowlistError(RuntimeError):
    """Malformed allowlist — always fatal, never a finding."""


def _parse_toml(text: str, path: str) -> dict:
    try:
        return tomllib.loads(text)
    except tomllib.TOMLDecodeError as exc:
        raise AllowlistError(f"{path}: not valid TOML: {exc}") from None


class Allowlist:
    """``analysis/allowlist.toml``: one ``[[allow]]`` table per
    suppression, each carrying a mandatory written justification::

        [[allow]]
        pass = "knobs"
        file = "evam_tpu_torch/ops/nms.py"
        ident = "env-read:EVAM_NMS"
        justification = "kernel-variant A/B knob, read at import"

    ``file`` is optional (omit to match the ident anywhere).  Entries
    that match no finding are reported as stale.
    """

    def __init__(self, entries: list[dict], path: str = "<memory>"):
        self.entries = entries
        self.path = path
        self._hits = [0] * len(entries)
        for i, e in enumerate(entries):
            where = f"{path} entry #{i + 1}"
            if e.get("pass") not in PASS_IDS:
                raise AllowlistError(
                    f"{where}: 'pass' must be one of {PASS_IDS}, got "
                    f"{e.get('pass')!r}")
            if not e.get("ident"):
                raise AllowlistError(f"{where}: missing 'ident'")
            if not str(e.get("justification", "")).strip():
                raise AllowlistError(
                    f"{where}: every suppression needs a written "
                    f"'justification'")

    @classmethod
    def load(cls, path: Path) -> "Allowlist":
        if not path.exists():
            return cls([], str(path))
        data = _parse_toml(path.read_text(encoding="utf-8"), str(path))
        entries = data.get("allow", [])
        if not isinstance(entries, list):
            raise AllowlistError(f"{path}: 'allow' must be an array of tables")
        return cls(list(entries), str(path))

    def matches(self, f: Finding) -> bool:
        for i, e in enumerate(self.entries):
            if e["pass"] != f.pass_id:
                continue
            if e.get("file") and e["file"] != f.file:
                continue
            if e["ident"] != f.ident:
                continue
            self._hits[i] += 1
            return True
        return False

    def stale_entries(self) -> list[dict]:
        return [e for e, n in zip(self.entries, self._hits) if n == 0]


class SourceFile:
    """A parsed repo file: path, text, and (for .py) the AST."""

    def __init__(self, root: Path, path: Path):
        self.abs = path
        self.rel = path.relative_to(root).as_posix()
        self.text = path.read_text(encoding="utf-8", errors="replace")
        self.tree: ast.AST | None = None
        if path.suffix == ".py":
            try:
                self.tree = ast.parse(self.text, filename=self.rel)
            except SyntaxError:
                self.tree = None  # the syntax-error finding comes from run_passes


def iter_package_files(root: Path) -> list[SourceFile]:
    """Every .py under evam_tpu_torch/ (the analysis package included —
    the linter lints itself)."""
    out = []
    for p in sorted((root / PACKAGE).rglob("*.py")):
        out.append(SourceFile(root, p))
    return out


def run_passes(root: Path | None = None,
               passes: Iterable[str] | None = None) -> list[Finding]:
    """Run the selected passes over the repo; returns raw findings
    (allowlist not yet applied)."""
    from . import locks, hotloop, knobs, contracts, imports_

    root = root or repo_root()
    selected = tuple(passes) if passes else PASS_IDS
    for p in selected:
        if p not in PASS_IDS:
            raise ValueError(f"unknown pass {p!r}; valid: {PASS_IDS}")

    files = iter_package_files(root)
    findings: list[Finding] = []
    for sf in files:
        if sf.tree is None:
            findings.append(Finding(
                "imports", sf.rel, 1, "syntax-error",
                "file does not parse; all passes skipped it"))
    runners = {
        "locks": locks.run,
        "hotloop": hotloop.run,
        "knobs": knobs.run,
        "contracts": contracts.run,
        "imports": imports_.run,
    }
    for p in selected:
        findings.extend(runners[p](root, files))
    findings.sort(key=lambda f: (f.file, f.line, f.pass_id, f.ident))
    return findings


def report_json(findings: list[Finding], allowed: list[Finding],
                stale: list[dict]) -> str:
    return json.dumps({
        "tool": "evamlint",
        "counts": {
            "findings": len(findings),
            "allowlisted": len(allowed),
            "stale_allowlist_entries": len(stale),
        },
        "findings": [f.as_dict() for f in findings],
        "allowlisted": [f.as_dict() for f in allowed],
        "stale_allowlist_entries": stale,
    }, indent=2, sort_keys=True)
