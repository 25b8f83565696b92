"""Contract-drift pass.

Four cross-file contracts that have only human vigilance between
them and silent drift:

1. **Metrics** — every ``evam_*`` metric name used anywhere must be
   registered (exactly once) in ``obs.metrics.METRIC_SPECS`` and each
   call site's label keys must be a subset of the spec's label keys
   (subset, not equality: ``evam_frame_latency_seconds`` is observed
   both unlabeled and per-stream by design).
2. **Stage names** — ``engine/ringbuf.py::STAGES`` is canonical;
   ``sched/admission.py::_SERVICE_STAGES`` must be an in-order subset,
   the port's bench (``tools/bench_cuda.py``) must carry the
   service-stage literals its contract line reports, and the healthz
   golden (``tests/test_torch_server.py``) must derive from STAGES
   rather than a private copy.
3. **Bench serve-line keys** — every key
   ``tests/test_torch_bench_contract.py`` pins (set literals compared
   against the emitted JSON) must exist as a literal in the producing
   code (the bench / gate / fleet / hub / sched / ringbuf), so renaming
   a producer key without updating the pins — or vice versa — fails at
   lint time. The port's bench switches this on: while
   ``tools/bench_cuda.py`` does not exist there is no serve line, and
   the bench parts of items 1–3 report nothing.
4. **Checkpoint schema** — ``state/checkpoint.py`` persists
   ``StreamCheckpoint`` across process restarts; its dataclass fields
   must exactly match the pinned ``SCHEMA_V{SCHEMA_VERSION}_FIELDS``
   tuple. Adding/removing/reordering a field without bumping
   ``SCHEMA_VERSION`` (and pinning a new tuple) would silently change
   the wire shape old blobs decode against — fail it at lint time.
"""

from __future__ import annotations

import ast
from pathlib import Path

from .core import Finding, SourceFile

METRICS_MODULE = "evam_tpu_torch/obs/metrics.py"
RINGBUF = "evam_tpu_torch/engine/ringbuf.py"
ADMISSION = "evam_tpu_torch/sched/admission.py"
CHECKPOINT = "evam_tpu_torch/state/checkpoint.py"
#: the port's benchmark (its serve line); absent until it lands
BENCH = "tools/bench_cuda.py"

#: metrics.<method> → positional index of the labels argument
_METRIC_METHODS = {
    "inc": 2, "set": 2, "observe": 2, "time": 1,
    "get_counter": 1, "get_gauge": 1, "quantile": 2, "counter_total": None,
    "quantiles_by_label": None, "quantiles_grouped": None,
}

#: files whose string constants form the producer-key universe for the
#: bench contract pins (see module docstring, item 3)
_PRODUCER_FILES = (
    BENCH,
    "evam_tpu_torch/stages/gate.py", "evam_tpu_torch/fleet/engine.py",
    "evam_tpu_torch/engine/hub.py", "evam_tpu_torch/engine/ringbuf.py",
    "evam_tpu_torch/sched/classes.py", "evam_tpu_torch/sched/admission.py",
)

_TEST_PINS = "tests/test_torch_bench_contract.py"
_TEST_HEALTHZ = "tests/test_torch_server.py"


def _parse(root: Path, rel: str) -> ast.AST | None:
    p = root / rel
    if not p.exists():
        return None
    try:
        return ast.parse(p.read_text(encoding="utf-8"), filename=rel)
    except SyntaxError:
        return None


def _tuple_of_strings(tree: ast.AST, name: str) -> list[str] | None:
    for node in ast.walk(tree):
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                out = []
                for el in node.value.elts:
                    if not isinstance(el, ast.Constant):
                        return None
                    out.append(str(el.value))
                return out
    return None


def _string_constants(tree: ast.AST) -> set[str]:
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


# ---------------------------------------------------------------- metrics

def _metric_specs(files: list[SourceFile],
                  findings: list[Finding]) -> dict[str, set[str]]:
    """METRIC_SPECS from obs/metrics.py: name → allowed label keys."""
    specs: dict[str, set[str]] = {}
    for sf in files:
        if sf.rel != METRICS_MODULE or sf.tree is None:
            continue
        for node in sf.tree.body:
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target] if isinstance(node, ast.AnnAssign) else []
            for t in targets:
                if not (isinstance(t, ast.Name) and t.id == "METRIC_SPECS"):
                    continue
                if not isinstance(node.value, ast.Dict):
                    continue
                for k, v in zip(node.value.keys, node.value.values):
                    if not (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)):
                        continue
                    if k.value in specs:
                        findings.append(Finding(
                            "contracts", sf.rel, k.lineno,
                            f"metric-duplicate:{k.value}",
                            f"{k.value} registered twice in METRIC_SPECS"))
                    labels: set[str] = set()
                    if isinstance(v, ast.Tuple) and len(v.elts) == 2 \
                            and isinstance(v.elts[1], (ast.Tuple, ast.List)):
                        labels = {el.value for el in v.elts[1].elts
                                  if isinstance(el, ast.Constant)}
                    specs[k.value] = labels
        if not specs:
            findings.append(Finding(
                "contracts", sf.rel, 1, "metric-specs-missing",
                "obs/metrics.py must declare METRIC_SPECS "
                "(name -> (kind, label keys))"))
    return specs


class _MetricScan(ast.NodeVisitor):
    def __init__(self, rel: str, specs: dict[str, set[str]],
                 findings: list[Finding], used: set[str]):
        self.rel = rel
        self.specs = specs
        self.findings = findings
        self.used = used

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr in _METRIC_METHODS
                and isinstance(f.value, ast.Name)
                and f.value.id == "metrics"):
            return
        if not node.args:
            return
        name_node = node.args[0]
        if not (isinstance(name_node, ast.Constant)
                and isinstance(name_node.value, str)):
            self.findings.append(Finding(
                "contracts", self.rel, node.lineno, "metric-dynamic-name",
                f"metrics.{f.attr}() with a non-literal metric name; the "
                f"registry contract is checkable only for literals"))
            return
        name = name_node.value
        if not name.startswith("evam_"):
            return
        self.used.add(name)
        if name not in self.specs:
            self.findings.append(Finding(
                "contracts", self.rel, node.lineno,
                f"metric-unregistered:{name}",
                f"{name} is not registered in obs.metrics.METRIC_SPECS"))
            return
        labels_node = None
        for kw in node.keywords:
            if kw.arg == "labels":
                labels_node = kw.value
        pos = _METRIC_METHODS[f.attr]
        if labels_node is None and pos is not None and len(node.args) > pos:
            labels_node = node.args[pos]
        if isinstance(labels_node, ast.Dict):
            keys = {k.value for k in labels_node.keys
                    if isinstance(k, ast.Constant)}
            extra = keys - self.specs[name]
            if extra:
                self.findings.append(Finding(
                    "contracts", self.rel, node.lineno,
                    f"metric-labels:{name}",
                    f"{name} used with label keys {sorted(extra)} not in "
                    f"its METRIC_SPECS label set "
                    f"{sorted(self.specs[name])}"))


def _check_metrics(root: Path, files: list[SourceFile],
                   findings: list[Finding]) -> None:
    specs = _metric_specs(files, findings)
    used: set[str] = set()
    trees: list[tuple[str, ast.AST]] = [
        (sf.rel, sf.tree) for sf in files
        if sf.tree is not None and sf.rel != METRICS_MODULE]
    bench = _parse(root, BENCH)
    if bench is not None:
        trees.append((BENCH, bench))
    for rel, tree in trees:
        _MetricScan(rel, specs, findings, used).visit(tree)
    for name in sorted(set(specs) - used):
        findings.append(Finding(
            "contracts", METRICS_MODULE, 1, f"metric-unused:{name}",
            f"{name} is registered in METRIC_SPECS but never used; "
            f"drop the spec or the drift guard rots"))


# ----------------------------------------------------------------- stages

def _check_stages(root: Path, files: list[SourceFile],
                  findings: list[Finding]) -> list[str]:
    by_rel = {sf.rel: sf for sf in files}
    rb = by_rel.get(RINGBUF)
    stages = _tuple_of_strings(rb.tree, "STAGES") \
        if rb is not None and rb.tree is not None else None
    if not stages:
        findings.append(Finding(
            "contracts", RINGBUF, 1, "stages-missing",
            "engine/ringbuf.py must define the canonical STAGES tuple "
            "as a literal"))
        return []
    adm = by_rel.get(ADMISSION)
    service = _tuple_of_strings(adm.tree, "_SERVICE_STAGES") \
        if adm is not None and adm.tree is not None else None
    if not service:
        findings.append(Finding(
            "contracts", ADMISSION, 1, "service-stages-missing",
            "sched/admission.py must define _SERVICE_STAGES as a literal"))
        service = []
    # in-order subset of the canonical clock
    it = iter(stages)
    for s in service:
        for cand in it:
            if cand == s:
                break
        else:
            findings.append(Finding(
                "contracts", ADMISSION, 1, f"stage-drift:{s}",
                f"_SERVICE_STAGES entry {s!r} is not an in-order subset "
                f"of ringbuf.STAGES {tuple(stages)}"))
            break
    bench = _parse(root, BENCH)
    if bench is not None:
        consts = _string_constants(bench)
        for s in service:
            if s not in consts:
                findings.append(Finding(
                    "contracts", BENCH, 1, f"stage-drift:{s}",
                    f"service stage {s!r} does not appear in {BENCH}; "
                    f"the contract line's host-stage split drifted"))
    healthz = root / _TEST_HEALTHZ
    if healthz.exists() and "STAGES" not in healthz.read_text(encoding="utf-8"):
        findings.append(Finding(
            "contracts", _TEST_HEALTHZ, 1, "healthz-golden-copy",
            f"{_TEST_HEALTHZ} must derive the healthz stage golden "
            "from ringbuf.STAGES, not a private stage list"))
    return stages


# -------------------------------------------------------------- bench keys

def _pinned_keys(tree: ast.AST) -> dict[str, int]:
    """String keys from set literals the contract test compares against
    bench output (``{...} <= set(data)`` / ``{...} == set(d[k])``)."""
    pins: dict[str, int] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        for side in [node.left, *node.comparators]:
            if isinstance(side, ast.Set):
                for el in side.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        pins.setdefault(el.value, el.lineno)
    return pins


def _check_bench_keys(root: Path, findings: list[Finding]) -> None:
    if not (root / BENCH).exists():
        return  # no serve line yet: nothing to pin
    test = _parse(root, _TEST_PINS)
    if test is None:
        findings.append(Finding(
            "contracts", _TEST_PINS, 1, "bench-pins-missing",
            f"{_TEST_PINS} not found; the serve-line contract is "
            f"unpinned"))
        return
    universe: set[str] = set()
    for rel in _PRODUCER_FILES:
        tree = _parse(root, rel)
        if tree is not None:
            universe |= _string_constants(tree)
    for key, line in sorted(_pinned_keys(test).items()):
        if key not in universe:
            findings.append(Finding(
                "contracts", _TEST_PINS, line, f"bench-key:{key}",
                f"test pins serve-line key {key!r} but no producer "
                f"({', '.join(_PRODUCER_FILES[:3])}, …) carries that "
                f"literal — renamed on one side only?"))


# -------------------------------------------------------- ckpt schema

def _int_constant(tree: ast.AST, name: str) -> int | None:
    for node in ast.walk(tree):
        targets = node.targets if isinstance(node, ast.Assign) else \
            [node.target] if isinstance(node, ast.AnnAssign) else []
        for t in targets:
            if isinstance(t, ast.Name) and t.id == name \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, int):
                return node.value.value
    return None


def _dataclass_fields(tree: ast.AST, cls: str) -> list[str] | None:
    """Annotated field names of a dataclass, in declaration order —
    exactly what dataclasses.fields() would report."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == cls:
            return [
                st.target.id for st in node.body
                if isinstance(st, ast.AnnAssign)
                and isinstance(st.target, ast.Name)
            ]
    return None


def _check_ckpt_schema(files: list[SourceFile],
                       findings: list[Finding]) -> None:
    """StreamCheckpoint persists across restarts: its fields must match
    the pinned SCHEMA_V{N}_FIELDS tuple for the current SCHEMA_VERSION,
    so any field change forces a deliberate version bump."""
    sf = next((s for s in files if s.rel == CHECKPOINT), None)
    if sf is None or sf.tree is None:
        # no state/checkpoint.py (fixture repos, pre-EVAM_CKPT trees):
        # nothing persists, so there is no wire schema to pin —
        # deleting the module in THIS repo breaks imports loudly
        return
    version = _int_constant(sf.tree, "SCHEMA_VERSION")
    if version is None:
        findings.append(Finding(
            "contracts", CHECKPOINT, 1, "ckpt-version-missing",
            "state/checkpoint.py must define SCHEMA_VERSION as an int "
            "literal"))
        return
    fields = _dataclass_fields(sf.tree, "StreamCheckpoint")
    if not fields:
        findings.append(Finding(
            "contracts", CHECKPOINT, 1, "ckpt-fields-missing",
            "state/checkpoint.py must define the StreamCheckpoint "
            "dataclass with annotated fields"))
        return
    pinned = _tuple_of_strings(sf.tree, f"SCHEMA_V{version}_FIELDS")
    if pinned is None:
        findings.append(Finding(
            "contracts", CHECKPOINT, 1, "ckpt-pin-missing",
            f"SCHEMA_VERSION={version} has no pinned "
            f"SCHEMA_V{version}_FIELDS tuple — every schema version "
            f"pins its field tuple"))
        return
    if list(fields) != list(pinned):
        findings.append(Finding(
            "contracts", CHECKPOINT, 1, "ckpt-schema-drift",
            f"StreamCheckpoint fields {tuple(fields)} != pinned "
            f"SCHEMA_V{version}_FIELDS {tuple(pinned)} — a field "
            f"change requires bumping SCHEMA_VERSION and pinning a "
            f"new tuple (old blobs must decode against a known shape)"))


def run(root: Path, files: list[SourceFile]) -> list[Finding]:
    findings: list[Finding] = []
    _check_metrics(root, files, findings)
    _check_stages(root, files, findings)
    _check_bench_keys(root, findings)
    _check_ckpt_schema(files, findings)
    return findings
