"""evamlint over the port (``evam_tpu_torch/analysis``) — every case of
``tests/test_analysis.py`` against the port's analyzer, parity with the
reference's analyzer, and the port's own repo gates.

* Per-rule fixtures: each pass gets a violating tree (the finding lands
  with the right pass id, ident and file:line) and a clean twin.
* Parity: the same synthetic tree goes through the reference's
  ``evam_tpu.analysis.run_passes`` (laid out under ``evam_tpu/``) and
  the port's (under ``evam_tpu_torch/``); the findings, as ``(pass,
  path inside the package, line, ident)``, are equal exactly. Files
  outside the package map onto the port's names: ``bench.py`` →
  ``tools/bench_cuda.py``, ``tests/test_server.py`` →
  ``tests/test_torch_server.py``, ``tests/test_bench_contract.py`` →
  ``tests/test_torch_bench_contract.py``.
* Repo gates: ``python -m evam_tpu_torch.analysis`` exits 0 on the tree
  with 0 findings and 0 stale entries; the lock section of the
  allowlist is empty; every ``SHARED_UNDER`` map and ``@locked_by`` of
  the reference sits on its counterpart in the port (read from the
  reference's source with ``ast``, never imported).
"""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from evam_tpu import analysis as ref_analysis
from evam_tpu_torch.analysis import __main__ as cli
from evam_tpu_torch.analysis import contracts, hotloop, imports_, knobs, locks
from evam_tpu_torch.analysis.annotations import locked_by
from evam_tpu_torch.analysis.core import (Allowlist, AllowlistError,
                                          iter_package_files, repo_root,
                                          run_passes)

torch.set_num_threads(1)

REPO = repo_root()
PKG = "evam_tpu_torch"


def make_tree(root: Path, files: dict[str, str]) -> list:
    """Write a fixture repo under ``root`` and parse its package files."""
    for rel, text in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text), encoding="utf-8")
    return iter_package_files(root)


# ------------------------------------------------------------------ locks

LOCKY = """
    import threading

    class Engine:
        SHARED_UNDER = {"stats": "_lock", "_pending": "_lock"}

        def __init__(self):
            self._lock = threading.Lock()
            self.stats = 0
            self._pending = []
"""


def test_locks_flags_unlocked_mutation(tmp_path):
    files = make_tree(tmp_path, {"evam_tpu_torch/eng.py": LOCKY + """
        def bad(self):
            self.stats += 1
    """})
    found = locks.run(tmp_path, files)
    assert len(found) == 1
    f = found[0]
    assert (f.pass_id, f.ident) == ("locks", "unlocked:stats")
    assert f.file == "evam_tpu_torch/eng.py"
    # the += is the last line of the fixture
    assert f.line == len((tmp_path / "evam_tpu_torch/eng.py")
                         .read_text().splitlines())


def test_locks_receiver_method_is_mutation(tmp_path):
    files = make_tree(tmp_path, {"evam_tpu_torch/eng.py": LOCKY + """
        def bad(self):
            self._pending.append(1)

        def read_ok(self):
            return list(self._pending)
    """})
    idents = {f.ident for f in locks.run(tmp_path, files)}
    assert idents == {"unlocked:_pending"}  # .append flagged, read not


def test_locks_clean_under_with(tmp_path):
    files = make_tree(tmp_path, {"evam_tpu_torch/eng.py": LOCKY + """
        def good(self):
            with self._lock:
                self.stats += 1
                self._pending.append(1)
    """})
    assert locks.run(tmp_path, files) == []


def test_locks_locked_by_decorator(tmp_path):
    files = make_tree(tmp_path, {"evam_tpu_torch/eng.py": """
        import threading
        from evam_tpu_torch.analysis.annotations import locked_by

        class Engine:
            SHARED_UNDER = {"stats": "_lock"}

            def __init__(self):
                self._lock = threading.Lock()
                self.stats = 0

            @locked_by("_lock")
            def callers_hold(self):
                self.stats += 1
    """})
    assert locks.run(tmp_path, files) == []


def test_locks_locked_by_unknown_lock(tmp_path):
    files = make_tree(tmp_path, {"evam_tpu_torch/eng.py": """
        from evam_tpu_torch.analysis.annotations import locked_by

        class Engine:
            SHARED_UNDER = {"stats": "_lock"}

            @locked_by("_other")
            def callers_hold(self):
                self.stats += 1
    """})
    idents = {f.ident for f in locks.run(tmp_path, files)}
    assert any(i.startswith("locked-by-unknown:") for i in idents)


def test_locks_nested_def_escapes_lock(tmp_path):
    # a nested function runs later on an arbitrary thread: the lexical
    # `with` above it must NOT count as holding the lock
    files = make_tree(tmp_path, {"evam_tpu_torch/eng.py": LOCKY + """
        def sneaky(self):
            with self._lock:
                def cb():
                    self.stats += 1
                return cb
    """})
    assert {f.ident for f in locks.run(tmp_path, files)} \
        == {"unlocked:stats"}


def test_locked_by_is_runtime_noop():
    @locked_by("_lock")
    def fn():
        return 41 + 1

    assert fn() == 42 and fn.__locked_by__ == "_lock"


# ---------------------------------------------------------------- hotloop

def test_hotloop_flags_env_read_in_loop(tmp_path):
    files = make_tree(tmp_path, {"evam_tpu_torch/engine/batcher.py": """
        import os

        class BatchEngine:
            def _dispatch_loop(self):
                while True:
                    v = os.environ.get("EVAM_X")
    """})
    found = hotloop.run(tmp_path, files)
    assert len(found) == 1
    f = found[0]
    assert f.pass_id == "hotloop" and f.ident == "hotloop:os.environ"
    assert f.file == "evam_tpu_torch/engine/batcher.py" and f.line == 7


def test_hotloop_read_before_loop_is_clean(tmp_path):
    files = make_tree(tmp_path, {"evam_tpu_torch/engine/batcher.py": """
        import os

        class BatchEngine:
            def _dispatch_loop(self):
                v = os.environ.get("EVAM_X")
                while True:
                    use(v)
    """})
    assert hotloop.run(tmp_path, files) == []


def test_hotloop_propagates_through_calls(tmp_path):
    # loop -> self.method -> module fn -> time.sleep: still hot
    files = make_tree(tmp_path, {"evam_tpu_torch/engine/batcher.py": """
        import time

        def helper():
            time.sleep(1)

        class BatchEngine:
            def _step(self):
                helper()

            def _completion_loop(self):
                while True:
                    self._step()
    """})
    found = hotloop.run(tmp_path, files)
    assert [(f.ident, f.line) for f in found] == [("hotloop:time.sleep", 5)]


def test_hotloop_non_entry_class_ignored(tmp_path):
    files = make_tree(tmp_path, {"evam_tpu_torch/engine/batcher.py": """
        import os

        class NotAnEngine:
            def _dispatch_loop(self):
                while True:
                    os.environ.get("EVAM_X")
    """})
    assert hotloop.run(tmp_path, files) == []


# ------------------------------------------------------------------ knobs

KNOB_SETTINGS = """
    MAPPING = {"EVAM_FOO": ("foo", str)}
"""
KNOB_FAULTS = """
    ENV_KEYS = ("EVAM_FAULT_INJECT",)
"""


def knob_tree(tmp_path, surfaces_text: str, extra: dict | None = None):
    files = {
        "evam_tpu_torch/config/settings.py": KNOB_SETTINGS,
        "evam_tpu_torch/obs/faults.py": KNOB_FAULTS,
        "deploy/docker-compose.yml": surfaces_text,
        "deploy/helm/values.yaml": surfaces_text,
        "deploy/helm/templates/evam-deployment.yaml": surfaces_text,
        "README.md": surfaces_text,
    }
    files.update(extra or {})
    return make_tree(tmp_path, files)


def test_knobs_unplumbed_key(tmp_path):
    files = knob_tree(tmp_path, "EVAM_FAULT_INJECT only\n")
    found = knobs.run(tmp_path, files)
    # EVAM_FOO missing from each of the four surfaces
    assert sorted(f.ident for f in found) == [
        "unplumbed:EVAM_FOO:compose",
        "unplumbed:EVAM_FOO:helm-template",
        "unplumbed:EVAM_FOO:helm-values",
        "unplumbed:EVAM_FOO:readme",
    ]


def test_knobs_word_boundary(tmp_path):
    # EVAM_FOO_BAR does not satisfy EVAM_FOO
    files = knob_tree(tmp_path, "EVAM_FOO_BAR EVAM_FAULT_INJECT\n")
    found = knobs.run(tmp_path, files)
    assert {f.ident for f in found} == {
        f"unplumbed:EVAM_FOO:{s}"
        for s in ("compose", "helm-values", "helm-template", "readme")}


def test_knobs_env_read_outside_settings(tmp_path):
    files = knob_tree(
        tmp_path, "EVAM_FOO EVAM_FAULT_INJECT\n",
        extra={"evam_tpu_torch/rogue.py": """
            import os
            MODE = os.environ.get("EVAM_MODE", "off")
            DYN = os.getenv("EVAM_" + "X")
        """})
    found = [f for f in knobs.run(tmp_path, files)
             if f.file == "evam_tpu_torch/rogue.py"]
    assert {(f.ident, f.line) for f in found} == {
        ("env-read:EVAM_MODE", 3), ("env-read:dynamic", 4)}


def test_knobs_faults_must_export_env_keys(tmp_path):
    files = knob_tree(tmp_path, "EVAM_FOO EVAM_FAULT_INJECT\n")
    # overwrite faults.py without ENV_KEYS
    (tmp_path / "evam_tpu_torch/obs/faults.py").write_text("KEYS = 1\n")
    files = iter_package_files(tmp_path)
    idents = {f.ident for f in knobs.run(tmp_path, files)}
    assert "faults-env-keys-missing" in idents


def test_knobs_clean(tmp_path):
    files = knob_tree(tmp_path, "EVAM_FOO and EVAM_FAULT_INJECT doc\n")
    assert knobs.run(tmp_path, files) == []


# -------------------------------------------------------------- contracts

CONTRACT_BASE = {
    "evam_tpu_torch/obs/metrics.py": """
        METRIC_SPECS = {
            "evam_things": ("counter", ("engine",)),
        }
    """,
    "evam_tpu_torch/engine/ringbuf.py": """
        STAGES = ("preprocess", "infer", "publish")
    """,
    "evam_tpu_torch/sched/admission.py": """
        _SERVICE_STAGES = ("preprocess", "infer")
    """,
    "tools/bench_cuda.py": """
        KEYS = ("preprocess", "infer", "streams_per_chip")
    """,
    "tests/test_torch_server.py": """
        from evam_tpu_torch.engine.ringbuf import STAGES
    """,
    "tests/test_torch_bench_contract.py": """
        def test_line(data):
            assert {"streams_per_chip"} <= set(data)
    """,
}

USER_OK = """
    from evam_tpu_torch.obs.metrics import metrics
    metrics.inc("evam_things", labels={"engine": "a"})
"""


def contract_tree(tmp_path, **overrides):
    files = dict(CONTRACT_BASE)
    files.update(overrides)
    return make_tree(tmp_path, files)


def test_contracts_clean(tmp_path):
    files = contract_tree(tmp_path, **{"evam_tpu_torch/user.py": USER_OK})
    assert contracts.run(tmp_path, files) == []


def test_contracts_unregistered_metric(tmp_path):
    files = contract_tree(
        tmp_path,
        **{"evam_tpu_torch/user.py": """
            from evam_tpu_torch.obs.metrics import metrics
            metrics.inc("evam_things")
            metrics.inc("evam_ghost")
        """})
    found = contracts.run(tmp_path, files)
    assert [(f.ident, f.file, f.line) for f in found] == [
        ("metric-unregistered:evam_ghost", "evam_tpu_torch/user.py", 4)]


def test_contracts_label_drift(tmp_path):
    files = contract_tree(
        tmp_path,
        **{"evam_tpu_torch/user.py": """
            from evam_tpu_torch.obs.metrics import metrics
            metrics.inc("evam_things", labels={"stream": "s"})
        """})
    idents = {f.ident for f in contracts.run(tmp_path, files)}
    assert idents == {"metric-labels:evam_things"}


def test_contracts_unused_spec(tmp_path):
    files = contract_tree(tmp_path)  # registered but never used
    idents = {f.ident for f in contracts.run(tmp_path, files)}
    assert idents == {"metric-unused:evam_things"}


def test_contracts_stage_order_drift(tmp_path):
    files = contract_tree(
        tmp_path,
        **{"evam_tpu_torch/user.py": USER_OK,
           "evam_tpu_torch/sched/admission.py": """
            _SERVICE_STAGES = ("infer", "preprocess")
        """})
    idents = {f.ident for f in contracts.run(tmp_path, files)}
    assert "stage-drift:preprocess" in idents


def test_contracts_bench_pin_without_producer(tmp_path):
    files = contract_tree(
        tmp_path,
        **{"evam_tpu_torch/user.py": USER_OK,
           "tests/test_torch_bench_contract.py": """
            def test_line(data):
                assert {"renamed_key"} <= set(data)
        """})
    found = [f for f in contracts.run(tmp_path, files)
             if f.ident.startswith("bench-key:")]
    assert [(f.ident, f.file) for f in found] == [
        ("bench-key:renamed_key", "tests/test_torch_bench_contract.py")]


_CKPT_OK = """
    SCHEMA_VERSION = 1
    SCHEMA_V1_FIELDS = ("stream_id", "stages")

    class StreamCheckpoint:
        stream_id: str
        stages: dict
"""


def test_contracts_ckpt_schema_pinned_is_clean(tmp_path):
    files = contract_tree(
        tmp_path,
        **{"evam_tpu_torch/user.py": USER_OK,
           "evam_tpu_torch/state/checkpoint.py": _CKPT_OK})
    assert contracts.run(tmp_path, files) == []


def test_contracts_ckpt_field_change_without_bump_is_drift(tmp_path):
    files = contract_tree(
        tmp_path,
        **{"evam_tpu_torch/user.py": USER_OK,
           "evam_tpu_torch/state/checkpoint.py": """
            SCHEMA_VERSION = 1
            SCHEMA_V1_FIELDS = ("stream_id", "stages")

            class StreamCheckpoint:
                stream_id: str
                frame_seq: int
                stages: dict
        """})
    idents = {f.ident for f in contracts.run(tmp_path, files)}
    assert idents == {"ckpt-schema-drift"}


def test_contracts_ckpt_bump_without_new_pin_flagged(tmp_path):
    files = contract_tree(
        tmp_path,
        **{"evam_tpu_torch/user.py": USER_OK,
           "evam_tpu_torch/state/checkpoint.py": """
            SCHEMA_VERSION = 2
            SCHEMA_V1_FIELDS = ("stream_id", "stages")

            class StreamCheckpoint:
                stream_id: str
                stages: dict
        """})
    idents = {f.ident for f in contracts.run(tmp_path, files)}
    assert idents == {"ckpt-pin-missing"}


def test_contracts_repo_checkpoint_matches_live_dataclass():
    """The AST field walk must agree with dataclasses.fields() on the
    port's real module — the pin is only as strong as that equivalence."""
    import dataclasses

    from evam_tpu_torch.state import checkpoint as ck_mod

    live = [f.name for f in dataclasses.fields(ck_mod.StreamCheckpoint)]
    assert tuple(live) == ck_mod.SCHEMA_V1_FIELDS
    assert ck_mod.SCHEMA_VERSION == 1
    files = iter_package_files(REPO)
    sf = next(s for s in files if s.rel == contracts.CHECKPOINT)
    assert contracts._dataclass_fields(sf.tree, "StreamCheckpoint") == live


def test_contracts_bench_parts_wait_for_the_ports_bench(tmp_path):
    """Until ``tools/bench_cuda.py`` exists the port has no serve line:
    no pins are read (not even the reference's), and nothing is
    reported for them; with the bench, a missing pin file is a finding."""
    base = {k: v for k, v in CONTRACT_BASE.items()
            if not k.startswith(("tools/", "tests/test_torch_bench"))}
    base["evam_tpu_torch/user.py"] = USER_OK
    base["bench.py"] = 'KEYS = ("unrelated",)\n'
    base["tests/test_bench_contract.py"] = CONTRACT_BASE[
        "tests/test_torch_bench_contract.py"].replace(
            "streams_per_chip", "renamed_key")
    files = make_tree(tmp_path, base)
    assert contracts.run(tmp_path, files) == []
    files = make_tree(tmp_path, {"tools/bench_cuda.py": CONTRACT_BASE[
        "tools/bench_cuda.py"]})
    assert [(f.ident, f.file) for f in contracts.run(tmp_path, files)] == [
        ("bench-pins-missing", "tests/test_torch_bench_contract.py")]


# ---------------------------------------------------------------- imports

def test_imports_cycle_detected(tmp_path):
    files = make_tree(tmp_path, {
        "evam_tpu_torch/__init__.py": "",
        "evam_tpu_torch/a.py": "from evam_tpu_torch import b\n",
        "evam_tpu_torch/b.py": "from evam_tpu_torch import a\n",
    })
    found = imports_.run(tmp_path, files)
    assert len(found) == 1
    assert found[0].ident == \
        "import-cycle:evam_tpu_torch/a.py+evam_tpu_torch/b.py"


def test_imports_deferred_import_breaks_cycle(tmp_path):
    files = make_tree(tmp_path, {
        "evam_tpu_torch/__init__.py": "",
        "evam_tpu_torch/a.py": "from evam_tpu_torch import b\n",
        "evam_tpu_torch/b.py": """
            def late():
                from evam_tpu_torch import a
                return a
        """,
    })
    assert imports_.run(tmp_path, files) == []


def test_imports_submodule_import_not_a_package_edge(tmp_path):
    # `from evam_tpu_torch import a` in __init__ + `from evam_tpu_torch
    # import b` in a: binding a submodule name doesn't require the
    # package __init__ body, so this is NOT a cycle
    files = make_tree(tmp_path, {
        "evam_tpu_torch/__init__.py": "from evam_tpu_torch import a\n",
        "evam_tpu_torch/a.py": "from evam_tpu_torch import b\n",
        "evam_tpu_torch/b.py": "",
    })
    assert imports_.run(tmp_path, files) == []


def test_imports_match_the_package_name_exactly(tmp_path):
    """``evam_tpu`` is a prefix of ``evam_tpu_torch``: an import of the
    reference is no edge of the port's graph."""
    files = make_tree(tmp_path, {
        "evam_tpu_torch/__init__.py": "",
        "evam_tpu_torch/a.py": "import evam_tpu.b\nfrom evam_tpu import b\n",
        "evam_tpu_torch/b.py": "from evam_tpu_torch import a\n",
    })
    assert imports_.run(tmp_path, files) == []


# -------------------------------------------------------------- allowlist

def test_allowlist_requires_justification(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\npass = "locks"\nident = "unlocked:x"\n')
    with pytest.raises(AllowlistError):
        Allowlist.load(p)


def test_allowlist_rejects_unknown_pass(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\npass = "nope"\nident = "x"\n'
                 'justification = "y"\n')
    with pytest.raises(AllowlistError):
        Allowlist.load(p)


def test_allowlist_stale_entry_reported(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]]\npass = "knobs"\nident = "env-read:EVAM_GONE"\n'
                 'justification = "long since fixed"\n')
    allow = Allowlist.load(p)
    assert allow.stale_entries() == allow.entries


def test_allowlist_bad_toml_is_a_malfunction(tmp_path):
    p = tmp_path / "allow.toml"
    p.write_text('[[allow]\npass = \n')
    with pytest.raises(AllowlistError):
        Allowlist.load(p)
    assert cli.main(["--allowlist", str(p)]) == 2


# ------------------------------------------------------------- repo smoke

def test_repo_is_clean_end_to_end(tmp_path):
    """The gate's exact contract: full run, real allowlist, exit 0."""
    report = tmp_path / "report.json"
    assert cli.main(["--json", str(report)]) == 0
    data = json.loads(report.read_text())
    assert data["counts"]["findings"] == 0
    assert data["counts"]["stale_allowlist_entries"] == 0
    assert data["counts"]["allowlisted"] > 0  # documented suppressions


def test_module_entry_point_is_clean_and_imports_nothing_heavy():
    """``python -m evam_tpu_torch.analysis --json -`` exits 0 with 0
    findings and 0 stale entries, and the analyzer loads no torch, no
    jax and nothing of the reference."""
    res = subprocess.run(
        [sys.executable, "-m", "evam_tpu_torch.analysis", "--json", "-"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    counts = json.loads(res.stdout)["counts"]
    assert counts["findings"] == 0 and counts["stale_allowlist_entries"] == 0
    probe = (
        "import sys\n"
        "from evam_tpu_torch.analysis.__main__ import main\n"
        "rc = main(['--json', os.devnull])\n"
        "heavy = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'numpy', 'evam_tpu'))\n"
        "print(rc, heavy)\n")
    res = subprocess.run([sys.executable, "-c", "import os\n" + probe],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert res.stdout.split("\n")[-2] == "0 []", res.stdout + res.stderr


def test_cli_exit_codes_on_a_fixture_repo(tmp_path):
    """1 for a finding, 1 for a stale entry, 0 once both are gone."""
    make_tree(tmp_path, {"evam_tpu_torch/eng.py": LOCKY + """
        def bad(self):
            self.stats += 1
    """})
    empty = tmp_path / "empty.toml"
    empty.write_text("")
    args = ["--root", str(tmp_path), "--passes", "locks",
            "--allowlist", str(empty)]
    assert cli.main(args) == 1
    (tmp_path / "evam_tpu_torch/eng.py").write_text(textwrap.dedent(LOCKY))
    assert cli.main(args) == 0
    stale = tmp_path / "stale.toml"
    stale.write_text('[[allow]]\npass = "locks"\nident = "unlocked:x"\n'
                     'justification = "gone"\n')
    assert cli.main(args[:-1] + [str(stale)]) == 1
    assert cli.main(["--root", str(tmp_path), "--pass", "locks",
                     "--allowlist", str(empty)]) == 0


def test_lock_allowlist_is_empty():
    """Policy: every lock-discipline finding gets fixed, never
    suppressed."""
    allow = Allowlist.load(cli.ALLOWLIST)
    assert [e for e in allow.entries if e["pass"] == "locks"] == []


def test_allowlist_entries_stand_on_the_reference_or_the_roadmap():
    """Every entry has a justification; a knobs or hotloop entry names
    the reference's entry (or the reference's allowlisted read) it
    stands on, and a contracts entry the ROADMAP item."""
    ref_allow = Allowlist.load(REPO / "evam_tpu/analysis/allowlist.toml")
    ref_keys = {(e["file"], e["ident"]) for e in ref_allow.entries}
    for e in Allowlist.load(cli.ALLOWLIST).entries:
        just = e["justification"]
        if e["pass"] == "contracts":
            assert "ROADMAP" in just, e
            continue
        m = re.search(r"entry (evam_tpu/\S+) (\S+?)(?=:?\s|:?$)", just)
        assert m, e
        assert (m.group(1), m.group(2)) in ref_keys, e
        if e["ident"].startswith(("env-read:", "hotloop:")):
            # the same entry, for the counterpart file
            assert (m.group(1), m.group(2)) == (
                e["file"].replace("evam_tpu_torch/", "evam_tpu/", 1),
                e["ident"]), e


def test_repo_locks_and_imports_clean_without_allowlist():
    """The two fix-don't-suppress passes hold with NO allowlist at all."""
    assert run_passes(REPO, ("locks", "imports")) == []


def test_knob_inventory_covers_fault_keys():
    files = iter_package_files(REPO)
    fkeys, missing = knobs.fault_keys(files)
    assert missing is None
    assert fkeys == {"EVAM_FAULT_INJECT", "EVAM_FAULT_SEED"}
    assert len(knobs.settings_keys(files)) >= 30


def test_every_inventoried_key_is_in_the_readme():
    files = iter_package_files(REPO)
    text = (REPO / "README.md").read_text(encoding="utf-8")
    keys = knobs.settings_keys(files) | knobs.fault_keys(files)[0]
    assert [k for k in sorted(keys)
            if not re.search(re.escape(k) + r"(?![A-Z0-9_])", text)] == []


def test_cli_unknown_pass_is_internal_error():
    assert cli.main(["--passes", "bogus"]) == 2


def test_cli_pass_subset_skips_foreign_stale_entries():
    # knobs/hotloop allowlist entries must not read as stale when only
    # the locks+imports passes run
    assert cli.main(["--passes", "locks,imports"]) == 0


# ------------------------------------------ lock maps against the reference

#: reference SHARED_UNDER entries the port leaves out: the port's engine
#: keeps no per-bucket AOT executable (``_aot_exec``): its per-bucket
#: object is a CUDA graph, which cannot be stored, and the AOT store
#: holds the kernels' libraries (``ops/kernels.py``) instead
EXCLUDED = {("engine/batcher.py", "BatchEngine"): {"_aot_exec"}}


def _class_maps(pkg: str) -> dict[tuple[str, str], dict]:
    out = {}
    for p in sorted((REPO / pkg).rglob("*.py")):
        rel = p.relative_to(REPO / pkg).as_posix()
        if rel.startswith("analysis/"):
            continue
        for cls in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            if not isinstance(cls, ast.ClassDef):
                continue
            shared = locks._shared_under(cls)
            held = {m.name: locks._locked_by_decorator(m) for m in cls.body
                    if isinstance(m, ast.FunctionDef)
                    and locks._locked_by_decorator(m)}
            if shared or held:
                out[(rel, cls.name)] = {"shared": shared, "locked_by": held}
    return out


def test_every_reference_lock_map_has_its_counterpart():
    ref, port = _class_maps("evam_tpu"), _class_maps(PKG)
    assert len(ref) >= 14
    for key, want in ref.items():
        if key in EXCLUDED and EXCLUDED[key] is None:
            assert key not in port
            continue
        drop = EXCLUDED.get(key) or set()
        assert key in port, key
        assert port[key]["shared"] == {
            k: v for k, v in want["shared"].items() if k not in drop}, key
        assert port[key]["locked_by"] == want["locked_by"], key
    assert set(port) <= set(ref)


def test_locked_by_methods_carry_the_marker():
    from evam_tpu_torch.engine.supervisor import SupervisedEngine
    from evam_tpu_torch.publish.file_dest import FileDestination

    assert SupervisedEngine._set_state.__locked_by__ == "_lock"
    assert FileDestination._drop.__locked_by__ == "_lock"


# ------------------------------------------------ parity with the reference

#: reference paths outside the package → the port's
_OUTSIDE = {"bench.py": "tools/bench_cuda.py",
            "tests/test_server.py": "tests/test_torch_server.py",
            "tests/test_bench_contract.py":
                "tests/test_torch_bench_contract.py"}

_P = "PKG"  # package placeholder in the parity fixtures

_PARITY_LOCKY = LOCKY.replace(
    "import threading",
    "import threading\n    from PKG.analysis.annotations import locked_by")
_KNOB_SURFACES = {
    "deploy/docker-compose.yml": "EVAM_FOO EVAM_FAULT_INJECT\n",
    "deploy/helm/values.yaml": "EVAM_FAULT_INJECT\n",
    "deploy/helm/templates/evam-deployment.yaml": "EVAM_FOO_BAR\n",
    "README.md": "EVAM_FOO EVAM_FAULT_INJECT RUN_MODE\n",
    "PKG/config/settings.py": """
        MAPPING = {"EVAM_FOO": ("foo", str), "RUN_MODE": ("mode", str)}
        DEFAULTS = {"LEVEL": "INFO"}
    """,
    "PKG/obs/faults.py": 'ENV_KEYS = ("EVAM_FAULT_INJECT",)\n',
}
_REF_CONTRACTS = {
    "PKG/obs/metrics.py": """
        METRIC_SPECS = {
            "evam_things": ("counter", ("engine",)),
            "evam_twice": ("gauge", ()),
            "evam_twice": ("gauge", ()),
            "evam_idle": ("gauge", ()),
        }
    """,
    "PKG/engine/ringbuf.py": 'STAGES = ("preprocess", "infer", "publish")\n',
    "PKG/sched/admission.py": '_SERVICE_STAGES = ("infer", "preprocess")\n',
    "bench.py": 'KEYS = ("infer", "streams_per_chip")\n',
    "tests/test_server.py": 'GOLDEN = ("preprocess", "infer")\n',
    "tests/test_bench_contract.py": """
        def test_line(data):
            assert {"streams_per_chip", "renamed_key"} <= set(data)
    """,
    "PKG/user.py": """
        from PKG.obs.metrics import metrics
        metrics.inc("evam_things", labels={"stream": "s"})
        metrics.set("evam_twice", 1.0)
        metrics.observe("evam_ghost", 1.0)
        metrics.inc(NAME)
    """,
    "PKG/state/checkpoint.py": """
        SCHEMA_VERSION = 1
        SCHEMA_V1_FIELDS = ("stream_id", "stages")

        class StreamCheckpoint:
            stream_id: str
            frame_seq: int
            stages: dict
    """,
}

PARITY = {
    "locks": {"PKG/eng.py": _PARITY_LOCKY + """
        def bad(self):
            self.stats += 1
            self._pending.append(1)
            del self._pending[0]
            cb = lambda: self._pending.clear()

        def read_ok(self):
            return self._pending.copy()

        @locked_by("_lock")
        def held(self):
            self.stats = 2

        @locked_by("_other")
        def wrong(self):
            self.stats = 3

        def nested(self):
            with self._lock:
                def cb():
                    self.stats += 1
                self.stats -= 1
    """},
    "locks-clean": {"PKG/eng.py": _PARITY_LOCKY + """
        def good(self):
            with self._lock:
                self.stats += 1
                self._pending.append(1)

        @locked_by("_lock")
        def held(self):
            self.stats = 2
    """},
    "hotloop": {
        "PKG/__init__.py": "",
        "PKG/obs/__init__.py": "",
        "PKG/obs/faults.py": """
            import os

            def current():
                return os.environ.get("EVAM_FAULT_INJECT")
        """,
        "PKG/engine/batcher.py": """
            import os
            import time
            from PKG.obs import faults
            from PKG.obs.faults import current
            import PKG.obs.faults as fmod

            def helper():
                time.sleep(1)
                open("/dev/null")

            class BatchEngine:
                def _step(self):
                    helper()
                    metrics.register("evam_x")

                def _run(self):
                    os.environ.get("EVAM_COLD")
                    for _ in range(3):
                        self._step()
                        current()
                        fmod.current()
                        v = os.environ["EVAM_Y"]

                def _completion_loop(self):
                    while True:
                        os.getenv("EVAM_Z")
                        register_metric("evam_y")
        """,
        "PKG/engine/supervisor.py": """
            import time

            class SupervisedEngine:
                def _monitor_loop(self):
                    while True:
                        time.sleep(0.1)

                def status(self):
                    while True:
                        time.sleep(0.1)
        """,
        "PKG/fleet/engine.py": """
            import os

            class FleetEngine:
                def anything(self):
                    for s in self.shards:
                        os.environ.setdefault("EVAM_W", "1")
        """,
    },
    "hotloop-clean": {"PKG/engine/batcher.py": """
        import os
        import threading

        class BatchEngine:
            def _dispatch_loop_slot(self):
                v = os.environ.get("EVAM_X")
                stop = threading.Event()
                while not stop.wait(0.1):
                    use(v)
    """},
    "knobs": {**_KNOB_SURFACES, "PKG/rogue.py": """
        import os
        from os import getenv
        MODE = os.environ.get("EVAM_MODE", "off")
        DYN = os.getenv("EVAM_" + "X")
        RUN = os.environ["RUN_MODE"]
        LEVEL = getenv("LEVEL")
        os.environ.setdefault("EVAM_FOO", "1")
    """},
    "knobs-clean": {
        **{k: "EVAM_FOO RUN_MODE EVAM_FAULT_INJECT\n"
           for k in _KNOB_SURFACES if not k.startswith("PKG/")},
        "PKG/config/settings.py": _KNOB_SURFACES["PKG/config/settings.py"],
        "PKG/obs/faults.py": _KNOB_SURFACES["PKG/obs/faults.py"],
        "PKG/ok.py": 'import os\nHOME = os.environ.get("HOME")\n',
    },
    "contracts": _REF_CONTRACTS,
    "contracts-clean": {
        **{k.replace("tests/test_torch_", "tests/test_").replace(
            "tools/bench_cuda.py", "bench.py").replace(
            "evam_tpu_torch/", "PKG/"): v.replace("evam_tpu_torch", "PKG")
           for k, v in CONTRACT_BASE.items()},
        "PKG/user.py": USER_OK.replace("evam_tpu_torch", "PKG"),
        "PKG/state/checkpoint.py": _CKPT_OK,
    },
    "imports": {
        "PKG/__init__.py": "from PKG import a\n",
        "PKG/a.py": "from PKG import b\n",
        "PKG/b.py": "import PKG.c\n",
        "PKG/c.py": "from .a import thing\n",
        "PKG/d/__init__.py": "from ..d import e\n",
        "PKG/d/e.py": "try:\n    from PKG.d import f\nexcept ImportError:\n"
                      "    pass\n",
        "PKG/d/f.py": "if True:\n    from PKG.d.e import g\n",
        "PKG/broken.py": "def (:\n",
    },
    "imports-clean": {
        "PKG/__init__.py": "from PKG import a\n",
        "PKG/a.py": "from PKG import b\n",
        "PKG/b.py": "def late():\n    from PKG import a\n    return a\n",
    },
}


def _write(root: Path, files: dict[str, str], pkg: str,
           outside: dict[str, str]) -> None:
    for rel, text in files.items():
        rel = outside.get(rel, rel).replace(_P, pkg)
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text).replace(_P, pkg), encoding="utf-8")


def _norm(findings, pkg: str, outside: dict[str, str]) -> list[tuple]:
    """(pass, path inside the package or the port's outside path, line,
    ident) with the package name taken out of paths and idents."""
    def strip(s: str) -> str:
        return s.replace(pkg + "/", "<pkg>/")

    return sorted((f.pass_id, strip(outside.get(f.file, f.file)), f.line,
                   strip(f.ident)) for f in findings)


@pytest.mark.parametrize("case", sorted(PARITY))
def test_findings_equal_the_references(tmp_path, case):
    pass_id = case.split("-")[0]
    files = PARITY[case]
    _write(tmp_path / "ref", files, "evam_tpu", {})
    _write(tmp_path / "port", files, PKG, _OUTSIDE)
    ref = _norm(ref_analysis.run_passes(tmp_path / "ref", (pass_id,)),
                "evam_tpu", _OUTSIDE)
    port = _norm(run_passes(tmp_path / "port", (pass_id,)), PKG, {})
    assert port == ref
    if case.endswith("-clean"):
        assert port == []
    else:
        # the fixture exercises the pass: several distinct findings
        assert len({f[3] for f in port if f[0] == pass_id}) >= 2, port
