"""Find a cell's parts by name.

``BENCHMARK.json`` names the cells; each cell names a configuration
(the file its ``configs`` entry gives) and a traffic mix
(``traffic/<name>.json``); a configuration names the engine it builds
(``engines/<name>.py``), its judge (``judges/<name>.py``) and its
reference (``reference/<name>.py``); each per-layer metric is read by
``metrics/<name>.py``. A later cell, configuration, mix or metric is new
files and new entries, never an edit of a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

#: the benchmark's own directory and the checkout root above it
BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts loaded."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    bench: dict
    bench_dir: Path

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def metrics(self, trace: bool) -> list[dict]:
        """The metric entries this cell reports: its end-to-end metrics
        without the trace, its per-layer metrics with it."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its configuration
    and its traffic mix."""
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config = load_json(root / cfg_entry["file"])
    if config.get("name") != cfg_entry["name"]:
        raise ValueError(f"{cfg_entry['file']} names {config.get('name')!r}, "
                         f"BENCHMARK.json {cfg_entry['name']!r}")
    traffic = load_json(bench_dir / "traffic"
                        / f"{check_name(entry['traffic'])}.json")
    return Cell(name, entry, config, traffic, bench, bench_dir)


def _load_file(path: Path, label: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no {label} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"gpubench_{label}_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(bench_dir: Path, name: str):
    """``metrics/<name>.py``'s ``read(ctx)``: the metric's value, or
    None where the run gave it nothing to read."""
    return _load_file(bench_dir / "metrics" / f"{check_name(name)}.py",
                      "metric").read


def engine_module(bench_dir: Path, name: str) -> ModuleType:
    """``engines/<name>.py``: builds the cell's engine on the program's
    hub (``build(hub, config)``)."""
    return _load_file(bench_dir / "engines" / f"{check_name(name)}.py",
                      "engine")


def judge_module(bench_dir: Path, name: str) -> ModuleType:
    """``judges/<name>.py``: the comparison that decides ``correct``."""
    return _load_file(bench_dir / "judges" / f"{check_name(name)}.py",
                      "judge")


def reference_module(name: str) -> ModuleType:
    """``reference/<name>.py``, the configuration's plain reference."""
    return importlib.import_module(f"gpubench.reference.{check_name(name)}")
