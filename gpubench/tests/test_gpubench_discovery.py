"""BENCHMARK.json against the contract, and every part found by name."""

from __future__ import annotations

import json
import re

import pytest

from gpubench.harness import spec
from gpubench.tests.toy import make_root, toy_config

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_json(spec.ROOT / "BENCHMARK.json")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
        for text in ("why", "layer", "source"):
            if text in e and group in ("configs", "workloads"):
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = cell.metrics(True)
        assert layers
        for m in layers:
            assert m["moves"] in e2e


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_parts(w):
    cell = spec.load_cell(w)
    assert cell.chips == 1
    cfg = cell.config
    spec.engine_module(spec.BENCH_DIR, cfg["engine"])
    spec.judge_module(spec.BENCH_DIR, cfg["judge"])
    spec.reference_module(cfg["reference"])
    for m in cell.metrics(True):
        assert callable(spec.metric_reader(spec.BENCH_DIR, m["name"]))
    assert cfg["layers"], "the frozen layer table is empty"
    lim = cfg["check"]["limits"]
    assert all(v is not None for v in lim.values())
    assert lim["struct_faults"] == 0 and lim["empty_frames"] == 0


def test_a_new_cell_config_mix_and_metric_are_files_and_entries(tmp_path):
    """A toy configuration, mix, cell and per-layer metric, added as new
    files and BENCHMARK.json entries only, are found by name."""
    cfg = toy_config("pvb_detect_int8", name="toy_detect")
    root, bench_dir = make_root(
        tmp_path, {"toy_detect": cfg},
        {"toy_mix": {"loop": "closed", "streams": 2, "outstanding": 1}},
        [{"name": "toy.cell", "config": "toy_detect", "traffic": "toy_mix",
          "chips": 1, "why": "toy"}])
    (bench_dir / "metrics").unlink()
    (bench_dir / "metrics").mkdir()
    (bench_dir / "metrics" / "toy_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"] = [{"name": "toy_metric", "unit": "ms",
                           "better": "lower", "source": "program_counter",
                           "layer": "toy", "moves": "fps",
                           "workloads": ["toy.cell"]}]
    bench["end_to_end"] = [m for m in bench["end_to_end"]
                           if m["name"] in ("fps", "setup_s")]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("toy.cell", root, bench_dir)
    assert cell.config["name"] == "toy_detect"
    assert cell.traffic["streams"] == 2
    assert [m["name"] for m in cell.metrics(False)] == ["fps", "setup_s"]
    (metric,) = cell.metrics(True)
    assert spec.metric_reader(bench_dir, metric["name"])(None) == 42.0


def test_names_outside_the_grammar_are_refused():
    with pytest.raises(ValueError):
        spec.check_name("../etc")
    with pytest.raises(ValueError):
        spec.check_name("a b")
