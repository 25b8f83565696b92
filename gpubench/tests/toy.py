"""A toy copy of the benchmark for the CPU tests: the cells' own
configurations cut to 128×128 frames (48×48 crops) with their widths
kept, written with a
``BENCHMARK.json`` of their own into a temporary root that links the
program and the benchmark's code, so the whole run goes through the
same discovery by name."""

from __future__ import annotations

import json
from pathlib import Path

from gpubench.harness import spec

#: the toy's cuts of the real configurations
TOY = {"detector": {"input_hw": [128, 128]},
       "classifier": {"input_hw": [48, 48]},
       "wire": {"frame_hw": [128, 128]},
       "hub": {"max_batch": 8, "deadline_ms": 8.0}}


def toy_config(base: str, **changes) -> dict:
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / f"{base}.json")
    for part, values in TOY.items():
        if part in cfg:
            cfg[part] = {**cfg[part], **values}
    cfg["layers"] = []
    cfg["check"] = {**cfg["check"], "frames": 8, "keep_one_in": 1}
    cfg.update(changes)
    return cfg


def make_root(tmp: Path, configs: dict, traffics: dict, cells: list[dict],
              bench: dict | None = None) -> tuple[Path, Path]:
    """(root, bench_dir) of a toy checkout: ``configs`` and ``traffics``
    by name, ``cells`` as BENCHMARK.json workloads."""
    root = tmp / "root"
    bench_dir = root / "gpubench"
    (bench_dir / "configs").mkdir(parents=True)
    (bench_dir / "traffic").mkdir()
    (root / "evam_tpu_torch").symlink_to(spec.ROOT / "evam_tpu_torch")
    for sub in ("engines", "judges", "metrics"):
        (bench_dir / sub).symlink_to(spec.BENCH_DIR / sub)
    for name, cfg in configs.items():
        (bench_dir / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in traffics.items():
        (bench_dir / "traffic" / f"{name}.json").write_text(json.dumps(t))
    real = spec.load_json(spec.ROOT / "BENCHMARK.json")
    out = dict(bench or real)
    out["configs"] = [{"name": n, "source": "toy", "reduced": [], "why": "toy",
                       "file": f"gpubench/configs/{n}.json"} for n in configs]
    out["workloads"] = cells
    names = [c["name"] for c in cells]
    for group in ("end_to_end", "per_layer"):
        out[group] = [{**m, "workloads": names} if "workloads" in m else m
                      for m in out[group]]
    (root / "BENCHMARK.json").write_text(json.dumps(out))
    return root, bench_dir
