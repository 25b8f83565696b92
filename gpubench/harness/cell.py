"""One run of one cell: set-up, the measured window, the comparison.

Set-up (``setup_s``, from the process's start to the first timed
submit): the weights from the seed on the device, written where the
program's registry loads them; the program's hub and the cell's engine,
every batch bucket warmed and captured; one bucket of frames served
through the engine before the clock starts. The window: the cell's
traffic for ``--seconds``, nothing built or compiled inside it. After
it: the peak memory read, the program stopped and freed, then the
reference works out a sample of the served frames again and the judge
compares. With ``--trace 1`` the run turns on the program's profiler
ranges and profiles a steady stretch in the middle of the window; the
per-layer metrics are read from that trace and the engine's counters.

Earlier lines of standard output describe the run (card, host probe,
batches, what was compared); the last is the result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from gpubench.harness import (load, probe, profile, readers, reckon, spec,
                              weights)

#: modules a run may never hold once its window has closed, by top-level
#: name (``evam_tpu_torch`` is the program; ``evam_tpu`` the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "evam_tpu")
#: how long a run waits after the window for frames still in flight
DRAIN_S = 60.0
#: the traced stretch: where it starts, as a share of the window, and
#: its longest length in seconds
PROFILE_AT = 0.35
PROFILE_MAX_S = 2.0
PRECISION_ENV = {"INT8": "int8", "BF16": "bfloat16", "FP32": "float32"}


def _say(obj) -> None:
    print(json.dumps(obj), flush=True)


def _elapsed_since_start() -> float | None:
    """Seconds since this process started, from the kernel's clocks
    (10 ms resolution); None where ``/proc`` cannot tell."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


_T_IMPORT = time.perf_counter()


def setup_seconds() -> float:
    since = _elapsed_since_start()
    return since if since is not None else time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold,
    compared whole (so ``evam_tpu_torch`` is not ``evam_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="gpubench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def configure_env(config: dict, root: Path) -> None:
    """Knobs the program reads when its modules are imported or its
    kernels built: the configuration's precision with the hand int8
    kernel, and every build and kernel cache at a fixed path inside the
    checkout."""
    cache = root / "gpubench" / ".cache"
    os.environ["EVAM_PRECISION"] = PRECISION_ENV[config["precision"]]
    os.environ["EVAM_QGEMM"] = "pallas"
    os.environ["EVAM_COMPILE_CACHE_DIR"] = str(cache / "kernels")
    os.environ["EVAM_AOT_DIR"] = str(cache / "aot")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def engine_delta(row0: dict, row1: dict) -> dict:
    """What an engine did between two ``stats_row`` snapshots."""
    def stage_s(row):
        return {s: ms * row["batches"] / 1e3
                for s, ms in row["stage_ms"].items()}

    s0, s1 = stage_s(row0), stage_s(row1)
    buckets = {int(b): c - row0["bucket_batches"].get(b, 0)
               for b, c in row1["bucket_batches"].items()}
    return {"batches": row1["batches"] - row0["batches"],
            "items": row1["items"] - row0["items"],
            "stage_seconds": {s: s1[s] - s0.get(s, 0.0) for s in s1},
            "bucket_batches": {b: c for b, c in buckets.items() if c}}


class Window:
    """The ticks of a run's window: the engine snapshot at its close,
    and in a traced run the profiled stretch with its snapshots."""

    def __init__(self, engine, t_start: float, seconds: float, trace: bool):
        self.engine = engine
        self.t_end = t_start + seconds
        self.row_end = None
        self.trace = trace
        length = min(PROFILE_MAX_S, 0.3 * seconds)
        self.prof_at = t_start + PROFILE_AT * seconds
        self.prof_end = self.prof_at + length
        self.prof = None
        self.sub = None  # (t0, t1, row0, row1)
        #: seconds the profiler's start and stop took on the client
        self.prof_seconds = [None, None]

    def tick(self, now: float) -> None:
        if self.trace and self.prof is None and self.sub is None \
                and now >= self.prof_at:
            self.sub = [now, None, self.engine.stats_row(), None]
            self.prof = profile.start()
            self.prof_seconds[0] = time.perf_counter() - now
        elif self.prof is not None and self.sub[1] is None \
                and now >= self.prof_end:
            self.prof.stop()
            self.sub[1] = time.perf_counter()
            self.prof_seconds[1] = self.sub[1] - now
            self.sub[3] = self.engine.stats_row()
        if self.row_end is None and now >= self.t_end:
            self.row_end = self.engine.stats_row()


class System:
    """The program under test, built for one cell and one seed: the
    weights from the seed on the device, written where its registry
    loads them; its hub with the serving defaults; the cell's engine,
    every bucket warmed and captured, and one top bucket of frames
    served through it. ``ref_params`` are the same weights in float32
    for the reference."""

    def __init__(self, cell, seed: int, device: str, bench_dir: Path):
        import torch

        from evam_tpu_torch.config.settings import Settings
        from evam_tpu_torch.engine.hub import EngineHub
        from evam_tpu_torch.models.convert import params_to_msgpack
        from evam_tpu_torch.models.registry import ModelRegistry

        config = cell.config
        self.ref = spec.reference_module(config["reference"])
        self.models_dir = Path(tempfile.mkdtemp(prefix="gpubench-models-"))
        self.hub = None
        self.ref_params = {}
        for role, (key, p) in self.ref.make_weights(
                config, seed, device, torch.bfloat16, weights.make).items():
            path = self.models_dir / key / config["precision"] / "weights.msgpack"
            path.parent.mkdir(parents=True)
            path.write_bytes(params_to_msgpack(p))
            self.ref_params[role] = {k: v.float() for k, v in p.items()}
        inputs, widths = self.ref.overrides(config)
        registry = ModelRegistry(
            models_dir=self.models_dir,
            dtype=PRECISION_ENV[config["precision"]], device=device,
            allow_random_weights=False, input_overrides=inputs,
            width_overrides=widths)
        e = Settings.from_env(env={}).engine
        self.hub = EngineHub(
            registry, device=device, max_batch=config["hub"]["max_batch"],
            deadline_ms=config["hub"]["deadline_ms"],
            wire_format=config["wire"]["format"], warmup=True,
            device_synth=True, stall_timeout_s=e.stall_timeout_s,
            supervise=e.supervise, max_restarts=e.max_restarts,
            restart_window_s=e.restart_window_s,
            restart_backoff_s=e.restart_backoff_s,
            first_batch_grace=e.first_batch_grace, transfer=e.transfer,
            transfer_depth=e.transfer_depth, assembly=e.batch_assembly,
            staging_depth=e.staging_depth)
        self.engine = spec.engine_module(bench_dir, config["engine"]).build(
            self.hub, config)
        t0 = time.perf_counter()
        self.engine.warm_async(frames=np.uint32(0))
        if not self.engine.warmed.wait(timeout=1100):
            raise RuntimeError("the engine's warmup did not finish")
        self.warm_s = time.perf_counter() - t0
        self.warm_row = self.engine.stats_row()
        futs = [self.engine.submit(frames=np.uint32(load.frame_seed(
            seed, 1 << 20, i))) for i in range(config["hub"]["max_batch"])]
        for f in futs:
            f.result(timeout=300)

    def close(self) -> None:
        """Stop the program and free what it holds on the device."""
        if self.hub is not None:
            self.hub.stop()
        self.hub = self.engine = None
        shutil.rmtree(self.models_dir, ignore_errors=True)
        gc.collect()
        import torch

        if torch.cuda.is_available():
            torch.cuda.empty_cache()


@dataclass
class Measured:
    """One window of load: every frame's record, the window's bounds,
    the engine's counters at both ends, and the traced stretch."""

    rec: load.Record
    t_start: float
    t_end: float
    row0: dict
    row1: dict
    win: Window

    def arrays(self):
        """(resolved time, resolved without error) per frame."""
        done = np.array([np.nan if d is None else d for d in self.rec.done])
        err = np.array([e is not None for e in self.rec.error], bool)
        return done, ~np.isnan(done) & ~err


def measure(engine, traffic: dict, seed: int, seconds: float,
            keep_one_in: int, trace: bool, on_start=None) -> Measured:
    """Offer ``traffic`` to ``engine`` for ``seconds`` (``on_start()``
    is called just before the first submit)."""
    import torch

    client = load.Client(
        engine, traffic, seed, keep_one_in,
        span=(lambda: torch.profiler.record_function("gpubench.submit"))
        if trace else None)
    row0 = engine.stats_row()
    if on_start is not None:
        on_start()
    t_start = time.perf_counter()
    win = Window(engine, t_start, seconds, trace)
    client.tick = win.tick
    rec = client.run(t_start, seconds, DRAIN_S)
    row1 = win.row_end or engine.stats_row()
    win.engine = None
    return Measured(rec, t_start, t_start + seconds, row0, row1, win)


def window_line(cell, seed: int, seconds: float, m: Measured,
                extra: dict) -> dict:
    """What a window did, for an earlier line of the run."""
    done, ok = m.arrays()
    delta = engine_delta(m.row0, m.row1)
    kept = list(m.rec.rows.values())
    return {"line": "window", "cell": cell.name, "seed": seed,
            "seconds": seconds, "frames": len(m.rec.seed),
            "resolved_in_window": int((ok & (done <= m.t_end)).sum()),
            "failed": int((~ok).sum()),
            "errors": sorted({e for e in m.rec.error if e})[:3],
            "items_per_batch": delta["items"] / max(1, delta["batches"]),
            "bucket_batches": delta["bucket_batches"],
            "stage_ms_per_batch": {
                s: 1e3 * v / max(1, delta["batches"])
                for s, v in delta["stage_seconds"].items()},
            "objects_per_frame": float(np.mean(
                [(r[:, 6] > 0.5).sum() for r in kept])) if kept else None,
            **extra}


def classified_per_frame(config: dict, m: Measured) -> float:
    """Mean classified rows a kept frame (0 without a classifier)."""
    if not config.get("classifier") or not m.rec.rows:
        return 0.0
    return float(np.mean([(np.abs(r[:, 7:]).sum(1) > 0).sum()
                          for r in m.rec.rows.values()]))


def run(args: argparse.Namespace, device: str = "cuda",
        require_cuda: bool = True, root: Path = spec.ROOT,
        bench_dir: Path = spec.BENCH_DIR) -> int:
    """Run the cell; print its lines. Returns the exit code."""
    if not (root / "evam_tpu_torch").is_dir():
        print("gpubench: the program under test (evam_tpu_torch/) is not "
              f"in {root}", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, root, bench_dir)
    import torch

    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell.chips):
        print(f"gpubench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    config = cell.config
    trace = bool(args.trace)
    prepare(config, root, trace)
    on_card = device.startswith("cuda")
    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    _say({"line": "card", "name": card, "nvidia_smi": probe.smi(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "host_probe_ms": probe.host_ms()})

    system = System(cell, args.seed, device, bench_dir)
    try:
        if trace:
            _say({"line": "profiler_init", "seconds": profile.warm()})
        # the set-up's heap leaves the collector's scans, as the
        # program's server settles its own before it serves
        gc.collect()
        gc.freeze()
        box = {}
        m = measure(system.engine, cell.traffic, args.seed, args.seconds,
                    config["check"]["keep_one_in"], trace,
                    on_start=lambda: box.setdefault("setup_s",
                                                    setup_seconds()))
        mem_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    finally:
        gc.unfreeze()
        system.close()
    done, ok = m.arrays()
    in_window = ok & (done >= m.t_start) & (done <= m.t_end)
    failed = int((~ok).sum())
    values = {"setup_s": box["setup_s"],
              "fps": in_window.sum() / args.seconds}
    rois = classified_per_frame(config, m)
    _say(window_line(cell, args.seed, args.seconds, m, {
        "classified_per_frame": rois, "warm_s": system.warm_s,
        "graphs": system.warm_row.get("graphs"),
        "capture_s": system.warm_row.get("compile_s"),
        "memory_peak_bytes": mem_peak,
        "nvidia_smi": probe.smi()}))

    numbers, checks, summary = compare(cell, system, m, args.seed, device,
                                       bench_dir)
    correct = summary.pop("ok") and failed == 0
    checks["failed_frames"] = {"value": failed, "limit": 0}
    _say({"line": "compared", **summary})

    metrics, breakdown = {}, None
    device_row = {"platform": "gpu" if on_card else "cpu", "kind": card,
                  "count": cell.chips, "memory_peak_bytes": mem_peak}
    wanted = cell.metrics(trace)
    if not trace:
        for e in wanted:
            if values.get(e["name"]) is not None:
                metrics[e["name"]] = {"value": values[e["name"]],
                                      "unit": e["unit"]}
    else:
        tl, ctx = traced_context(cell, m, args.seconds, rois)
        for e in wanted:
            v = spec.metric_reader(bench_dir, e["name"])(ctx)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
        if tl is not None and tl.device:
            device_row["busy_s"] = profile.busy_seconds(tl)
            device_row["window_s"] = tl.seconds
            breakdown = profile.breakdown(tl)
            _say({"line": "breakdown_share", "window_s": tl.seconds,
                  "device_ops": [[n, s / tl.seconds]
                                 for n, s in breakdown["device_ops"]]})

    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    result = {"correct": correct, "attempted": len(m.rec.seed),
              "failed": failed, "metrics": metrics, "device": device_row}
    if breakdown is not None:
        result["breakdown"] = {k: [[n[:160], s] for n, s in v]
                               for k, v in breakdown.items()}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    _say(result)
    return 0


def prepare(config: dict, root: Path, trace: bool) -> None:
    """The environment the program reads, then the program's profiler
    ranges on for a traced run."""
    configure_env(config, root)
    from evam_tpu_torch.obs import trace as prog_trace
    from evam_tpu_torch.ops import qlinear

    if qlinear.QGEMM_BACKEND != "pallas":
        raise RuntimeError("the program's int8 GEMM backend was read before "
                           "the benchmark set it: run in a fresh process")
    prog_trace.maybe_start_profiler(trace)


def compare(cell, system: System, m: Measured, seed: int, device,
            bench_dir: Path) -> tuple[dict, dict, dict]:
    """Judge a sample of the window's kept frames, drawn from the seed,
    against the reference. Returns (numbers, checks, summary with
    ``ok``)."""
    import torch

    if str(device).startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    check = cell.config["check"]
    _, ok = m.arrays()
    pool = [fid for fid in m.rec.rows if ok[fid]]
    rng = np.random.default_rng(weights.mix_seed(seed, 0x5A))
    sample = sorted(rng.choice(pool, size=min(check["frames"], len(pool)),
                               replace=False).tolist()) if pool else []
    t0 = time.perf_counter()
    numbers, summary = {}, {"frames": 0}
    if sample:
        seeds = np.array([m.rec.seed[f] for f in sample], np.int64)
        rows = np.stack([m.rec.rows[f] for f in sample]).astype(np.float32)
        judge = spec.judge_module(bench_dir, cell.config["judge"])
        numbers, summary = judge.judge(cell.config, system.ref,
                                       system.ref_params, seeds, rows, device)
    limits = check["limits"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    summary["ok"] = bool(sample) and all(
        c["value"] is not None and c["limit"] is not None
        and c["value"] <= c["limit"] for c in checks.values())
    summary["reference_s"] = time.perf_counter() - t0
    return numbers, checks, summary


def traced_context(cell, m: Measured, seconds: float, rois: float):
    """(timeline, the readers' context) of a traced window."""
    done, ok = m.arrays()
    win = m.win
    tl = profile.timeline(win.prof) if win.prof is not None else None
    sub = None
    if win.sub is not None and win.sub[1] is not None:
        t0, t1, r0, r1 = win.sub
        sub = SimpleNamespace(
            seconds=tl.seconds if tl else t1 - t0,
            frames=int((ok & (done >= t0) & (done <= t1)).sum()),
            delta=engine_delta(r0, r1))
    if tl is not None:
        # K1 kernels the trace holds against those the batches replayed
        # in the stretch launched: a trace short by more than the three
        # batches in flight at its ends lost records, and its device
        # readings are short with it
        per_forward = len(reckon.k1_shapes(cell.config["layers"], 1, 1))
        _say({"line": "trace", "events": tl.counts,
              "device_ops": len(tl.device), "host_ranges": len(tl.host),
              "window_s": tl.seconds, "profiler_s": win.prof_seconds,
              "sub_batches": sub.delta["batches"] if sub else None,
              "sub_frames": sub.frames if sub else None,
              "k1_kernels": len(tl.kernels(readers.K1_KERNEL)),
              "k1_launched": sub.delta["batches"] * per_forward
              if sub else None})
    in_window = ok & (done >= m.t_start) & (done <= m.t_end)
    ctx = SimpleNamespace(
        config=cell.config, traffic=cell.traffic, cell=cell.name,
        window_seconds=seconds, frames=int(in_window.sum()),
        rois_per_frame=rois, engine=engine_delta(m.row0, m.row1), sub=sub,
        timeline=tl)
    return tl, ctx


def main(argv=None) -> int:
    return run(parse(argv))
