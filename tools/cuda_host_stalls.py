"""Host stalls under ``chip_smoke.py``'s phases, on the card.

Runs ``chip_smoke.py``'s ``--phases`` (by default those up to ``sched``)
in one process, as the whole script runs them, the sched phase
``--repeat`` more times, and prints one JSON line per sched run and a
summary:

- every full (generation 2) collection of the process (ms), from
  ``chip_smoke.GEN2``, and those inside each sched run;
- every staging-ring allocation (``SlotRing._allocate``: the slots'
  page-locking) with its thread: ``warmup`` when the engine's warmup
  pays it, ``dispatch`` when a first batch does;
- per run: frame errors, the realtime streams' worst latency, each
  stream's first-frame latency;
- at the sched phase's start: the tracked objects by type; at the end:
  the collector's tracked objects, the frozen ones, and the ms of one
  full collection.

``--no-settle`` leaves the heap in the collector's scans (the script's
``settle_heap`` calls become no-ops) and ``--no-prepare`` leaves the
ring's page-locking to the first batch (``SlotRing.prepare`` becomes a
no-op), for a before/after in one call. A failed sched run is counted,
not raised; any other failure ends the run (rc 1 in the summary).

    python3 tools/cuda_host_stalls.py [--no-settle] [--no-prepare] \
        [--phases device,build,ingest] [--repeat 6]
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import threading
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("device,build,qgemm,reference,weights,slice,classify,engine,"
          "track,gate,ragged,sched")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-settle", action="store_true")
    ap.add_argument("--no-prepare", action="store_true")
    ap.add_argument("--phases", default=PHASES)
    ap.add_argument("--repeat", type=int, default=6)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from evam_tpu_torch.engine import ringbuf

    allocs: list[dict] = []
    allocate = ringbuf.SlotRing._allocate

    def timed_allocate(ring, example):
        t0 = time.perf_counter()
        try:
            return allocate(ring, example)
        finally:
            allocs.append({"thread": threading.current_thread().name[-24:],
                           "ms": 1e3 * (time.perf_counter() - t0),
                           "slots": ring.depth, "rows": ring.capacity})

    ringbuf.SlotRing._allocate = timed_allocate
    if args.no_prepare:
        ringbuf.SlotRing.prepare = lambda ring, example: None

    import_port = cs._import_port

    def import_without_settle():
        port = import_port()
        port["settle_heap"] = lambda: 0
        return port

    if args.no_settle:
        cs._import_port = import_without_settle

    runs: list[dict] = []
    serve = cs._serve

    def observed_serve(*a, **k):
        t0 = time.perf_counter()
        n_allocs = len(allocs)
        out = serve(*a, **k)
        prios = k.get("priorities")
        if prios:
            runners = out[0]
            rt = [x for r, p in zip(runners, prios) if p == "realtime"
                  for x in r.latencies]
            runs.append({
                "errors": sum(r.errors for r in runners),
                "realtime_max_ms": 1e3 * max(rt) if rt else None,
                "first_frame_ms": [1e3 * r.latencies[0] for r in runners
                                   if r.latencies],
                "gc_gen2_ms": cs.GEN2.ms_between(t0, time.perf_counter()),
                "ring_allocs": allocs[n_allocs:]})
            print(json.dumps({"sched_run": len(runs), **runs[-1]}),
                  flush=True)
        return out

    cs._serve = observed_serve
    outcomes: list[str] = []
    phase_sched = cs.phase_sched

    def repeated_sched(torch, port):
        objs = gc.get_objects()
        print(json.dumps({"census": "sched start", "tracked": len(objs),
                          "frozen": gc.get_freeze_count(),
                          "types": Counter(type(o).__name__ for o in objs)
                          .most_common(20)}), flush=True)
        del objs
        variants = {"aligned": 0, "masked": 0}
        for _ in range(1 + args.repeat):
            try:
                got = phase_sched(torch, port)
                variants = {v: variants[v] + got[v] for v in variants}
                outcomes.append("ok")
            except AssertionError as exc:
                outcomes.append(str(exc))
        return variants

    cs.phase_sched = repeated_sched
    try:
        rc = cs.main(["--phases", args.phases])
    except AssertionError as exc:
        print(json.dumps({"failed": str(exc)}), flush=True)
        rc = 1
    tracked = len(gc.get_objects())
    t0 = time.perf_counter()
    gc.collect()
    full_ms = 1e3 * (time.perf_counter() - t0)
    print(json.dumps({
        "summary": "host stalls", "phases": args.phases,
        "settled": not args.no_settle, "prepared": not args.no_prepare,
        "rc": rc, "outcomes": outcomes,
        "realtime_max_ms": [r["realtime_max_ms"] for r in runs],
        "gc_gen2_ms_in_runs": [r["gc_gen2_ms"] for r in runs],
        "gc_gen2_process": cs.GEN2.summary(),
        "ring_allocs": allocs,
        "tracked_objects": tracked, "frozen_objects": gc.get_freeze_count(),
        "full_collection_ms": full_ms}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
