"""Per-frame tracing, stage timers, the flight recorder and the
profiler glue (counterpart of ``evam_tpu/obs/trace.py``).

1. **Stage histograms**: every stage execution lands in a labelled
   latency histogram (``/metrics``), and ``PROFILING_MODE=true`` wraps
   the engine's stages and its step in named ranges
   (``torch.profiler.record_function``: a ``torch.profiler`` capture
   shows them, and under ``torch.autograd.profiler.emit_nvtx`` Nsight
   Systems records the same ranges as NVTX ranges).

2. **Per-frame span trees**: a trace id is minted at ingest
   (``start_frame``, ``stages/runner.py``) and threaded through
   FrameContext into every engine submit, so one frame's causal path —
   decode → gate decide → sched queue wait → engine dispatch → publish
   — is reconstructable. Batch records are *linked* to their member
   frames by batch id, with the owning engine and device recorded.
   Spans land in a bounded in-process ``TraceRing`` with **tail-based
   sampling**: error and shed frames and the slowest tail are always
   retained, everything else 1-in-N. ``GET /traces`` serves the ring
   as Chrome trace-event JSON (``tools/trace_dump.py`` reads it), and
   ``observe_frame_latency`` attaches OpenMetrics exemplars linking the
   p99 latency quantile to a concrete trace id.

   On a CUDA engine a graph replay returns before the device finishes,
   so a batch's ``launch`` stage is host issue time, not device time:
   such batch records carry ``"launch": "host_issue"`` (the device
   work shows up in ``readback``, which waits for it).

3. **Flight recorder**: ``flight_dump`` writes the last-N retained
   spans plus live engine state to a JSONL artifact; the engine
   supervisor calls it on every quarantine and on the terminal
   ``degraded`` transition. Pending (in-flight) batch records hold a
   reference to the SAME clock dict the engine fills stage by stage,
   so a wedged batch's record shows its last completed stage.

``EVAM_TRACE=off`` disables layers 2 and 3: ``active()`` memoizes to
None, FrameContext.trace stays None, and every hook is a None check.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import re
import tempfile
import threading
import time
import uuid
from collections import deque

from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.obs.trace")

#: PROFILING_MODE: the engine's stages and step run inside named
#: ranges (``prof_range``)
_profiling = False

#: engine stage order for "last completed stage" attribution — equal to
#: ``engine/ringbuf.py`` STAGES (duplicated so obs never imports the
#: engine)
STAGE_ORDER = ("submit_wait", "slot_write", "seal", "h2d_issue",
               "h2d_wait", "launch", "readback", "resolve")

#: Trace ids: short per-process prefix + monotonic counter — unique
#: across a fleet of processes without coordination, cheap to mint.
_TRACE_PREFIX = uuid.uuid4().hex[:8]
_trace_seq = itertools.count(1)
_flight_seq = itertools.count(1)


def stage_timer(stage_name: str):
    """Record one stage execution into evam_stage_seconds{stage=...}
    (thin alias over the registry's timing context manager)."""
    return metrics.time("evam_stage_seconds", labels={"stage": stage_name})


def observe_frame_latency(stream_id: str, seconds: float,
                          priority: str | None = None,
                          trace_id: str | None = None) -> None:
    """End-to-end per-frame latency (feed → chain complete). ONE
    aggregate histogram, not per stream: stream ids are per-instance
    UUIDs and a labelled histogram per dead stream would grow the
    process-global registry forever. A ``priority`` additionally lands
    a {class=...} series (three QoS classes, ``sched/``). A
    ``trace_id`` rides along as an OpenMetrics exemplar, so the
    rendered p99 quantile line names a concrete frame to pull from
    /traces."""
    metrics.observe("evam_frame_latency_seconds", seconds,
                    exemplar=trace_id)
    if priority:
        metrics.observe("evam_frame_latency_seconds", seconds,
                        {"class": priority}, exemplar=trace_id)


class FrameTrace:
    """One frame's span tree, mutated lock-free by its owning threads.

    Spans are ``(name, t0, dur_s, attrs|None)`` tuples appended with
    list.append (atomic under the GIL); the ring only ever reads a
    trace after ``finish`` or via snapshot copies, so no lock is
    needed on the hot path."""

    __slots__ = ("trace_id", "stream_id", "seq", "priority", "t0",
                 "status", "spans", "bids")

    def __init__(self, trace_id: str, stream_id: str, seq: int,
                 priority: str, t0: float) -> None:
        self.trace_id = trace_id
        self.stream_id = stream_id
        self.seq = seq
        self.priority = priority
        self.t0 = t0
        self.status = "open"
        self.spans: list[tuple] = []
        self.bids: list[str] = []

    def add_span(self, name: str, t0: float, dur: float,
                 attrs: dict | None = None) -> None:
        self.spans.append((name, t0, dur, attrs))

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "stream": self.stream_id,
            "seq": self.seq,
            "class": self.priority,
            "t0": self.t0,
            "status": self.status,
            "bids": list(self.bids),
            "spans": [
                {"name": name, "t0": t0, "dur_s": dur,
                 **({"attrs": attrs} if attrs else {})}
                for (name, t0, dur, attrs) in self.spans
            ],
        }


class TraceRing:
    """Bounded ring of retained frame traces + batch records with
    tail-based sampling. One per process, memoized like the fault
    injector (``active()``)."""

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {
        "_frames": "_lock",
        "_batches": "_lock",
        "_pending": "_lock",
        "_tick": "_lock",
        "retained_count": "_lock",
        "dropped_count": "_lock",
    }

    #: in-flight batch records awaiting completion; bounded so an
    #: abandoned (wedged) engine's orphans can't grow the map forever
    PENDING_MAX = 256

    def __init__(self, enabled: bool = True, sample_n: int = 16,
                 ring: int = 1024, slow_ms: float = 250.0,
                 flight_dir: str = "", flight_n: int = 256,
                 flight_max_files: int = 64,
                 flight_max_bytes: int = 64 * 1024 * 1024) -> None:
        self.enabled = enabled
        self.sample_n = max(1, int(sample_n))
        self.ring = max(1, int(ring))
        self.slow_ms = float(slow_ms)
        self.flight_dir = flight_dir
        self.flight_n = max(1, int(flight_n))
        #: flight-recorder disk bound: a flapping engine quarantining
        #: in a loop must not fill the artifact volume. Oldest-first
        #: rotation after every dump; 0 = unbounded (either axis).
        self.flight_max_files = int(flight_max_files)
        self.flight_max_bytes = int(flight_max_bytes)
        self._lock = threading.Lock()
        self._frames: deque = deque(maxlen=self.ring)
        self._batches: deque = deque(maxlen=self.ring)
        self._pending: dict[tuple[str, int], dict] = {}
        self._tick = 0
        self.retained_count = 0
        self.dropped_count = 0

    # -- frame lifecycle ------------------------------------------------

    def mint(self, stream_id: str, seq: int, priority: str) -> FrameTrace:
        trace_id = f"{_TRACE_PREFIX}-{next(_trace_seq)}"
        return FrameTrace(trace_id, stream_id, seq, priority,
                          time.perf_counter())

    def finish(self, ft: FrameTrace, status: str) -> None:
        """Tail-based retention decision: error/shed/deadline-miss
        frames and the slowest tail always land in the ring; healthy
        frames are kept 1-in-sample_n."""
        if ft.status != "open":  # fan-out children share one trace
            return
        ft.status = status
        dur_ms = (time.perf_counter() - ft.t0) * 1e3
        if status in ("error", "shed", "deadline_miss"):
            reason = status
        elif dur_ms >= self.slow_ms:
            reason = "slow"
        else:
            reason = None
        with self._lock:
            if reason is None:
                self._tick += 1
                if self._tick % self.sample_n == 0:
                    reason = "sampled"
            if reason is None:
                self.dropped_count += 1
            else:
                self.retained_count += 1
                self._frames.append(ft)
        if reason is None:
            metrics.inc("evam_trace_dropped")
        else:
            metrics.inc("evam_trace_retained", labels={"reason": reason})

    # -- batch lifecycle ------------------------------------------------

    def batch_begin(self, engine: str, bid: int, items, bucket: int,
                    n: int, clock: dict, device: str = "") -> None:
        """Register an in-flight batch. ``items`` are duck-typed work
        items carrying an optional ``.trace`` attribute; ``clock`` is
        stored BY REFERENCE — the dispatch path keeps mutating it
        stage-by-stage, so a flight dump of a still-pending batch
        reads the stages completed so far."""
        frames = []
        for it in items:
            ft = getattr(it, "trace", None)
            if ft is not None:
                frames.append(ft.trace_id)
                ft.bids.append(f"{engine}#{bid}")
        rec = {
            "engine": engine, "bid": bid, "bucket": bucket, "n": n,
            "device": device, "t0": time.perf_counter(),
            "wall_t": time.time(), "frames": frames, "clock": clock,
            "status": "in_flight", "dur_s": None,
        }
        if device.startswith("cuda"):
            # a replay returns before the device finishes: the launch
            # stage is host issue time (readback waits for the device)
            rec["launch"] = "host_issue"
        with self._lock:
            self._pending[(engine, bid)] = rec
            while len(self._pending) > self.PENDING_MAX:
                self._pending.pop(next(iter(self._pending)))

    def batch_complete(self, engine: str, bid: int, items=(),
                       status: str = "ok",
                       readback_s: float | None = None,
                       resolve_s: float | None = None) -> None:
        """Retire an in-flight batch record and append per-frame
        queue-wait + dispatch spans to every member trace."""
        now = time.perf_counter()
        with self._lock:
            rec = self._pending.pop((engine, bid), None)
        t0 = None
        if rec is not None:
            t0 = rec["t0"]
            # The clock is quiescent once the batch reaches
            # completion; snapshot it (plus the completion-side
            # stages, which the engine never writes into the clock).
            stages = _clock_stages(rec["clock"])
            if readback_s is not None:
                stages["readback"] = readback_s
            if resolve_s is not None:
                stages["resolve"] = resolve_s
            rec["stages"] = stages
            rec["clock"] = None
            rec["status"] = status
            rec["dur_s"] = now - t0
            with self._lock:
                self._batches.append(rec)
        for it in items:
            ft = getattr(it, "trace", None)
            if ft is None:
                continue
            t_sub = getattr(it, "t_submit", None)
            if t0 is not None and t_sub is not None:
                ft.add_span("sched.queue_wait", t_sub, t0 - t_sub,
                            {"class": getattr(it, "priority", "")})
            start = t0 if t0 is not None else now
            ft.add_span("engine.dispatch", start, now - start,
                        {"engine": engine, "bid": bid, "status": status})

    # -- readout --------------------------------------------------------

    def snapshot(self) -> tuple[list, list, list]:
        """(retained frames, completed batches, pending batches) —
        shallow copies safe to iterate outside the lock."""
        with self._lock:
            return (list(self._frames), list(self._batches),
                    [dict(rec) for rec in self._pending.values()])


def _clock_stages(clock: dict | None) -> dict:
    """Stage snapshot of a (possibly still-mutating) clock dict:
    iterates STAGE_ORDER, never the dict itself, so a concurrent
    writer can't break the copy."""
    if not clock:
        return {}
    return {s: clock[s] for s in STAGE_ORDER if s in clock}


def last_stage(stages: dict | None) -> str | None:
    """The last completed engine stage of a batch record — a wedged
    batch's record stops exactly where the device stopped answering."""
    found = None
    for s in STAGE_ORDER:
        if stages and s in stages:
            found = s
    return found


# -- memoized process-global ring (same shape as obs/faults.py) ---------

_resolved: tuple[TraceRing | None] | None = None


def active() -> TraceRing | None:
    """The process TraceRing, or None when EVAM_TRACE=off. Resolved
    once from settings and memoized — the per-frame/per-batch hooks
    below cost one None-check when tracing is disabled."""
    global _resolved
    if _resolved is None:
        from evam_tpu_torch.config.settings import get_settings

        cfg = get_settings().trace
        ring = TraceRing(
            enabled=cfg.enabled, sample_n=cfg.sample_n, ring=cfg.ring,
            slow_ms=cfg.slow_ms, flight_dir=cfg.flight_dir,
            flight_n=cfg.flight_n,
            flight_max_files=cfg.flight_max_files,
            flight_max_bytes=cfg.flight_max_bytes,
        ) if cfg.enabled else None
        _resolved = (ring,)
    return _resolved[0]


def reset_cache() -> None:
    """Drop the memoized ring (tests / settings reload)."""
    global _resolved
    _resolved = None


# -- hot-path hooks (all no-ops when tracing is off) --------------------

def start_frame(stream_id: str, seq: int,
                priority: str = "standard") -> FrameTrace | None:
    ring = active()
    if ring is None:
        return None
    return ring.mint(stream_id, seq, priority)


def finish_frame(ft: FrameTrace | None, status: str = "ok") -> None:
    if ft is None:
        return
    ring = active()
    if ring is None:
        return
    ring.finish(ft, status)


def batch_begin(engine: str, bid: int, items, bucket: int, n: int,
                clock: dict, device: str = "") -> None:
    ring = active()
    if ring is None:
        return
    ring.batch_begin(engine, bid, items, bucket, n, clock, device)


def batch_complete(engine: str, bid: int, items=(), status: str = "ok",
                   readback_s: float | None = None,
                   resolve_s: float | None = None) -> None:
    ring = active()
    if ring is None:
        return
    ring.batch_complete(engine, bid, items, status=status,
                        readback_s=readback_s, resolve_s=resolve_s)


# -- Chrome trace-event rendering (GET /traces, tools/trace_dump.py) ----

def chrome_trace_events(frames: list | None = None,
                        batches: list | None = None) -> list[dict]:
    """Chrome trace-event ("X" complete events, microsecond ts/dur)
    view of the ring. Frame spans land one track per stream; each
    batch emits one span carrying ``args.frames`` — the trace ids of
    its member frames (the batch↔frame link) — plus per-stage child
    slices laid out sequentially from dispatch."""
    if frames is None and batches is None:
        ring = active()
        if ring is None:
            return []
        frames, done, pending = ring.snapshot()
        batches = done + pending
    events: list[dict] = []
    for ft in frames or ():
        for (name, t0, dur, attrs) in ft.spans:
            args = {"trace_id": ft.trace_id, "seq": ft.seq,
                    "class": ft.priority, "status": ft.status}
            if attrs:
                args.update(attrs)
            events.append({
                "name": name, "ph": "X", "cat": "frame",
                "ts": round(t0 * 1e6, 1), "dur": round(dur * 1e6, 1),
                "pid": "frames", "tid": ft.stream_id, "args": args,
            })
    for rec in batches or ():
        stages = rec.get("stages")
        if stages is None:
            stages = _clock_stages(rec.get("clock"))
        total = rec.get("dur_s")
        if total is None:
            total = sum(stages.values())
        events.append({
            "name": f"batch {rec['engine']}#{rec['bid']}", "ph": "X",
            "cat": "batch", "ts": round(rec["t0"] * 1e6, 1),
            "dur": round(total * 1e6, 1),
            "pid": f"engine {rec['engine']}", "tid": rec.get("device", ""),
            "args": {
                "bid": rec["bid"], "frames": list(rec.get("frames", ())),
                "bucket": rec.get("bucket"), "n": rec.get("n"),
                "device": rec.get("device", ""),
                "status": rec.get("status", ""),
                "stages": stages, "last_stage": last_stage(stages),
                **({"launch": rec["launch"]} if "launch" in rec else {}),
            },
        })
        t = rec["t0"]
        for s in STAGE_ORDER:
            if s not in stages:
                continue
            events.append({
                "name": s, "ph": "X", "cat": "batch-stage",
                "ts": round(t * 1e6, 1),
                "dur": round(stages[s] * 1e6, 1),
                "pid": f"engine {rec['engine']}",
                "tid": f"{rec.get('device', '')}/stages",
                "args": {"bid": rec["bid"]},
            })
            t += stages[s]
    return events


def traces_payload() -> dict:
    """The GET /traces response body: ring counters + Chrome trace
    events (fixed key set so the route goldens stay canonical)."""
    ring = active()
    if ring is None:
        return {"enabled": False, "retained": 0, "dropped": 0,
                "frames": 0, "batches": 0, "pending": 0,
                "traceEvents": []}
    frames, done, pending = ring.snapshot()
    return {
        "enabled": True,
        "retained": ring.retained_count,
        "dropped": ring.dropped_count,
        "frames": len(frames),
        "batches": len(done),
        "pending": len(pending),
        "traceEvents": chrome_trace_events(frames, done + pending),
    }


# -- flight recorder ----------------------------------------------------

def flight_dump(engine: str, reason: str,
                state: dict | None = None) -> str | None:
    """Dump the ring's last-N frame/batch records plus caller-supplied
    engine/queue state to a JSONL artifact (the supervisor calls this
    on quarantine and on the degraded transition). Pending batch
    records read their live clock dict, so a wedged batch's row
    carries ``last_stage`` — where the device stopped answering.
    Returns the artifact path, or None when tracing is off or the
    write fails (a chaos drill must never take the supervisor down)."""
    ring = active()
    if ring is None:
        return None
    out_dir = ring.flight_dir or os.path.join(tempfile.gettempdir(),
                                              "evam_flight")
    name = re.sub(r"[^A-Za-z0-9._-]+", "_", engine) or "engine"
    frames, done, pending = ring.snapshot()
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir,
            f"flight-{name}-{int(time.time() * 1e3)}-{next(_flight_seq)}.jsonl")
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(json.dumps({
                "type": "flight", "engine": engine, "reason": reason,
                "ts": time.time(),
                "profiler_running": profiler_running(),
                "state": state or {},
            }) + "\n")
            for rec in (done + pending)[-ring.flight_n:]:
                stages = rec.get("stages")
                if stages is None:
                    stages = _clock_stages(rec.get("clock"))
                row = {k: v for k, v in rec.items() if k != "clock"}
                row["type"] = "batch"
                row["pending"] = rec.get("status") == "in_flight"
                row["stages"] = stages
                row["last_stage"] = last_stage(stages)
                fh.write(json.dumps(row) + "\n")
            for ft in frames[-ring.flight_n:]:
                row = ft.to_dict()
                row["type"] = "frame"
                fh.write(json.dumps(row) + "\n")
    except OSError as exc:
        log.warning("flight recorder dump failed: %s", exc)
        return None
    _prune_flight_dir(out_dir, path, ring.flight_max_files,
                      ring.flight_max_bytes)
    metrics.inc("evam_flight_dumps", labels={"engine": engine})
    log.error("flight recorder: engine %s (%s) -> %s", engine, reason, path)
    return path


def _prune_flight_dir(out_dir: str, keep_path: str,
                      max_files: int, max_bytes: int) -> None:
    """Oldest-first rotation of flight-*.jsonl artifacts: an engine
    flapping through quarantines (or a chaos soak) must not grow the
    artifact volume without bound. The just-written dump is never
    pruned — the freshest post-mortem always survives. 0 disables the
    corresponding axis (EVAM_TRACE_FLIGHT_MAX_FILES / _MAX_BYTES)."""
    if max_files <= 0 and max_bytes <= 0:
        return
    try:
        entries = []
        for fn in os.listdir(out_dir):
            if not (fn.startswith("flight-") and fn.endswith(".jsonl")):
                continue
            p = os.path.join(out_dir, fn)
            try:
                st = os.stat(p)
            except OSError:
                continue  # concurrent prune/collection
            entries.append((st.st_mtime, st.st_size, p))
    except OSError as exc:
        log.warning("flight recorder rotation scan failed: %s", exc)
        return
    entries.sort()
    count = len(entries)
    total = sum(size for _, size, _ in entries)
    removed = 0
    for _, size, p in entries:
        if not ((max_files > 0 and count > max_files)
                or (max_bytes > 0 and total > max_bytes)):
            break
        if os.path.abspath(p) == os.path.abspath(keep_path):
            continue
        try:
            os.remove(p)
        except OSError:
            continue
        count -= 1
        total -= size
        removed += 1
    if removed:
        log.info("flight recorder rotated out %d artifact(s) from %s",
                 removed, out_dir)


# -- profiler glue ------------------------------------------------------

_NO_RANGE = contextlib.nullcontext()


def maybe_start_profiler(enabled: bool) -> bool:
    """PROFILING_MODE: from now on the engine's stages and its step run
    inside named ranges (``prof_range``). Returns whether they do."""
    global _profiling
    if enabled and not _profiling:
        _profiling = True
        log.info("profiler ranges on (PROFILING_MODE): evam.<stage> "
                 "around the engine's stages, evam.step around the step")
    return _profiling


def stop_profiler() -> None:
    """Turn the ranges off again (tests, the chip smoke's A/B)."""
    global _profiling
    _profiling = False


def prof_range(name: str):
    """A ``torch.profiler.record_function`` range named ``evam.<name>``
    with PROFILING_MODE on, else a shared no-op context."""
    if not _profiling:
        return _NO_RANGE
    import torch

    return torch.profiler.record_function(f"evam.{name}")


def profiler_running() -> bool:
    """Whether PROFILING_MODE's ranges are on in this process — recorded
    in every flight-recorder header, so a post-mortem knows whether a
    profiler capture could have seen the stages."""
    return _profiling


def init_observability(settings) -> None:
    """One-call runtime bootstrap of both serve entry points: the
    compile cache, and the profiler ranges when PROFILING_MODE is on."""
    configure_compilation_cache(settings.engine.compile_cache_dir)
    maybe_start_profiler(settings.profiling_mode)


def configure_compilation_cache(cache_dir: str) -> None:
    """Persist the hand kernels' compiled libraries across restarts in
    ``cache_dir`` (EVAM_COMPILE_CACHE_DIR; the reference's analogue is
    the OpenCL cl_cache): ``ops/kernels.py`` builds into it and loads
    from it. Made here, so a directory that cannot be made fails at
    start, not at the first build. Empty: the checkout's build/kernels."""
    if not cache_dir:
        return
    os.makedirs(cache_dir, exist_ok=True)
    log.info("CUDA kernel compile cache at %s", cache_dir)
