"""Quarantine and rebuild of wedged engines (counterpart of ``evam_tpu/engine/supervisor.py``).

The stall watchdog (``engine/batcher.py``) fails the futures stranded
behind a wedged device call and flags the engine; ``SupervisedEngine``
then recovers in process:

* a **stable handle**: the hub caches one SupervisedEngine per key and
  stages hold it; the live BatchEngine underneath is swappable, so a
  rebuild is invisible to every holder;
* a **monitor thread** watches the live engine (the ``stalled`` flag, or
  a dead dispatcher, launcher or completer thread) and, on a trip,
  writes a **flight-recorder** artifact (``obs/trace.py``
  ``flight_dump``: the ring's last batch and frame records, the wedged
  batch's row naming its last completed stage, and the engine's queue
  state), captures every registered stream's checkpoint at the
  ``pre_rebuild`` barrier (EVAM_CKPT on), then **quarantines** it
  (``BatchEngine.abandon()``: fail everything
  failable, never join the wedged threads; its graphs and staging
  buffers are freed), waits an exponential backoff, **rebuilds** it with
  the factory — fresh CUDA graphs and a fresh staging ring — re-warms
  it from the captured example (the same warmup as the first engine's,
  through the AOT cache's attribution: with ``EVAM_AOT`` on, a rebuild
  whose libraries the store holds compiles nothing, and its buckets
  count as hits), and swaps it in; the counters carry over
  (``EngineStats.absorb``, ``aot`` included);
* a **restart budget**: at most ``max_restarts`` rebuilds within a
  sliding ``restart_window_s``. Exhausting it is the terminal
  ``degraded`` state (a second flight dump): /healthz answers 503
  "degraded" (against the transient 503 "restarting") and the process
  needs a restart.

A sticky CUDA error poisons the whole context, so a real device fault
cannot be recovered in process; what the supervisor recovers from is a
host-side wedge: EVAM_FAULT_INJECT's ``wedge`` (the launching thread
sleeps under the engine's device lock), or a test's stub launch that
blocks on an event.

States ride ``evam_engine_state`` (0 running, 1 restarting, 2
degraded) and rebuilds ``evam_engine_restarts``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable

from evam_tpu_torch.analysis.annotations import locked_by
from evam_tpu_torch.engine.batcher import BatchEngine, EngineStats, stats_row
from evam_tpu_torch.obs import trace
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.engine.supervisor")

#: gauge encoding for evam_engine_state, index = value
ENGINE_STATES = ("running", "restarting", "degraded")


def _engine_snapshot(eng) -> dict:
    """Queue and in-flight state of a wedged engine for the flight
    recorder's header, taken before abandon() fails the stranded
    futures."""
    try:
        return {
            "queue_depth": eng.queue_depth(),
            "class_depths": eng.class_depths(),
            "shed_counts": eng.shed_counts(),
            "outstanding": len(eng._outstanding),
            "stalled": eng.stalled.is_set(),
            "batches": eng.stats.batches,
        }
    except Exception:  # noqa: BLE001 — engine mid-teardown
        return {}


class SupervisedEngine:
    """Stable, restartable handle around a replaceable BatchEngine.

    Duck-types the BatchEngine surface the stages and the hub use
    (``submit``, ``warm_async``, ``set_example``, ``stats``, ``warmed``,
    ``stalled``, ...): unknown attributes delegate to the live engine.
    """

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {
        "state": "_lock",
        "restarts": "_lock",
        "last_stall_ts": "_lock",
        "_shed_carry": "_lock",
        "_stats_carry": "_lock",
        "_example": "_lock",
        "_warm_requested": "_lock",
        "_engine": "_lock",
    }

    def __init__(
        self,
        name: str,
        factory: Callable[[], BatchEngine],
        max_restarts: int = 3,
        restart_window_s: float = 300.0,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        poll_interval_s: float = 0.1,
    ):
        self.name = name
        self._factory = factory
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.poll_interval_s = poll_interval_s
        self.restarts = 0
        self.last_stall_ts: float | None = None
        #: path of the last flight-recorder artifact (None: none
        #: written, or tracing off)
        self.last_flight: str | None = None
        self._restart_times: deque[float] = deque()
        #: cumulative counters of quarantined engines, so /healthz and
        #: /engines stay monotonic across a rebuild
        self._stats_carry: EngineStats | None = None
        #: per-class shed counts of quarantined engines, so the hub's
        #: shed totals stay monotonic across a rebuild
        self._shed_carry: dict[str, int] = {}
        self._example: dict | None = None
        self._warm_requested = False
        self._lock = threading.RLock()
        self.state = "running"
        self._engine = factory()
        metrics.set("evam_engine_state", 0.0, {"engine": name})
        self._stop_evt = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name=f"engine-{name}-supervisor",
            daemon=True)
        self._monitor.start()

    # ------------------------------------------------------------- API

    def submit(self, priority: str = "standard", units: int | None = None,
               stream: str | None = None, trace: object | None = None,
               **inputs) -> Future:
        with self._lock:
            state = self.state
            eng = self._engine
        if state == "degraded":
            raise RuntimeError(
                f"engine {self.name} is degraded: restart budget "
                f"({self.max_restarts} rebuilds in "
                f"{self.restart_window_s:.0f}s) exhausted; serving this "
                "engine requires a process restart")
        if state == "restarting":
            # the same transient contract as a stranded future
            raise TimeoutError(
                f"engine {self.name} is restarting after a wedge; "
                "retry shortly")
        return eng.submit(priority=priority, units=units, stream=stream,
                          trace=trace, **inputs)

    def warm_async(self, **example) -> None:
        with self._lock:
            self._example = dict(example)
            self._warm_requested = True
            eng = self._engine
        eng.warm_async(**example)

    def set_example(self, **example) -> None:
        with self._lock:
            self._example = dict(example)
            eng = self._engine
        eng.set_example(**example)

    def stop(self) -> None:
        self._stop_evt.set()
        with self._lock:
            eng = self._engine
            state = self.state
        if state == "running":
            eng.stop()
        else:
            # a quarantined or degraded engine may hold wedged threads
            eng.abandon()
        self._monitor.join(timeout=5)

    @property
    def stats(self) -> EngineStats:
        """The live engine's counters plus everything absorbed from
        quarantined predecessors (the live object while none was)."""
        eng = object.__getattribute__(self, "_engine")
        with self._lock:
            carry = self._stats_carry
        if carry is None:
            return eng.stats
        merged = EngineStats()
        with self._lock:
            merged.absorb(carry)
        with eng._exec_lock:
            merged.absorb(eng.stats)
        return merged

    def stats_row(self) -> dict:
        eng = object.__getattribute__(self, "_engine")
        merged = EngineStats()
        with self._lock:
            if self._stats_carry is not None:
                merged.absorb(self._stats_carry)
        with eng._exec_lock:
            merged.absorb(eng.stats)
        return stats_row(self, merged)

    def shed_counts(self) -> dict[str, int]:
        """Per-class shed totals, quarantined predecessors included."""
        live = object.__getattribute__(self, "_engine").shed_counts()
        with self._lock:
            if not self._shed_carry:
                return live
            out = dict(self._shed_carry)
        for c, n in live.items():
            out[c] = out.get(c, 0) + n
        return out

    def _absorb_counters(self, eng: BatchEngine) -> None:
        """Fold a quarantined engine's counters into the carry before
        it is abandoned and replaced."""
        snap = EngineStats()
        with eng._exec_lock:
            snap.absorb(eng.stats)
        shed = eng.shed_counts()
        with self._lock:
            if self._stats_carry is None:
                self._stats_carry = EngineStats()
            self._stats_carry.absorb(snap)
            for c, n in shed.items():
                self._shed_carry[c] = self._shed_carry.get(c, 0) + n

    def __getattr__(self, item):
        # only for attributes NOT found on the handle: warmed, stalled,
        # assembly, buckets, step_fn, input_names, ...
        return getattr(object.__getattribute__(self, "_engine"), item)

    # ------------------------------------------------------- internals

    @locked_by("_lock")
    def _set_state(self, state: str) -> None:
        self.state = state
        metrics.set("evam_engine_state", float(ENGINE_STATES.index(state)),
                    {"engine": self.name})

    def _wedged(self, eng: BatchEngine) -> str | None:
        """Reason string when the live engine needs a rebuild."""
        if eng.stalled.is_set():
            return "stall watchdog fired"
        if eng._stop.is_set():
            return None  # deliberate stop, not a wedge
        if not eng._dispatcher.is_alive():
            return "dispatcher thread died"
        if not eng._completer.is_alive():
            return "completion thread died"
        if eng._launcher is not None and not eng._launcher.is_alive():
            return "transfer launcher thread died"
        return None

    def _monitor_loop(self) -> None:
        while not self._stop_evt.wait(self.poll_interval_s):
            with self._lock:
                if self.state == "degraded":
                    return
                eng = self._engine
            eng.refresh_queue_gauges()
            reason = self._wedged(eng)
            if reason is not None:
                self._quarantine_and_rebuild(eng, reason)

    def _quarantine_and_rebuild(self, eng: BatchEngine, reason: str) -> None:
        with self._lock:
            self.last_stall_ts = time.time()
        log.error("engine %s wedged (%s); quarantining", self.name, reason)
        # the flight recorder first: abandon() fails the stranded
        # futures and retires the wedged batch's pending record
        self.last_flight = trace.flight_dump(
            self.name, reason, state=_engine_snapshot(eng))
        # the crash-consistency barrier: every registered stream's
        # state, no older than the wedge, before the swap
        from evam_tpu_torch.state import active as ckpt_active

        ckpt = ckpt_active()
        if ckpt is not None:
            ckpt.capture_all(barrier="pre_rebuild")
        self._absorb_counters(eng)
        eng.abandon()
        while not self._stop_evt.is_set():
            now = time.time()
            while (self._restart_times
                   and now - self._restart_times[0] > self.restart_window_s):
                self._restart_times.popleft()
            if len(self._restart_times) >= self.max_restarts:
                with self._lock:
                    self._set_state("degraded")
                self.last_flight = trace.flight_dump(
                    self.name, "restart budget exhausted; degraded",
                    state=_engine_snapshot(eng))
                log.error(
                    "engine %s restart budget exhausted (%d rebuilds in "
                    "%.0fs); entering terminal degraded state — process "
                    "restart required",
                    self.name, self.max_restarts, self.restart_window_s)
                return
            self._restart_times.append(now)
            with self._lock:
                self.restarts += 1
                self._set_state("restarting")
            metrics.inc("evam_engine_restarts", labels={"engine": self.name})
            attempt = len(self._restart_times)
            delay = min(self.backoff_s * (2 ** (attempt - 1)),
                        self.max_backoff_s)
            log.warning("engine %s rebuild %d/%d in %.2fs (window %.0fs)",
                        self.name, attempt, self.max_restarts, delay,
                        self.restart_window_s)
            if self._stop_evt.wait(delay):
                return
            try:
                new = self._factory()
            except Exception:  # noqa: BLE001 — a failed build consumes budget
                log.exception("engine %s rebuild failed", self.name)
                continue
            with self._lock:
                warm = self._warm_requested and self._example is not None
                example = self._example
            if warm:
                # re-admit warm: every bucket captured again before the
                # first stream's batch; the handle stays `restarting`
                # (healthz 503, submits fail fast) meanwhile. A warmup
                # that never finishes means the device is still stuck.
                new.warm_async(**example)
                warm_timeout = max(
                    new.stall_timeout_s * new.first_batch_grace
                    * max(len(new.buckets), 1), 10.0)
                warm_deadline = time.time() + warm_timeout
                warm_ok = True
                while not new.warmed.wait(timeout=0.2):
                    if self._stop_evt.is_set():
                        new.abandon()
                        return
                    if time.time() > warm_deadline:
                        warm_ok = False
                        break
                if not warm_ok:
                    log.error("engine %s rebuild warmup did not finish in "
                              "%.0fs; treating as a failed rebuild",
                              self.name, warm_timeout)
                    new.abandon()
                    continue
            else:
                if example is not None:
                    new.set_example(**example)
                # no warmup was requested: as ready as the first one was
                new.warmed.set()
            with self._lock:
                self._engine = new
                self._set_state("running")
            log.warning("engine %s rebuilt and re-admitted (restart %d, "
                        "fresh graphs and staging ring)",
                        self.name, self.restarts)
            return
