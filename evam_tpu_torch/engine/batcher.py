"""The shared batch engine (counterpart of ``evam_tpu/engine/batcher.py``).

ONE engine per model instance multiplexes every stream that submits to
it. Three cooperating threads per engine (four with the pipelined
transfer, the default), as in the reference:

  submit() ──slot──► dispatcher ──upload──► launcher ──► completer

* **submit()** (stream threads) writes each item's arrays straight into
  its reserved row of a pre-allocated staging slot (``engine/ringbuf.py``;
  page-locked host memory on a ``cuda`` engine);
* the **dispatcher** seals a slot at the batch deadline — the bucket,
  the zeroed pad tail — and, pipelined, issues the slot's host→device
  copy on the engine's copy stream into device buffers the slot owns;
* the **launcher** (``EVAM_TRANSFER=pipelined``) waits out the upload's
  residual (``h2d_wait``), then on the engine's compute stream copies
  the batch into the bucket's static inputs and replays its CUDA graph
  (``engine/graphs.py``; the eager step for a bucket not captured yet),
  and puts the device→host copy into the slot's page-locked output in
  flight — so the dispatcher seals and uploads batch N+1 while batch N
  launches. ``EVAM_TRANSFER=inline`` does upload and launch back to
  back on the dispatcher; ``EVAM_SERIALIZE_COMPILE=1`` forces inline;
* the **completer** blocks on the batch's readback residual, copies
  each item's row out, returns the slot to the ring and resolves the
  futures;
* a semaphore bounds the batches in flight; the ring adds a host-side
  bound (a slot is reusable only after its batch's readback).

``EVAM_BATCH_ASSEMBLY=legacy`` keeps the per-batch stack-and-pad
assembly for A/B. ``warmup()`` (``warm_async``, which the stages call
once they have built the engine) captures every bucket ahead of
traffic; a **watchdog** fails the
futures stranded behind a device call that exceeded
``stall_timeout_s`` and flags ``stalled`` (the supervisor,
``engine/supervisor.py``, then rebuilds the engine).

The reference gates the device-specific halves on its backend being a
TPU; the port gates them on ``device.type == "cuda"``. On the CPU the
same threads run, the step runs eagerly on the staged blocks, and
warmup runs each bucket once.

Every batch's stage clock (``ringbuf.STAGES``) is folded into
:class:`EngineStats` with the reference's unit accounting: an engine
whose items each carry up to ``max_units`` unit rows (a classify
engine's ROI budget) computes ``bucket × max_units`` rows a batch, of
which each item's ``units`` are real.

``ragged="packed"`` (``EVAM_RAGGED``, ``engine/ragged.py``) thins the
bucket ladder of every engine and, on a classify engine (one with a
``ragged_spec``), packs the real region rows into one fixed unit block
per batch (the ring seals ``seg`` as an extra step input) and hands each
item its own rows of the packed output.
``sched`` (``EVAM_SCHED``, ``sched/``) replaces the single queue with
per-class queues drained realtime-first under per-class deadlines,
shedding stale frames before they are staged; the dispatcher then
copies each batch into a slot itself (``SlotRing.stage_direct``). The
control plane's live operating point (``control/state.py``) scales the
batch deadlines and caps the batch in the dispatch loops, and
``retune`` resizes the upload queue. The fleet's mesh twin
(``fleet/engine.py``) is the one BatchEngine with ``data_size`` N > 1:
its ladder is aligned to N, with the rungs under N in front (the
reference's ``fleet_local`` bypass).

The AOT cache (``EVAM_AOT``, ``evam_tpu_torch/aot/``): a CUDA engine
loads the hand kernels' libraries its step launches (``step.libraries``)
before its first warm run, outside the device lock, so a cold library's
``nvcc`` never runs under it. With the cache on and the hub's program
fingerprint (``aot_key``), a bucket whose warm run compiled nothing,
every library it uses held by the store (loaded from it, in this
process or by an earlier one's entry, or stored after its build), is a
hit: its eager and capture seconds go to ``aot_load_seconds``, a
miss's to ``compile_seconds``. The graph is the per-bucket object, and a
CUDA graph cannot be stored, so the port keeps no per-bucket executable
(the reference's ``_aot_exec``). On the CPU nothing is compiled: no
hit, no miss.

Tracing (``obs/trace.py``): every item carries its frame's trace; the
dispatcher registers each batch (``batch_begin``) before the launcher
can take it, with the batch's own clock dict, so a pending record reads
the stages done so far, and exactly one ``batch_complete`` retires it
on whichever exit the batch takes: resolved (ok), a failed upload,
launch or readback or a stopped engine (error), or a quarantine
(abandoned). The fault injector's ``maybe_wedge`` is consulted per
batch on the launching thread, under the engine's device lock, just
before the replay: a woken wedge finds the engine stopped and never
replays a graph the quarantine freed. With PROFILING_MODE on, the
stages and the step run inside named ranges (``trace.prof_range``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch

from evam_tpu_torch import aot
from evam_tpu_torch.control.state import current_op
from evam_tpu_torch.engine import devlock, streams
from evam_tpu_torch.engine.ragged import (
    RaggedSpec,
    consolidate_buckets,
    ragged_mode,
)
from evam_tpu_torch.engine.ringbuf import (
    STAGES,
    SealedBatch,
    SlotRing,
    numpy_alloc,
    pinned_alloc,
)
from evam_tpu_torch.obs import trace
from evam_tpu_torch.obs.faults import current as active_faults
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.obs.trace import prof_range
from evam_tpu_torch.ops import kernels
from evam_tpu_torch.sched.classes import (
    DEFAULT_PRIORITY,
    PRIORITIES,
    ClassQueues,
    SchedConfig,
)
from evam_tpu_torch.sched.shedder import Shedder

log = logging.getLogger("evam_tpu_torch.engine.batcher")

__all__ = ["STAGES", "BatchEngine", "EngineStats"]


@dataclasses.dataclass
class _WorkItem:
    inputs: dict[str, np.ndarray]
    future: Future
    t_submit: float
    priority: str = DEFAULT_PRIORITY
    #: real unit rows the item carries (None: the whole budget)
    units: int | None = None
    #: the submitting frame's trace (``obs/trace.py`` FrameTrace), or None
    trace: object | None = None


class _TunableQueue(queue.Queue):
    """``queue.Queue`` whose bound the control plane can change live:
    growing it wakes blocked putters at once; shrinking applies as the
    consumer drains below the new bound (no staged batch is dropped)."""

    def set_depth(self, n: int) -> None:
        with self.mutex:
            self.maxsize = max(1, int(n))
            self.not_full.notify_all()


def _safe_set_result(fut: Future, value) -> None:
    """The watchdog may already have failed this future; a late result
    must not crash the completer."""
    try:
        fut.set_result(value)
    except Exception:  # noqa: BLE001 — InvalidStateError
        pass


def _safe_set_exception(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except Exception:  # noqa: BLE001 — InvalidStateError
        pass


@dataclasses.dataclass
class EngineStats:
    batches: int = 0
    items: int = 0
    occupancy_sum: float = 0.0
    #: real unit rows vs the unit rows the batches computed
    units: int = 0
    unit_slots: int = 0
    #: per-bucket dispatched-batch counts
    bucket_batches: dict[int, int] = dataclasses.field(default_factory=dict)
    #: buckets captured into CUDA graphs, and the wall seconds their
    #: warm run and capture took (a miss's: those of a hit go to
    #: aot_load_seconds)
    compiled_programs: int = 0
    compile_seconds: float = 0.0
    #: AOT-cache attribution (``evam_tpu_torch/aot/``): buckets whose
    #: warm run compiled nothing, every library from the store, and the
    #: wall seconds they took — /engines shows cold against warm
    #: spin-up (a hit shard: aot_hits == compiled_programs,
    #: compile_seconds 0)
    aot_hits: int = 0
    aot_load_seconds: float = 0.0
    #: captures that failed (each leaves its bucket eager, loudly)
    capture_failures: int = 0
    #: warm runs of the step (one per bucket warmed): real forwards
    #: that no batch carried
    warm_forwards: int = 0
    #: device bytes of the graphs' memory pool after warmup (None:
    #: the allocator's snapshot names no pools)
    graph_pool_bytes: int | None = 0
    #: extra batches made by splitting a formed batch past the top
    #: bucket (or, packed, past the top unit block) in order
    oversize_splits: int = 0
    #: cumulative per-stage host clock (seconds), keyed by STAGES
    stage_seconds: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.batches if self.batches else 0.0

    @property
    def unit_occupancy(self) -> float:
        """Real unit rows / computed unit rows (the pad tax that the
        per-item occupancy hides on a classify engine)."""
        return self.units / self.unit_slots if self.unit_slots else 0.0

    def absorb(self, other: "EngineStats") -> None:
        """Fold another engine's cumulative counters into this one (the
        supervisor's rebuild carry)."""
        for f in ("batches", "items", "occupancy_sum", "units",
                  "unit_slots", "compiled_programs", "compile_seconds",
                  "aot_hits", "aot_load_seconds",
                  "capture_failures", "warm_forwards",
                  "oversize_splits"):
            setattr(self, f, getattr(self, f) + getattr(other, f))
        self.graph_pool_bytes = other.graph_pool_bytes or self.graph_pool_bytes
        for b, c in other.bucket_batches.items():
            self.bucket_batches[b] = self.bucket_batches.get(b, 0) + c
        for k, v in other.stage_seconds.items():
            self.stage_seconds[k] = self.stage_seconds.get(k, 0.0) + v

    def add_stage(self, stage: str, dt: float) -> None:
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + dt

    def stage_ms_per_batch(self) -> dict[str, float]:
        """Mean per-batch host cost of each stage (ms)."""
        if not self.batches:
            return {}
        return {s: 1e3 * self.stage_seconds[s] / self.batches
                for s in STAGES if s in self.stage_seconds}


def stats_row(e, st: EngineStats) -> dict:
    """One engine's /engines row (a BatchEngine or its supervised
    handle) from a consistent snapshot ``st`` of its counters."""
    return {
        "batches": st.batches,
        "items": st.items,
        "mean_occupancy": st.mean_occupancy,
        "units": st.units,
        "unit_slots": st.unit_slots,
        "unit_occupancy": round(st.unit_occupancy, 4),
        "bucket_batches": {str(b): c for b, c in sorted(
            st.bucket_batches.items())},
        "warmed": e.warmed.is_set(),
        "assembly": e.assembly,
        "ragged": e.ragged,
        # effective mode: the devlock may force a pipelined request inline
        "transfer": "pipelined" if e._pipelined else "inline",
        "buckets": list(e.buckets),
        "compiled_programs": st.compiled_programs,
        "compile_s": round(st.compile_seconds, 3),
        # cold-against-warm spin-up: buckets warmed from the AOT store's
        # libraries and what their warm runs cost
        "aot": {"hits": st.aot_hits,
                "load_s": round(st.aot_load_seconds, 3)},
        "graphs": e.graphs_captured(),
        "graph_pool_bytes": st.graph_pool_bytes,
        "capture_failures": st.capture_failures,
        "warm_forwards": st.warm_forwards,
        "oversize_splits": st.oversize_splits,
        "stage_ms": st.stage_ms_per_batch(),
        "state": getattr(e, "state", "running"),
        "restarts": getattr(e, "restarts", 0),
        "last_stall_ts": getattr(e, "last_stall_ts", None),
        "queue_depth": e.queue_depth(),
        "queue_age_s": round(e.queue_age_s(), 3),
        "sched_queues": e.class_depths(),
    }


class BatchEngine:
    """Deadline-batching dispatcher around one step function.

    ``step_fn(*tensors) -> packed`` takes one stacked device tensor per
    input name (leading batch axis) and returns one tensor whose leading
    axis matches. Batches are padded to power-of-two buckets.
    ``max_units`` is the unit rows each item is padded to inside the
    step (None: one row per item; a ``ragged_spec``'s ``max_units``
    where one is given). ``assembly`` and ``transfer`` default to
    ``EVAM_BATCH_ASSEMBLY`` (``slot``) and ``EVAM_TRANSFER``
    (``pipelined``), as in the reference. ``ragged="packed"`` with a
    ``ragged_spec`` builds the packed engine (its step takes ``seg``
    after its inputs); an enabled ``sched`` the scheduler's dispatch."""

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {
        "stats": "_exec_lock",
        "_buckets_done": "_exec_lock",
        "_outstanding": "_exec_lock",
        "_next_batch_id": "_exec_lock",
    }

    def __init__(
        self,
        name: str,
        step_fn: Callable,
        device: torch.device | str,
        max_batch: int = 32,
        deadline_ms: float = 8.0,
        max_in_flight: int = 3,
        input_names: tuple[str, ...] = ("frames",),
        max_units: int | None = None,
        stall_timeout_s: float = 120.0,
        assembly: str | None = None,
        staging_depth: int | None = None,
        first_batch_grace: float = 10.0,
        transfer: str | None = None,
        transfer_depth: int | None = None,
        sched: SchedConfig | None = None,
        ragged: str | None = None,
        ragged_spec: RaggedSpec | None = None,
        data_size: int = 1,
        aot_key: str | None = None,
    ):
        self.name = name
        self.step_fn = step_fn
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.deadline_s = deadline_ms / 1000.0
        self.input_names = input_names
        if max_units is None and ragged_spec is not None:
            max_units = ragged_spec.max_units
        self.max_units = max_units
        self.stats = EngineStats()
        #: host batch assembly: "slot" (staging ring, default) or
        #: "legacy" (per-batch stack and pad), for A/B
        self.assembly = (assembly
                         or os.environ.get("EVAM_BATCH_ASSEMBLY", "slot"))
        if self.assembly not in ("slot", "legacy"):
            raise ValueError(
                f"EVAM_BATCH_ASSEMBLY must be 'slot' or 'legacy', "
                f"got {self.assembly!r}")
        #: device transfer: "pipelined" (default; a launcher thread) or
        #: "inline" (upload and launch back to back on the dispatcher);
        #: EVAM_SERIALIZE_COMPILE=1 forces inline
        self.transfer = transfer or os.environ.get(
            "EVAM_TRANSFER", "pipelined")
        if self.transfer not in ("pipelined", "inline"):
            raise ValueError(
                f"EVAM_TRANSFER must be 'pipelined' or 'inline', "
                f"got {self.transfer!r}")
        self._pipelined = (self.transfer == "pipelined"
                           and not devlock.enabled())
        #: ragged batching (EVAM_RAGGED): packing needs the staging
        #: ring, so the legacy assembly forces it off
        self.ragged = ragged_mode(ragged)
        if self.ragged == "packed" and self.assembly == "legacy":
            log.warning(
                "engine %s: EVAM_RAGGED=packed requires the slot "
                "staging ring; EVAM_BATCH_ASSEMBLY=legacy forces it "
                "off", name)
            self.ragged = "off"
        self.ragged_spec = ragged_spec
        self._packed = self.ragged == "packed" and ragged_spec is not None
        #: the step's inputs: the packed step takes the segment ids
        #: after the submitted inputs (the ring seals them per batch)
        self._step_inputs = (input_names + ("seg",) if self._packed
                             else input_names)
        if self._packed and "seg" in input_names:
            raise ValueError(
                f"engine {name}: input name 'seg' is reserved by the "
                "packed-ragged path")
        #: QoS scheduling (EVAM_SCHED): per-class queues, per-class
        #: deadlines, staleness shedding; None keeps the single queue
        self.sched = sched if (sched is not None and sched.enabled) else None
        self._classq = ClassQueues() if self.sched is not None else None
        self._shedder = (Shedder(name, self.sched.staleness_s())
                         if self.sched is not None else None)
        #: the device-specific halves: page-locked staging, copy and
        #: compute streams, events, CUDA graphs
        self._cuda = self.device.type == "cuda"
        #: watchdog bound on one batch's device round trip (0 disables)
        self.stall_timeout_s = stall_timeout_s
        #: a bucket that has not yet completed a batch gets
        #: stall_timeout_s × first_batch_grace
        self.first_batch_grace = first_batch_grace
        self._buckets_done: set[int] = set()
        #: set when a batch exceeded its stall deadline; submit() then
        #: fails fast. Cleared if the stalled call later completes.
        self.stalled = threading.Event()
        #: dispatched-but-not-completed batches in dispatch order: id →
        #: (t_dispatch, items, bucket, stall budget)
        self._outstanding: dict[
            int, tuple[float, list[_WorkItem], int, float]] = {}
        #: when a dispatched batch last left the device queue (completed
        #: or failed): the head batch's device work starts no earlier
        self._last_done = 0.0
        self._next_batch_id = 0
        self._exec_lock = threading.Lock()
        #: batches with a trace record still pending: the first exit to
        #: take one out retires it (``_trace_end``), so each batch is
        #: completed exactly once whichever thread gets there first
        self._traced: set[int] = set()
        #: the device a batch record names ("cuda:0", "cpu")
        self._trace_device = str(self.device)
        if self.device.type == "cuda" and self.device.index is None:
            self._trace_device = f"cuda:{torch.cuda.current_device()}"
        #: the hub's program fingerprint (the AOT cache's): with the
        #: cache on, warmup attributes each bucket to a hit or a miss;
        #: None never consults the cache
        self._aot_key = aot_key
        #: test seam: called on the launching thread before each
        #: batch's device work (outside the device lock) — a stub
        #: wedge blocks here
        self.pre_launch: Callable[[], None] | None = None

        #: the mesh twin's device count (``fleet/engine.py``
        #: ``MeshStep``): its rungs start at it and are multiples of it,
        #: so a bucket splits evenly over the devices; 1 elsewhere
        d = max(1, int(data_size))
        top = -(-max_batch // d) * d
        self.buckets = []
        b = d
        while b < top:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(top)
        if self.ragged == "packed":
            # bucket consolidation, on every engine of a packed hub:
            # adjacent buckets share a graph (engine/ragged.py)
            self.buckets = consolidate_buckets(self.buckets, align=d)
        #: the fleet's bypass (the reference's ``fleet_local``): an
        #: engine over several devices is the fleet's twin, and gets the
        #: rungs under its device count too, which its step runs on the
        #: first device alone — a trickle of batch traffic does not pay
        #: a gather for 2 real rows
        if d > 1:
            sub, r = [], 1
            while r < d:
                sub.append(r)
                r *= 2
            self.buckets = sub + self.buckets
        #: a step over several devices cannot be captured as one graph
        #: (``MeshStep.capturable``): its buckets run eagerly
        self._capturable = self._cuda and getattr(step_fn, "capturable",
                                                  True)
        #: output rows of the top bucket (unit rows when packed)
        self._out_rows = (ragged_spec.unit_rows(self.buckets[-1])
                          if self._packed else self.buckets[-1])

        depth = staging_depth or int(
            os.environ.get("EVAM_STAGING_DEPTH", "0")) or (max_in_flight + 1)
        self._ring = (SlotRing(capacity=self.buckets[-1], depth=depth,
                               alloc=pinned_alloc if self._cuda
                               else numpy_alloc,
                               ragged=ragged_spec if self._packed else None)
                      if self.assembly == "slot" else None)

        #: one engine's device work: the compute stream every batch
        #: launches on (in order), the copy stream pipelined uploads
        #: ride, and the per-bucket graphs. The device lock serializes
        #: a bucket's capture against this engine's own launches. The
        #: streams are the engine's own (``engine/streams.py``): created
        #: here, destroyed once its threads have exited.
        self._device_lock = threading.Lock()
        self._graphs = None
        self._compute = self._copy = None
        if self._cuda:
            from evam_tpu_torch.engine.graphs import StepGraphs

            self._compute = streams.create(self.device)
            self._copy = streams.create(self.device)
            self._graphs = StepGraphs(step_fn, self.device)
        self._device_freed = False

        self._queue: queue.Queue[_WorkItem | None] = queue.Queue()
        self._done: queue.Queue[tuple | None] = queue.Queue()
        #: pipelined only: uploaded batches awaiting launch. The live
        #: operating point's depth first, so a rebuild resumes at the
        #: controller's depth; retune() resizes it live
        op = current_op()
        live_depth = op.transfer_depth if op is not None else 0
        self.transfer_depth = max(1, int(live_depth
                                         or (transfer_depth or 2)))
        self._upload_q = _TunableQueue(maxsize=self.transfer_depth)
        self._warm_lock = threading.Lock()
        self._warming = False
        #: set when background warmup finishes (or fails)
        self.warmed = threading.Event()
        self._in_flight = threading.Semaphore(max_in_flight)
        self._stop = threading.Event()
        if self._classq is not None:
            dispatch_loop = self._dispatch_loop_sched
        elif self._ring is not None:
            dispatch_loop = self._dispatch_loop_slot
        else:
            dispatch_loop = self._dispatch_loop_legacy
        self._dispatcher = threading.Thread(
            target=self._thread_guard, args=(dispatch_loop,),
            name=f"engine-{name}-dispatch", daemon=True)
        self._completer = threading.Thread(
            target=self._thread_guard, args=(self._completion_loop,),
            name=f"engine-{name}-complete", daemon=True)
        self._launcher: threading.Thread | None = None
        if self._pipelined:
            self._launcher = threading.Thread(
                target=self._thread_guard, args=(self._launch_loop,),
                name=f"engine-{name}-launch", daemon=True)
            self._launcher.start()
        self._dispatcher.start()
        self._completer.start()
        if self.stall_timeout_s > 0:
            threading.Thread(target=self._watchdog_loop,
                             name=f"engine-{name}-watchdog",
                             daemon=True).start()

    def _thread_guard(self, loop_fn: Callable) -> None:
        """A worker loop that raises is an engine failure: logged here,
        seen by the supervisor through thread liveness."""
        try:
            loop_fn()
        except Exception:  # noqa: BLE001 — terminal thread failure
            log.exception(
                "engine %s worker thread %s died; the engine is wedged "
                "until the supervisor rebuilds it",
                self.name, threading.current_thread().name)

    # ------------------------------------------------------------- API

    def submit(self, priority: str = DEFAULT_PRIORITY,
               units: int | None = None, stream: str | None = None,
               trace: object | None = None,
               **inputs: np.ndarray) -> Future:
        """Enqueue one item (no batch dim); resolves to its packed row
        (on the packed engine: its own unit rows).

        ``priority`` selects the scheduling class with the scheduler on;
        without it the argument is accepted and ignored. ``stream`` is
        the submitting stream's identity: a single engine ignores it;
        the fleet (``fleet/engine.py``) pins a stream to a shard by it,
        and the stages pass it whatever the hub serves. ``units`` is
        the item's real unit rows, for the accounting only (the packed
        engine reads them off the ragged input). ``trace`` is the
        submitting frame's trace handle (or None): the batch record
        names it and its completion adds the queue-wait and dispatch
        spans to it. On the slot path this call copies the item into
        the staging block on the calling thread, and blocks while every
        slot is in flight; on the sched path the dispatcher copies it
        once its class is picked."""
        if self._stop.is_set():
            raise RuntimeError(f"engine {self.name} is stopped")
        if self.stalled.is_set():
            raise RuntimeError(
                f"engine {self.name} is stalled (device call exceeded "
                f"{self.stall_timeout_s:.0f}s)")
        if set(inputs) != set(self.input_names):
            raise ValueError(
                f"engine {self.name} expects inputs {self.input_names}, "
                f"got {tuple(inputs)}")
        if self._packed:
            units = int(np.asarray(inputs[self.ragged_spec.input]).shape[0])
        fut: Future = Future()
        if self._classq is not None:
            if priority not in PRIORITIES:
                raise ValueError(
                    f"unknown priority {priority!r}; valid: "
                    f"{'|'.join(PRIORITIES)}")
            item = _WorkItem(inputs, fut, time.perf_counter(), priority,
                             units, trace)
            try:
                self._classq.put(priority, item)
            except RuntimeError:
                raise RuntimeError(f"engine {self.name} is stopped") from None
            return fut
        item = _WorkItem(inputs, fut, time.perf_counter(), units=units,
                         trace=trace)
        if self._ring is not None:
            try:
                self._ring.write(inputs, item)
            except RuntimeError:
                raise RuntimeError(f"engine {self.name} is stopped") from None
        else:
            self._queue.put(item)
        return fut

    def queue_depth(self) -> int:
        """Items submitted but not yet dispatched."""
        if self._classq is not None:
            return self._classq.depth()
        if self._ring is not None:
            return self._ring.pending_items()
        return self._queue.qsize()

    def queue_age_s(self) -> float:
        """Age (s) of the oldest undispatched item; 0 when idle."""
        now = time.perf_counter()
        if self._classq is not None:
            return self._classq.oldest_age_s(now)
        if self._ring is not None:
            return self._ring.oldest_age_s(now)
        with self._queue.mutex:
            head = self._queue.queue[0] if self._queue.queue else None
        if isinstance(head, _WorkItem):
            return max(0.0, now - head.t_submit)
        return 0.0

    def class_depths(self) -> dict[str, int]:
        """Per-class queued depth ({} with the scheduler off)."""
        if self._classq is None:
            return {}
        return self._classq.depth_by_class()

    def shed_counts(self) -> dict[str, int]:
        """Per-class shed totals ({} with the scheduler off)."""
        if self._shedder is None:
            return {}
        return dict(self._shedder.counts)

    def retune(self, op) -> None:
        """Apply the controller's operating point to the one pushed
        knob, the upload-queue depth (scalar setpoints are read per
        dispatch). Never blocks a dispatcher: a resize takes the queue's
        own mutex only."""
        depth = int(op.transfer_depth or 0)
        if depth and depth != self.transfer_depth:
            self.transfer_depth = max(1, depth)
            self._upload_q.set_depth(self.transfer_depth)

    def graphs_captured(self) -> int:
        return len(self._graphs) if self._graphs is not None else 0

    def stats_row(self) -> dict:
        """Consistent snapshot of the engine's counters."""
        with self._exec_lock:
            return stats_row(self, self.stats)

    def warmup(self) -> None:
        """Prepare every bucket ahead of traffic: on the card, warm it
        and capture its CUDA graph; on the CPU, run its warm batch once
        (as the reference's CPU jit warms). A failed capture is logged
        and counted (``capture_failures``) and leaves its bucket on the
        eager step. On the card the step's libraries are loaded first,
        outside the device lock; with the AOT cache on and an
        ``aot_key``, each bucket is a hit or a miss (``EngineStats``)."""
        example = self._example_item()
        cache = (aot.active() if self._aot_key is not None and self._cuda
                 else None)
        # the first bucket's clock includes the library loads
        t_load = time.perf_counter()
        builds = kernels.builds()
        libraries = ("engine_cuda",) + tuple(
            getattr(self.step_fn, "libraries", ()))
        if self._cuda:
            for name in libraries:
                kernels.load(name)
            if self._ring is not None:
                # the slots' page-locking is paid here, not by the
                # frames of the first batch
                self._ring.prepare(example)
        for b in self.buckets:
            if self._stop.is_set():
                return
            batch = self._warm_batch(example, b)
            t0 = time.perf_counter() if t_load is None else t_load
            t_load = None
            with devlock.device_call(f"{self.name}:warmup"):
                try:
                    if self._capturable:
                        # the warm run overlaps this engine's launches;
                        # the capture holds its device lock
                        self._graphs.capture(
                            b, [batch[n] for n in self._step_inputs],
                            self._device_lock)
                    else:
                        self.step_fn(*[torch.from_numpy(batch[n]).to(
                            self.device) for n in self._step_inputs])
                except Exception:  # noqa: BLE001 — counted, never hidden
                    if self._stop.is_set():
                        return
                    log.exception("engine %s: warmup of bucket %d failed",
                                  self.name, b)
                    if self._capturable:
                        with self._exec_lock:
                            self.stats.capture_failures += 1
                    builds = kernels.builds()
                    continue
            # a hit: the warm run (the first one's library loads
            # included) compiled nothing, every library from the store
            hit = (cache is not None and kernels.builds() == builds
                   and kernels.from_store(libraries))
            builds = kernels.builds()
            dt = time.perf_counter() - t0
            with self._exec_lock:
                self.stats.warm_forwards += 1
                if self._capturable:
                    self.stats.compiled_programs += 1
                    if hit:
                        self.stats.aot_hits += 1
                        self.stats.aot_load_seconds += dt
                    else:
                        self.stats.compile_seconds += dt
                # a warmed bucket gets the plain watchdog budget
                self._buckets_done.add(b)
        if self._cuda:
            pool = self._graphs.pool_bytes()
            with self._exec_lock:
                self.stats.graph_pool_bytes = pool
        log.info("engine %s warmed %d buckets %s (%d graphs); eager and "
                 "capture seconds by bucket %s", self.name, len(self.buckets),
                 self.buckets, self.graphs_captured(),
                 json.dumps({str(b): [round(e, 4), round(c, 4)] for b, (e, c)
                             in sorted(self._graphs.timings.items())}
                            if self._graphs is not None else {}))

    def _warm_batch(self, example: dict[str, np.ndarray],
                    b: int) -> dict[str, np.ndarray]:
        """Bucket-``b`` warmup batch from a per-item example. The packed
        engine warms the packed shapes: the unit block and ``seg`` at
        ``unit_rows(b)``, all pad (seg −1)."""
        spec = self.ragged_spec
        batch: dict[str, np.ndarray] = {}
        for k, v in example.items():
            if self._packed and k == spec.input:
                batch[k] = np.zeros(
                    (spec.unit_rows(b),) + tuple(spec.unit_shape),
                    spec.dtype)
            else:
                batch[k] = np.broadcast_to(v, (b,) + v.shape).copy()
        if self._packed:
            batch["seg"] = np.full((spec.unit_rows(b),), -1, np.int32)
        return batch

    def warm_async(self, **example: np.ndarray) -> None:
        """Fire-and-forget bucket warmup (the serving path: no bucket's
        first batch pays the eager step). Idempotent."""
        with self._warm_lock:
            if self._warming:
                return
            self._warming = True
        self.set_example(**example)
        self._warm_thread = threading.Thread(
            target=self._warm_guarded, name=f"engine-{self.name}-warmup",
            daemon=True)
        self._warm_thread.start()

    def _warm_guarded(self) -> None:
        try:
            self.warmup()
        except Exception as exc:  # noqa: BLE001 — warmup must never kill serving
            log.warning("engine %s warmup failed: %s", self.name, exc)
        finally:
            self.warmed.set()

    def set_example(self, **example: np.ndarray) -> None:
        self._peek_shapes = {k: np.asarray(v) for k, v in example.items()}

    #: name → example array (no batch dim) for warmup
    _peek_shapes: dict[str, np.ndarray] | None = None
    #: the background warmup (``warm_async``), joined by ``stop``
    _warm_thread: threading.Thread | None = None

    def _example_item(self) -> dict[str, np.ndarray]:
        item = self._peek_shapes
        if item is None:
            raise RuntimeError("warmup requires an example (set_example)")
        return item

    def stop(self) -> None:
        """Stop every thread; futures not yet resolved fail; the graphs,
        their pool and the staging buffers are freed — after a background
        warmup has finished the bucket it is capturing (it checks the stop
        flag between buckets), so no capture outlives the engine or runs
        into the interpreter's exit."""
        self._stop.set()
        if self._classq is not None:
            self._classq.close()
        if self._ring is not None:
            self._ring.close()
        self._queue.put(None)
        self._dispatcher.join(timeout=10)
        if self._launcher is not None:
            try:
                self._upload_q.put_nowait(None)
            except queue.Full:
                pass  # the launcher drains the backlog, then exits on _stop
            self._launcher.join(timeout=10)
        self._done.put(None)
        self._completer.join(timeout=10)
        exc = RuntimeError(f"engine {self.name} stopped")
        self._drain_upload_q(exc)
        self._drain_queued(exc)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _safe_set_exception(item.future, exc)
        warm = self._warm_thread
        if warm is not None and warm is not threading.current_thread():
            warm.join(timeout=60)
            if warm.is_alive():
                log.error("engine %s: warmup still running after 60 s",
                          self.name)
        self._free_device()
        alive = [t.name for t in self._threads() if t.is_alive()]
        if alive:
            # a thread that outlived its join may still touch a stream
            log.error("engine %s: %s still running; its streams are "
                      "left alive", self.name, alive)
        else:
            self._destroy_streams()

    def abandon(self) -> None:
        """Quarantine teardown (supervisor): fail every failable caller
        WITHOUT joining the worker threads — a wedged launcher may be
        blocked indefinitely, and the supervisor must not inherit that
        wait. The threads exit on their own when they wake; the device
        state is freed by a thread that waits for the engine's device
        lock (held only inside a device call). Idempotent."""
        self._stop.set()
        exc = TimeoutError(
            f"engine {self.name} quarantined: wedged device call; the "
            "supervisor is rebuilding the engine")
        if self._classq is not None:
            self._classq.close()
        if self._ring is not None:
            self._ring.close()
        self._drain_queued(exc)
        self._queue.put(None)
        self._done.put(None)
        self._drain_upload_q(exc, "abandoned")
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                _safe_set_exception(item.future, exc)
        with self._exec_lock:
            stranded = list(self._outstanding.items())
            self._outstanding.clear()
        for bid, (_t0, items, _b, _budget) in stranded:
            for it in items:
                _safe_set_exception(it.future, exc)
            self._trace_end(bid, items, "abandoned")
        threading.Thread(target=self._free_after_exit,
                         name=f"engine-{self.name}-free",
                         daemon=True).start()

    def _threads(self) -> list[threading.Thread]:
        """The engine's worker threads (those the caller is not)."""
        return [t for t in (self._dispatcher, self._launcher,
                            self._completer, self._warm_thread)
                if t is not None and t is not threading.current_thread()]

    def _free_after_exit(self) -> None:
        """Quarantine: free the device state once no device call of the
        engine runs, and destroy its streams once every one of its
        threads has exited (a wedged one wakes and exits on the stop
        flag; until then the streams stay)."""
        self._free_device()
        for t in self._threads():
            t.join()
        self._destroy_streams()

    def _destroy_streams(self) -> None:
        """Destroy the engine's streams, after :meth:`_free_device` and
        once no thread of the engine can launch on them."""
        if not self._cuda:
            return
        self._graphs.close()
        torch.cuda.synchronize(self.device)
        streams.destroy(self._copy)
        streams.destroy(self._compute)

    def owned_streams(self) -> list[int]:
        """The handles of the engine's own streams (compute, copy,
        capture)."""
        if not self._cuda:
            return []
        return [self._compute.cuda_stream, self._copy.cuda_stream,
                self._graphs.stream.cuda_stream]

    def _free_device(self) -> None:
        """Free the graphs, their pool and the per-slot device and
        page-locked buffers, once no device call of this engine runs."""
        if not self._cuda:
            return
        with self._device_lock:
            if self._device_freed:
                return
            self._device_freed = True
            self._compute.synchronize()
            self._copy.synchronize()
            if self._ring is not None:
                for slot in self._ring.slots():
                    slot.device.clear()
            self._graphs.free()

    # -------------------------------------------------------- internals

    def _drain_queued(self, exc: BaseException) -> None:
        """Fail every item in the class queues and the staging ring
        (stop, abandon, stall)."""
        if self._classq is not None:
            for item in self._classq.drain():
                _safe_set_exception(item.future, exc)
        if self._ring is not None:
            for item in self._ring.drain_items():
                _safe_set_exception(item.future, exc)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} items exceed the top bucket {self.buckets[-1]}")

    def _bucket_ragged(self, n: int, units: int) -> int:
        """The packed engine's bucket: the smallest rung that fits both
        the item rows and the packed unit rows."""
        spec = self.ragged_spec
        for b in self.buckets:
            if n <= b and units <= spec.unit_rows(b):
                return b
        return self.buckets[-1]

    def _count_oversize_split(self, extra: int) -> None:
        with self._exec_lock:
            self.stats.oversize_splits += extra
        metrics.inc("evam_engine_oversize_splits", float(extra),
                    labels={"engine": self.name})

    def _split_oversize(self, items: list[_WorkItem]) -> list[list[_WorkItem]]:
        """Chunk a formed batch at the top bucket, in order (a batch
        formed under ``max_batch`` can outgrow a ladder shrunk under
        it); each extra chunk counts on ``evam_engine_oversize_splits``."""
        top = self.buckets[-1]
        if len(items) <= top:
            return [items]
        chunks = [items[i:i + top] for i in range(0, len(items), top)]
        self._count_oversize_split(len(chunks) - 1)
        return chunks

    def _trace_begin(self, items: list[_WorkItem], n: int, b: int,
                     clock: dict[str, float]) -> int:
        """A new batch id; with tracing on, the batch's pending record
        (holding ``clock`` itself, which the engine goes on filling)."""
        with self._exec_lock:
            bid = self._next_batch_id
            self._next_batch_id += 1
            if trace.active() is not None:
                self._traced.add(bid)
        trace.batch_begin(self.name, bid, items, b, n, clock,
                          self._trace_device)
        return bid

    def _trace_end(self, bid: int, items: list[_WorkItem], status: str,
                   readback_s: float | None = None,
                   resolve_s: float | None = None) -> None:
        """Retire batch ``bid``'s trace record once, whichever exit
        gets here first."""
        with self._exec_lock:
            if bid not in self._traced:
                return
            self._traced.discard(bid)
        trace.batch_complete(self.name, bid, items, status=status,
                             readback_s=readback_s, resolve_s=resolve_s)

    def _track_dispatch(self, t0: float, items: list[_WorkItem],
                        bucket: int, bid: int) -> None:
        """Register dispatched batch ``bid`` with the watchdog, with its
        stall budget: stall_timeout_s, × first_batch_grace for a bucket
        that never completed a batch. Device work is ordered, so the
        watchdog holds only the head of the queue to its budget, from
        when it could start (``_watchdog_loop``)."""
        with self._exec_lock:
            budget = self.stall_timeout_s
            if bucket not in self._buckets_done:
                budget *= self.first_batch_grace
            self._outstanding[bid] = (t0, items, bucket, budget)

    def refresh_queue_gauges(self) -> None:
        """Push the backlog gauges (on dispatch and on watchdog and
        supervisor ticks, so an idle or wedged engine's stay live)."""
        metrics.set("evam_engine_queue_depth", self.queue_depth(),
                    {"engine": self.name})
        metrics.set("evam_engine_queue_age_s", self.queue_age_s(),
                    {"engine": self.name})

    def _record_batch(self, n: int, b: int, clock: dict[str, float],
                      items: list[_WorkItem],
                      sealed: SealedBatch | None = None) -> None:
        """Count a launched batch — before its futures can resolve, so
        a caller that has every result sees every batch counted. A
        packed batch knows its real and computed unit rows exactly."""
        with self._exec_lock:
            st = self.stats
            st.batches += 1
            st.items += n
            st.occupancy_sum += n / b
            if sealed is not None and sealed.row_len is not None:
                st.units += sealed.units
                st.unit_slots += sealed.unit_rows
            elif self.max_units is None:
                st.unit_slots += b
                st.units += n
            else:
                st.unit_slots += b * self.max_units
                st.units += sum(self.max_units if it.units is None
                                else it.units for it in items)
            st.bucket_batches[b] = st.bucket_batches.get(b, 0) + 1
            for stage, dt in clock.items():
                st.add_stage(stage, dt)
            mean_occ, unit_occ = st.mean_occupancy, st.unit_occupancy
        metrics.observe("evam_batch_occupancy", n / b, {"engine": self.name})
        metrics.set("evam_engine_occupancy", mean_occ, {"engine": self.name})
        metrics.set("evam_engine_unit_occupancy", unit_occ,
                    {"engine": self.name})
        self.refresh_queue_gauges()
        for stage, dt in clock.items():
            metrics.observe("evam_engine_stage_seconds", dt,
                            {"engine": self.name, "stage": stage})

    # ----------------------------------------------- device halves

    def _upload(self, batch: dict[str, np.ndarray], b: int,
                sealed: SealedBatch | None, stream) -> list[torch.Tensor]:
        """Host batch → step inputs. CPU: tensors over the staged
        arrays (no copy). CUDA: an asynchronous copy on ``stream`` —
        from the page-locked slot into device buffers the slot owns, or
        (legacy assembly) of the freshly stacked arrays."""
        if not self._cuda:
            return [torch.from_numpy(batch[n]) for n in self._step_inputs]
        with torch.cuda.stream(stream):
            if sealed is None:
                return [torch.from_numpy(batch[n]).to(
                    self.device, non_blocking=True) for n in self.input_names]
            slot = sealed.slot
            dev = slot.device
            out = []
            for n in self._step_inputs:
                block = slot.seg if n == "seg" else slot.arrays[n]
                if n not in dev:
                    dev[n] = torch.empty(
                        block.shape, device=self.device,
                        dtype=torch.from_numpy(block[:0]).dtype)
                # b rows, or the packed block's unit rows
                dst = dev[n][:batch[n].shape[0]]
                dst.copy_(torch.from_numpy(batch[n]), non_blocking=True)
                out.append(dst)
            return out

    def _wedge_point(self) -> None:
        """The fault injector's per-batch consult (EVAM_FAULT_INJECT
        ``wedge``): a wedge blocks here, on the launching thread, where
        the device call would hang; a woken wedge finds a quarantined
        engine stopped and launches nothing."""
        inj = active_faults()
        if inj is not None:
            inj.maybe_wedge(self.name)
            if self._stop.is_set():
                raise RuntimeError(f"engine {self.name} is stopped")

    def _execute(self, dev: list[torch.Tensor], b: int,
                 sealed: SealedBatch | None):
        """Launch one batch; returns what the completer reads back.
        CUDA: under the device lock (the wedge consult first, so a
        quarantine frees nothing a woken wedge could still replay), on
        the compute stream, the bucket's graph replay (or the eager
        step), then the device→host copy into page-locked memory put in
        flight, and an event the completer waits on. CPU: the step's
        output."""
        if not self._cuda:
            self._wedge_point()
            with prof_range("step"):
                return self.step_fn(*dev)
        with self._device_lock:
            self._wedge_point()
            if self._device_freed:
                raise RuntimeError(f"engine {self.name} stopped")
            with torch.cuda.stream(self._compute), prof_range("step"):
                bg = self._graphs.get(b)
                out = (self._graphs.replay(bg, dev) if bg is not None
                       else self.step_fn(*dev))
                if sealed is None:
                    # stacked on another stream: keep its memory
                    # until this stream is done with it
                    for t in dev:
                        t.record_stream(self._compute)
                    host = torch.empty(out.shape, dtype=out.dtype,
                                       pin_memory=True)
                else:
                    slot = sealed.slot.device
                    if "readback" not in slot:
                        # sized for the top bucket's output rows: its
                        # unit rows on the packed engine
                        slot["readback"] = streams.pinned_tensor(
                            (self._out_rows,) + tuple(out.shape[1:]),
                            out.dtype)
                    host = slot["readback"][:out.shape[0]]
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self._compute)
        return host, done

    def _readback(self, pending) -> np.ndarray:
        if not self._cuda:
            return pending.cpu().numpy()
        host, done = pending
        done.synchronize()
        return host.numpy()

    def _before_launch(self) -> None:
        hook = self.pre_launch
        if hook is not None:
            hook()
        if self._stop.is_set():
            raise RuntimeError(f"engine {self.name} is stopped")

    def _run(self, batch: dict[str, np.ndarray], b: int,
             sealed: SealedBatch | None, clock: dict[str, float]):
        """Inline transfer (EVAM_TRANSFER=inline, and the devlock-forced
        mode): upload and launch back to back on the calling thread, in
        stream order on the compute stream. h2d_wait is 0 by
        definition: the launch absorbs the upload."""
        self._before_launch()
        with devlock.device_call(f"{self.name}:launch"):
            t0 = time.perf_counter()
            with prof_range("h2d_issue"):
                dev = self._upload(batch, b, sealed, self._compute)
            t1 = time.perf_counter()
            # written before the launch: a wedged batch's record reads
            # every stage up to the launch
            clock["h2d_issue"] = t1 - t0
            clock["h2d_wait"] = 0.0
            with prof_range("launch"):
                pending = self._execute(dev, b, sealed)
            clock["launch"] = time.perf_counter() - t1
            return pending

    def _dispatch_batch(self, batch: dict[str, np.ndarray],
                        items: list[_WorkItem], n: int, b: int,
                        clock: dict[str, float],
                        sealed: SealedBatch | None) -> None:
        """Common tail of both dispatch loops. Inline: upload and launch
        here. Pipelined: issue the upload on the copy stream
        (h2d_issue) and queue the batch for the launcher."""
        # the batch's trace record, before any device work and before
        # the launcher can touch the clock
        bid = self._trace_begin(items, n, b, clock)
        if not self._pipelined:
            self._in_flight.acquire()
            t0 = time.perf_counter()
            self._track_dispatch(t0, items, b, bid)
            try:
                pending = self._run(batch, b, sealed, clock)
            except Exception as exc:  # noqa: BLE001 — surface to every caller
                self._fail_launch(exc, bid, items, sealed)
                return
            self._record_batch(n, b, clock, items, sealed)
            self._done.put((pending, items, t0, bid, sealed, n))
            return
        try:
            with devlock.device_call(f"{self.name}:h2d"), \
                    prof_range("h2d_issue"):
                t0 = time.perf_counter()
                dev = self._upload(batch, b, sealed, self._copy)
                uploaded = None
                if self._cuda:
                    uploaded = torch.cuda.Event()
                    uploaded.record(self._copy)
                clock["h2d_issue"] = time.perf_counter() - t0
        except Exception as exc:  # noqa: BLE001 — surface to every caller
            for it in items:
                _safe_set_exception(it.future, exc)
            if sealed is not None:
                self._ring.release(sealed)
            self._trace_end(bid, items, "error")
            log.exception("engine %s H2D upload failed", self.name)
            return
        entry = (dev, uploaded, items, n, b, clock, sealed, bid)
        while True:
            try:
                self._upload_q.put(entry, timeout=0.1)
                return
            except queue.Full:
                if self._stop.is_set():
                    exc = RuntimeError(f"engine {self.name} is stopped")
                    for it in items:
                        _safe_set_exception(it.future, exc)
                    if sealed is not None:
                        self._ring.release(sealed)
                    self._trace_end(bid, items, "error")
                    return

    def _fail_launch(self, exc: Exception, bid: int, items: list[_WorkItem],
                     sealed: SealedBatch | None) -> None:
        self._in_flight.release()
        with self._exec_lock:
            self._outstanding.pop(bid, None)
            self._last_done = time.perf_counter()
        for it in items:
            _safe_set_exception(it.future, exc)
        if sealed is not None:
            self._ring.release(sealed)
        self._trace_end(bid, items, "error")
        if not self._stop.is_set():
            log.error("engine %s step failed", self.name, exc_info=exc)

    def _launch(self, dev: list[torch.Tensor], uploaded, b: int,
                sealed: SealedBatch | None, clock: dict[str, float]):
        """Launcher half of the pipelined transfer: wait out the
        upload's residual (h2d_wait), then launch on the compute stream
        behind it, the device→host copy put in flight at once."""
        self._before_launch()
        with devlock.device_call(f"{self.name}:launch"):
            t0 = time.perf_counter()
            with prof_range("h2d_wait"):
                if uploaded is not None:
                    uploaded.synchronize()
                    self._compute.wait_event(uploaded)
            t1 = time.perf_counter()
            # written before the launch: a wedged batch's record reads
            # every stage up to the launch
            clock["h2d_wait"] = t1 - t0
            with prof_range("launch"):
                pending = self._execute(dev, b, sealed)
            clock["launch"] = time.perf_counter() - t1
        return pending

    def _launch_loop(self) -> None:
        """Pipelined transfer: pop uploaded batches and launch them —
        while this thread launches (or is wedged), the dispatcher keeps
        sealing and uploading."""
        while True:
            try:
                entry = self._upload_q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    break
                continue
            if entry is None:
                break
            dev, uploaded, items, n, b, clock, sealed, bid = entry
            if self._stop.is_set():
                exc = RuntimeError(f"engine {self.name} is stopped")
                for it in items:
                    _safe_set_exception(it.future, exc)
                if sealed is not None:
                    self._ring.release(sealed)
                self._trace_end(bid, items, "error")
                continue
            self._in_flight.acquire()
            t0 = time.perf_counter()
            self._track_dispatch(t0, items, b, bid)
            try:
                pending = self._launch(dev, uploaded, b, sealed, clock)
            except Exception as exc:  # noqa: BLE001 — surface to every caller
                self._fail_launch(exc, bid, items, sealed)
                continue
            self._record_batch(n, b, clock, items, sealed)
            self._done.put((pending, items, t0, bid, sealed, n))

    def _drain_upload_q(self, exc: Exception,
                        status: str = "error") -> None:
        """Fail every uploaded-but-unlaunched batch (stop, abandon,
        stall); ``status`` retires their trace records."""
        while True:
            try:
                entry = self._upload_q.get_nowait()
            except queue.Empty:
                return
            if entry is None:
                continue
            items, sealed, bid = entry[2], entry[6], entry[7]
            for it in items:
                _safe_set_exception(it.future, exc)
            if sealed is not None:
                self._ring.release(sealed)
            self._trace_end(bid, items, status)

    # ------------------------------------------------- dispatch loops

    def _dispatch_loop_sched(self) -> None:
        """QoS dispatch: drain the class queues realtime-first (a pick
        no class can starve), form each batch under its class deadline,
        and shed frames past their class staleness budget (oldest
        first) before they are staged."""
        cq = self._classq
        shedder = self._shedder
        while True:
            if self._stop.is_set():
                exc = RuntimeError(f"engine {self.name} stopped")
                for it in cq.drain():
                    _safe_set_exception(it.future, exc)
                break
            shedder.sweep(cq)
            cls = cq.pick(timeout=0.05)
            if cls is None:
                continue
            # live setpoints: one None check with EVAM_TUNE off
            op = current_op()
            cap = self.max_batch
            deadline = self.sched.deadline_s(cls)
            if op is not None:
                if op.batch_cap:
                    cap = min(cap, op.batch_cap)
                deadline *= op.deadline_scale
            with prof_range("submit_wait"):
                items = cq.collect(cls, cap, deadline)
            # the formation wait itself can age items past budget
            items = shedder.shed(cls, items)
            if not items:
                continue
            self._launch_sched(items)

    def _launch_sched(self, items: list[_WorkItem]) -> None:
        """Assemble and dispatch one class-ordered batch: through the
        staging ring (the copies on this thread), or stacked when
        EVAM_BATCH_ASSEMBLY=legacy. A pick past the slot's rows — or,
        packed, its unit block — is split across batches in order, and
        each extra batch counts as an oversize split."""
        if self._ring is not None:
            bucket_fn = self._bucket_ragged if self._packed else self._bucket
            staged = [(it.inputs, it) for it in items]
            dispatched = 0
            while staged:
                clock: dict[str, float] = {
                    "submit_wait": time.perf_counter() - staged[0][1].t_submit,
                }
                try:
                    sealed, staged = self._ring.stage_direct(
                        staged, bucket_fn, clock)
                except RuntimeError:
                    exc = RuntimeError(f"engine {self.name} is stopped")
                    for _, it in staged:
                        _safe_set_exception(it.future, exc)
                    return
                if sealed is None:
                    continue  # every staged row failed its shape check
                dispatched += 1
                self._dispatch_batch(sealed.arrays, sealed.items, sealed.n,
                                     sealed.bucket, sealed.clock, sealed)
            if dispatched > 1:
                self._count_oversize_split(dispatched - 1)
            return
        for chunk in self._split_oversize(items):
            self._dispatch_stacked(chunk)

    def _dispatch_loop_slot(self) -> None:
        """Seal staged slots at the batch deadline and dispatch them —
        no stack, no pad concat, no per-batch allocation."""
        bucket_fn = self._bucket_ragged if self._packed else self._bucket
        while True:
            op = current_op()
            deadline = (self.deadline_s * op.deadline_scale
                        if op is not None else self.deadline_s)
            sealed = self._ring.next_batch(deadline, bucket_fn)
            if sealed is None:
                if self._stop.is_set():
                    break
                continue
            if self._stop.is_set():
                exc = RuntimeError(f"engine {self.name} stopped")
                for it in sealed.items:
                    _safe_set_exception(it.future, exc)
                self._ring.release(sealed)
                continue  # drain whatever else is staged, then exit
            self._dispatch_batch(sealed.arrays, sealed.items, sealed.n,
                                 sealed.bucket, sealed.clock, sealed)

    def _dispatch_loop_legacy(self) -> None:
        """EVAM_BATCH_ASSEMBLY=legacy: gather until the deadline or the
        top bucket, stack and zero-pad on the dispatcher thread."""
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            op = current_op()
            cap = self.max_batch
            deadline_s = self.deadline_s
            if op is not None:
                if op.batch_cap:
                    cap = min(cap, op.batch_cap)
                deadline_s *= op.deadline_scale
            items = [first]
            deadline = time.perf_counter() + deadline_s
            while len(items) < cap:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop.set()
                    break
                items.append(nxt)
            for chunk in self._split_oversize(items):
                self._dispatch_stacked(chunk)

    def _dispatch_stacked(self, items: list[_WorkItem]) -> None:
        """The legacy assembly of one batch no larger than the top
        bucket: stack and zero-pad on the dispatcher thread, then
        dispatch. A failure fails the batch's items, never the thread."""
        n = len(items)
        clock = {"submit_wait": time.perf_counter() - items[0].t_submit}
        t_asm = time.perf_counter()
        try:
            b = self._bucket(n)
            batch = {}
            for name in self.input_names:
                stacked = np.stack([it.inputs[name] for it in items])
                if b > n:
                    pad = np.zeros((b - n,) + stacked.shape[1:],
                                   stacked.dtype)
                    stacked = np.concatenate([stacked, pad])
                batch[name] = stacked
        except Exception as exc:  # noqa: BLE001 — surface to every caller
            for it in items:
                _safe_set_exception(it.future, exc)
            return
        clock["slot_write"] = time.perf_counter() - t_asm
        self._dispatch_batch(batch, items, n, b, clock, None)

    # ------------------------------------------------------ completion

    def _completion_loop(self) -> None:
        while True:
            entry = self._done.get()
            if entry is None:
                break
            pending, items, t0, bid, sealed, n = entry
            t_rb = time.perf_counter()
            try:
                with devlock.device_call(f"{self.name}:readback"), \
                        prof_range("readback"):
                    host = self._readback(pending)
                # each row copied out: the slot's output block, and the
                # step's own output where it aliases the staged input,
                # are reused by later batches
                ragged = sealed is not None and sealed.row_len is not None
                rows = np.array(host[:sealed.units if ragged else n])
            except Exception as exc:  # noqa: BLE001
                for it in items:
                    _safe_set_exception(it.future, exc)
                self._in_flight.release()
                with self._exec_lock:
                    self._outstanding.pop(bid, None)
                    self._last_done = time.perf_counter()
                if sealed is not None:
                    self._ring.release(sealed)
                self._trace_end(bid, items, "error")
                continue
            with self._exec_lock:
                done = self._outstanding.pop(bid, None)
                self._last_done = time.perf_counter()
                if done is not None:
                    self._buckets_done.add(done[2])
            self._in_flight.release()
            if sealed is not None:
                self._ring.release(sealed)
            if self.stalled.is_set():
                # the stalled call was merely slow and has completed
                self.stalled.clear()
                log.warning("engine %s recovered: a stalled device call "
                            "completed; accepting work again", self.name)
            now = time.perf_counter()
            metrics.observe("evam_step_seconds", now - t0,
                            {"engine": self.name})
            readback_s = now - t_rb
            t_res = time.perf_counter()
            with prof_range("resolve"):
                for i, it in enumerate(items):
                    metrics.observe("evam_item_latency_seconds",
                                    now - it.t_submit, {"engine": self.name})
                    if ragged:
                        # item i owns its packed unit rows (none: an
                        # empty slice)
                        off = int(sealed.row_offset[i])
                        _safe_set_result(
                            it.future,
                            rows[off:off + int(sealed.row_len[i])])
                    else:
                        _safe_set_result(it.future, rows[i])
            resolve_s = time.perf_counter() - t_res
            # retire the batch record: the queue-wait and dispatch spans
            # of every member frame, and the completion-side stages
            self._trace_end(bid, items, "ok", readback_s=readback_s,
                            resolve_s=resolve_s)
            with self._exec_lock:
                self.stats.add_stage("readback", readback_s)
                self.stats.add_stage("resolve", resolve_s)
            metrics.observe("evam_engine_stage_seconds", readback_s,
                            {"engine": self.name, "stage": "readback"})
            metrics.observe("evam_engine_stage_seconds", resolve_s,
                            {"engine": self.name, "stage": "resolve"})

    def _watchdog_loop(self) -> None:
        """Fail futures stranded behind a stalled device call and flag
        the engine (the wedged thread itself cannot be unblocked). The
        head of the ordered device queue is stalled once it has run its
        budget past the later of its dispatch and the last batch that
        left the queue; everything behind it is stranded with it. (A
        deadline fixed at dispatch and floored at the batch ahead's
        deadline plus a budget, the reference's rule, ratchets up by a
        budget with every batch dispatched while another is in flight:
        under steady load a wedge would go unseen.)"""
        # floor 0.2 s: tests run sub-second stall budgets
        interval = max(self.stall_timeout_s / 4.0, 0.2)
        while not self._stop.wait(interval):
            self.refresh_queue_gauges()
            now = time.perf_counter()
            with self._exec_lock:
                slots = list(self._outstanding.values())
                last_done = self._last_done
            if not slots:
                continue
            t0, _items, _b, budget = slots[0]
            if now <= max(t0, last_done) + budget:
                continue
            stuck = [it for _t0, items, _b, _budget in slots for it in items]
            self.stalled.set()
            log.error(
                "engine %s stalled: device call exceeded %.0fs; failing "
                "%d stranded item(s) and rejecting new work",
                self.name, self.stall_timeout_s, len(stuck))
            metrics.inc("evam_engine_stalls", labels={"engine": self.name})
            exc = TimeoutError(
                f"engine {self.name} device call exceeded "
                f"{self.stall_timeout_s:.0f}s (backend wedged)")
            for it in stuck:
                _safe_set_exception(it.future, exc)
            self._drain_upload_q(exc)
            self._drain_queued(exc)
            while True:
                try:
                    queued = self._queue.get_nowait()
                except queue.Empty:
                    break
                if queued is not None:
                    _safe_set_exception(queued.future, exc)
