"""The shared batch engine (counterpart of ``evam_tpu/engine/batcher.py``).

ONE engine per model instance multiplexes every stream that submits to
it. This is the reference's core engine on its legacy assembly path
(``_dispatch_loop_legacy``):

  submit() ──queue──► dispatcher ──done queue──► completer

* ``submit(units=None, **inputs)`` (stream threads) enqueues one item
  — one array per input name, e.g. ``frames`` and ``boxes`` for a
  classify engine — and returns a ``Future``;
* the **dispatcher** thread waits for a first item, gathers more until
  the batch deadline or ``max_batch``, stacks and zero-pads them to a
  power-of-two bucket, copies the batch to the device and launches the
  step — without waiting for its result;
* the **completer** thread reads each batch's packed output back to the
  host (the one device→host copy per batch, which waits for the step)
  and resolves the items' futures with their rows;
* a semaphore bounds the batches in flight (backpressure).

Every batch's host stage clock — submit_wait, slot_write, h2d_issue,
launch, readback, resolve — is folded into :class:`EngineStats`, with
the reference's unit accounting: an engine whose items each carry up
to ``max_units`` unit rows (a classify engine's ROI budget) computes
``bucket × max_units`` rows a batch, of which each item's ``units``
(its real region count) are real.

The reference's staging ring (``SlotRing``), pipelined transfer,
scheduling classes, ragged packing, AOT cache, control plane,
supervisor and fleet come with later slices.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable

import numpy as np
import torch

from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.engine.batcher")

#: per-batch host stages, in pipeline order
STAGES = ("submit_wait", "slot_write", "h2d_issue", "launch", "readback",
          "resolve")


@dataclasses.dataclass
class _WorkItem:
    inputs: dict[str, np.ndarray]
    future: Future
    t_submit: float
    #: real unit rows the item carries (None: the whole budget)
    units: int | None = None


def _safe_set_result(fut: Future, value) -> None:
    """Resolve a future that stop() may already have failed."""
    try:
        fut.set_result(value)
    except InvalidStateError:
        pass


def _safe_set_exception(fut: Future, exc: BaseException) -> None:
    try:
        fut.set_exception(exc)
    except InvalidStateError:
        pass


@dataclasses.dataclass
class EngineStats:
    n_batches: int = 0
    n_items: int = 0
    occupancy_sum: float = 0.0
    #: real unit rows vs the unit rows the batches computed
    units: int = 0
    unit_slots: int = 0
    #: per-bucket dispatched-batch counts
    bucket_batches: dict[int, int] = dataclasses.field(default_factory=dict)
    #: cumulative per-stage host clock (seconds), keyed by STAGES
    stage_seconds: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.n_batches if self.n_batches else 0.0

    @property
    def unit_occupancy(self) -> float:
        """Real unit rows / computed unit rows (the pad tax that the
        per-item occupancy hides on a classify engine)."""
        return self.units / self.unit_slots if self.unit_slots else 0.0

    def add_stage(self, stage: str, dt: float) -> None:
        self.stage_seconds[stage] = self.stage_seconds.get(stage, 0.0) + dt

    def stage_ms_per_batch(self) -> dict[str, float]:
        """Mean per-batch host cost of each stage (ms)."""
        if not self.n_batches:
            return {}
        return {s: 1e3 * self.stage_seconds[s] / self.n_batches
                for s in STAGES if s in self.stage_seconds}


class BatchEngine:
    """Deadline-batching dispatcher around one step function.

    ``step_fn(*tensors) -> packed`` takes one stacked device tensor per
    input name (leading batch axis) and returns one tensor whose leading
    axis matches. Batches are padded to power-of-two buckets.
    ``max_units`` is the unit rows each item is padded to inside the
    step (None: one row per item)."""

    def __init__(
        self,
        name: str,
        step_fn: Callable,
        device: torch.device,
        max_batch: int = 32,
        deadline_ms: float = 8.0,
        max_in_flight: int = 3,
        input_names: tuple[str, ...] = ("frames",),
        max_units: int | None = None,
    ):
        self.name = name
        self.step_fn = step_fn
        self.device = torch.device(device)
        self.max_batch = max_batch
        self.deadline_s = deadline_ms / 1000.0
        self.input_names = input_names
        self.max_units = max_units
        self.stats = EngineStats()
        self._stats_lock = threading.Lock()
        self.buckets = []
        b = 1
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_batch)
        self._queue: queue.Queue[_WorkItem | None] = queue.Queue()
        self._done: queue.Queue = queue.Queue()
        self._in_flight = threading.Semaphore(max_in_flight)
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name=f"engine-{name}-dispatch",
            daemon=True)
        self._completer = threading.Thread(
            target=self._completion_loop, name=f"engine-{name}-complete",
            daemon=True)
        self._dispatcher.start()
        self._completer.start()

    # ------------------------------------------------------------- API

    def submit(self, units: int | None = None, **inputs: np.ndarray) -> Future:
        """Enqueue one item (no batch dim); resolves to its packed row.
        ``units`` is the item's real unit rows, for the accounting only."""
        if self._stop.is_set():
            raise RuntimeError(f"engine {self.name} is stopped")
        if set(inputs) != set(self.input_names):
            raise ValueError(
                f"engine {self.name} expects inputs {self.input_names}, "
                f"got {tuple(inputs)}")
        fut: Future = Future()
        self._queue.put(_WorkItem(inputs, fut, time.perf_counter(), units))
        return fut

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def queue_age_s(self) -> float:
        """Age (s) of the oldest undispatched item; 0 when idle."""
        now = time.perf_counter()
        with self._queue.mutex:
            head = self._queue.queue[0] if self._queue.queue else None
        if isinstance(head, _WorkItem):
            return max(0.0, now - head.t_submit)
        return 0.0

    def stats_row(self) -> dict:
        """Consistent snapshot of the engine's counters."""
        with self._stats_lock:
            st = self.stats
            return {
                "batches": st.n_batches,
                "items": st.n_items,
                "mean_occupancy": st.mean_occupancy,
                "units": st.units,
                "unit_slots": st.unit_slots,
                "unit_occupancy": round(st.unit_occupancy, 4),
                "bucket_batches": {str(b): c for b, c in sorted(
                    st.bucket_batches.items())},
                "stage_ms": st.stage_ms_per_batch(),
                "queue_depth": self.queue_depth(),
            }

    def stop(self) -> None:
        """Stop both threads; futures not yet resolved fail."""
        self._stop.set()
        self._queue.put(None)
        self._dispatcher.join(timeout=10)
        self._done.put(None)
        self._completer.join(timeout=10)
        exc = RuntimeError(f"engine {self.name} stopped")
        for q in (self._queue, self._done):
            while True:
                try:
                    entry = q.get_nowait()
                except queue.Empty:
                    break
                items = ([entry] if isinstance(entry, _WorkItem)
                         else entry[1] if entry is not None else [])
                for it in items:
                    _safe_set_exception(it.future, exc)

    # -------------------------------------------------------- internals

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"{n} items exceed the top bucket {self.buckets[-1]}")

    def _gather(self, first: _WorkItem) -> list[_WorkItem]:
        items = [first]
        deadline = time.perf_counter() + self.deadline_s
        while len(items) < self.max_batch:
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
        return items

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                break
            items = self._gather(first)
            try:
                self._dispatch(items)
            except Exception as exc:  # noqa: BLE001 — surface to every caller
                log.exception("engine %s step failed", self.name)
                for it in items:
                    _safe_set_exception(it.future, exc)

    def _dispatch(self, items: list[_WorkItem]) -> None:
        n = len(items)
        b = self._bucket(n)
        clock = {"submit_wait": time.perf_counter() - items[0].t_submit}
        t0 = time.perf_counter()
        batch = []
        for name in self.input_names:
            stacked = np.stack([it.inputs[name] for it in items])
            if b > n:
                pad = np.zeros((b - n,) + stacked.shape[1:], stacked.dtype)
                stacked = np.concatenate([stacked, pad])
            batch.append(stacked)
        t1 = time.perf_counter()
        clock["slot_write"] = t1 - t0
        self._in_flight.acquire()
        try:
            dev = [torch.from_numpy(a).to(self.device, non_blocking=True)
                   for a in batch]
            t2 = time.perf_counter()
            out = self.step_fn(*dev)
        except BaseException:
            self._in_flight.release()
            raise
        t3 = time.perf_counter()
        clock["h2d_issue"] = t2 - t1
        clock["launch"] = t3 - t2
        self._done.put((out, items, n, b, clock))

    def _completion_loop(self) -> None:
        while True:
            entry = self._done.get()
            if entry is None:
                break
            out, items, n, b, clock = entry
            t0 = time.perf_counter()
            try:
                host = out.cpu().numpy()  # waits for the step
            except Exception as exc:  # noqa: BLE001
                log.exception("engine %s readback failed", self.name)
                for it in items:
                    _safe_set_exception(it.future, exc)
                continue
            finally:
                self._in_flight.release()
            t1 = time.perf_counter()
            clock["readback"] = t1 - t0
            # count the batch before its futures resolve, so a caller
            # that sees every result also sees every batch counted
            with self._stats_lock:
                st = self.stats
                st.n_batches += 1
                st.n_items += n
                st.occupancy_sum += n / b
                if self.max_units is None:
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
            for i, it in enumerate(items):
                _safe_set_result(it.future, host[i])
            with self._stats_lock:
                self.stats.add_stage("resolve", time.perf_counter() - t1)
            metrics.observe("evam_batch_occupancy", n / b,
                            {"engine": self.name})
            metrics.set("evam_engine_occupancy", mean_occ,
                        {"engine": self.name})
            metrics.set("evam_engine_unit_occupancy", unit_occ,
                        {"engine": self.name})
            for stage, dt in clock.items():
                metrics.observe("evam_engine_stage_seconds", dt,
                                {"engine": self.name, "stage": stage})
