"""StreamInstance: one running pipeline instance.

Counterpart of ``evam_tpu/server/instance.py`` (a copy, less the
decode-pool and RTSP-demux blocks, whose knobs raise until their
slice). The instance owns only light host work: a thread
walking its frames through the stage chain via StreamRunner; all
inference rides the shared EngineHub batch queues. A dying stream
never takes the engine down.

Lifecycle (the reference pipeline server's states): QUEUED → RUNNING →
COMPLETED | ERROR | ABORTED, with a capped, jittered reconnect between
failed attempts.

Stream state: ``stage_state`` / ``restore_stage_state`` round-trip the
stages' cross-frame state through the registry's ``streams.json``;
``checkpoint_payload`` / ``restore_checkpoint`` are the two sides of a
``StreamCheckpoint`` (``state/``, EVAM_CKPT), restored before the
first frame; with ckpt on, the status carries a ``checkpoint`` block.
"""

from __future__ import annotations

import enum
import logging
import random
import threading
import time
import uuid
from typing import Any, Callable

from evam_tpu_torch.media.source import create_source
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.publish.base import Destination, NullDestination
from evam_tpu_torch.stages.base import Stage
from evam_tpu_torch.stages.runner import StreamRunner

log = logging.getLogger("evam_tpu_torch.server.instance")


class InstanceState(str, enum.Enum):
    """Reference pipeline-server states (observed in its REST status
    payloads: QUEUED → RUNNING → COMPLETED | ERROR | ABORTED)."""

    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ERROR = "ERROR"
    ABORTED = "ABORTED"


def _retry_delay(
    attempts: int,
    base_s: float,
    cap_s: float,
    rng: random.Random | None = None,
) -> float:
    """Capped, jittered exponential reconnect backoff: the cap bounds
    the wait; the ±25% jitter decorrelates streams that lost one shared
    source in the same instant."""
    delay = min(base_s * (2 ** max(attempts - 1, 0)), cap_s)
    jitter = (rng or random).uniform(-0.25, 0.25)
    return max(0.05, delay * (1.0 + jitter))


class StreamInstance:
    def __init__(
        self,
        pipeline_name: str,
        version: str,
        stages: list[Stage],
        request: dict[str, Any],
        destination: Destination | None = None,
        max_retries: int = 3,
        retry_backoff_s: float = 1.0,
        max_backoff_s: float = 30.0,
        priority: str = "standard",
        on_finish: Callable[["StreamInstance"], None] | None = None,
        source: Any | None = None,
    ):
        self.id = str(uuid.uuid4())
        self.pipeline_name = pipeline_name
        self.version = version
        self.request = request
        self.stages = stages
        #: QoS class (realtime|standard|batch), stamped on every frame
        self.priority = priority
        #: called once when the instance ends, however it ends (the
        #: registry releases the stream's admission ticket here)
        self.on_finish = on_finish
        self.destination = destination or NullDestination()
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.max_backoff_s = max_backoff_s
        # an injected source (the EII message-bus ingest) belongs to its
        # caller: no retry recreates it, so a failure is permanent
        self._injected_source = source
        if source is not None:
            self.max_retries = 0

        self.state = InstanceState.QUEUED
        self.error: str | None = None
        self.start_time: float | None = None
        self.end_time: float | None = None
        self._source = None
        self._runner: StreamRunner | None = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # Guards _source against the stop()-vs-retry-reassignment race.
        self._src_lock = threading.Lock()
        #: a DELETE: never resumed, whatever the drain finds
        self.deleted = False
        #: set by restore_checkpoint: where this instance's serving
        #: state came from (in the status with ckpt on)
        self._restored_from: dict[str, Any] | None = None

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name=f"stream-{self.id[:8]}", daemon=True
        )
        self.start_time = time.time()
        self.state = InstanceState.RUNNING
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._runner is not None:
            self._runner.stop()
        with self._src_lock:
            if self._source is not None:
                self._source.close()

    def wait(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    # ------------------------------------------------------- internals

    def _run(self) -> None:
        attempts = 0
        try:
            while not self._stop.is_set():
                try:
                    self._run_once()
                    # A stop() mid-stream drains early: that is an
                    # abort, not a natural completion.
                    self.state = (
                        InstanceState.ABORTED
                        if self._stop.is_set()
                        else InstanceState.COMPLETED
                    )
                    break
                except Exception as exc:  # noqa: BLE001 — supervision boundary
                    if self._stop.is_set():
                        # stop() closing the source mid-read raises in
                        # the reader: a deliberate abort
                        self.state = InstanceState.ABORTED
                        break
                    attempts += 1
                    if attempts > self.max_retries:
                        raise
                    delay = _retry_delay(
                        attempts, self.retry_backoff_s, self.max_backoff_s)
                    log.warning(
                        "stream %s attempt %d failed (%s); retrying in %.1fs",
                        self.id[:8], attempts, exc, delay,
                    )
                    if self._stop.wait(delay):
                        break
            if self._stop.is_set() and self.state == InstanceState.RUNNING:
                self.state = InstanceState.ABORTED
        except Exception as exc:  # noqa: BLE001
            self.state = InstanceState.ERROR
            self.error = f"{type(exc).__name__}: {exc}"
            log.error("stream %s failed permanently: %s", self.id[:8],
                      self.error)
            metrics.inc("evam_stream_failures")
        finally:
            self.end_time = time.time()
            try:
                self.destination.close()
            except Exception:  # noqa: BLE001
                log.exception("stream %s destination close failed",
                              self.id[:8])
            if self.on_finish is not None:
                try:
                    self.on_finish(self)
                except Exception:  # noqa: BLE001 — cleanup boundary
                    log.exception("stream %s finish hook failed",
                                  self.id[:8])

    def _run_once(self) -> None:
        src_cfg = self.request.get("source", {})
        source = self._injected_source or create_source(
            src_cfg, realtime=bool(src_cfg.get("realtime", False)))
        with self._src_lock:
            if self._stop.is_set():
                source.close()
                return
            self._source = source
        self._runner = StreamRunner(
            stream_id=self.id,
            stages=self.stages,
            source_uri=src_cfg.get("uri", ""),
            priority=self.priority,
        )
        try:
            self._runner.run(source.frames())
        finally:
            # Each attempt owns its source: close it here so retries
            # never leak capture handles.
            with self._src_lock:
                source.close()
                if self._source is source:
                    self._source = None

    # --------------------------------------------------------- status

    @property
    def avg_fps(self) -> float:
        if self._runner is None or self.start_time is None:
            return 0.0
        end = self.end_time or time.time()
        dt = max(end - self.start_time, 1e-9)
        return self._runner.frames_out / dt

    def stage_state(self) -> dict[str, dict]:
        """Snapshot of every stateful stage (keyed by stage name) for
        streams.json persistence."""
        out: dict[str, dict] = {}
        for stage in self.stages:
            try:
                snap = stage.snapshot()
            except Exception:  # noqa: BLE001 — state capture is best-effort
                snap = None
            if snap is not None:
                out[stage.name] = snap
        return out

    def restore_stage_state(self, state: dict[str, dict]) -> None:
        for stage in self.stages:
            if stage.name in state:
                try:
                    stage.restore(state[stage.name])
                except Exception as exc:  # noqa: BLE001
                    log.warning("stage %s state restore failed: %s",
                                stage.name, exc)

    # ------------------------------------- crash-consistent checkpoints

    def _gate(self):
        """The first gating stage's MotionGate, or None."""
        for stage in self.stages:
            gate = getattr(stage, "gate", None)
            if gate is not None:
                return gate
        return None

    def checkpoint_payload(self) -> dict[str, Any] | None:
        """StreamCheckpoint field values less the envelope's own
        stream_id, captured_at and barrier — the capture side. Called
        from capture barriers on stream, fleet and supervisor threads;
        a torn read is tolerated (a checkpoint is a snapshot, not a
        transaction)."""
        runner = self._runner
        gate = self._gate()
        return {
            "sched_class": self.priority,
            "trace_marker": runner.last_trace_id if runner else "",
            "frame_seq": runner.frames_out if runner else 0,
            "max_skip": gate.cfg.max_skip if gate is not None else 0,
            "skips_at_capture": (gate.consecutive_skips
                                 if gate is not None else 0),
            "fps": round(self.avg_fps, 3) or 30.0,
            "stages": self.stage_state(),
        }

    def restore_checkpoint(self, ck, stale: bool = False) -> None:
        """Apply a decoded StreamCheckpoint before start(). ``stale``
        (older than the gate's max-skip bound) keeps only what never
        goes stale — the tracker's next id — and forces the gate to
        refresh; detections and the gate's anchor are dropped."""
        from evam_tpu_torch.sched.classes import coerce_priority

        self.priority = coerce_priority(ck.sched_class, self.priority)
        state = ck.stages
        if stale:
            pruned: dict[str, dict] = {}
            for name, st in state.items():
                if not isinstance(st, dict):
                    continue
                if "next_id" in st:
                    pruned[name] = {"next_id": st["next_id"]}
                elif "count" in st or "coaster" in st or "gate" in st:
                    pruned[name] = {"count": st.get("count", 0),
                                    "stale": True}
            state = pruned
        self.restore_stage_state(state)
        self._restored_from = {
            "barrier": ck.barrier,
            "frame_seq": ck.frame_seq,
            "trace_marker": ck.trace_marker,
            "stale": stale,
        }

    def status(self) -> dict[str, Any]:
        """Reference status payload shape: id, state, avg_fps,
        start_time, elapsed_time, priority (+ error message when failed,
        + weight provenance, + gate state where a stage gates)."""
        elapsed = 0.0
        if self.start_time is not None:
            elapsed = (self.end_time or time.time()) - self.start_time
        out: dict[str, Any] = {
            "id": self.id,
            "state": self.state.value,
            "avg_fps": round(self.avg_fps, 2),
            "start_time": self.start_time,
            "elapsed_time": round(elapsed, 3),
            "priority": self.priority,
        }
        if self.error:
            out["message"] = self.error
        weights = self._weight_provenance()
        if weights:
            out["weights"] = weights
        # per-stream motion-gate state, present only when a stage gates
        gates = {stage.name: stage.gate.snapshot() for stage in self.stages
                 if getattr(stage, "gate", None) is not None}
        if gates:
            out["gate"] = gates
        # the checkpoint block, present only with EVAM_CKPT on
        from evam_tpu_torch.state import active as ckpt_active

        store = ckpt_active()
        if store is not None:
            ck: dict[str, Any] = {"held": False}
            info = store.stream_info(self.id)
            if info is not None:
                ck.update(info)
            if self._restored_from is not None:
                ck["restored_from"] = self._restored_from
            out["checkpoint"] = ck
        return out

    def _weight_provenance(self) -> dict[str, Any]:
        """Per-engine weight provenance: which model each inference
        stage serves and whether its weights were loaded from disk
        ("msgpack") or are a seeded random init ("random")."""
        out: dict[str, Any] = {}
        for stage in self.stages:
            models = {}
            for attr in ("model", "det_model", "cls_model"):
                m = getattr(stage, attr, None)
                if m is not None and hasattr(m, "weight_source"):
                    models[m.spec.key] = m.weight_source
            if models:
                eng = getattr(stage, "engine", None)
                out[stage.name] = {
                    "engine": getattr(eng, "name", None),
                    "weights": models,
                }
        return out

    def summary(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "request": {
                "pipeline": {"name": self.pipeline_name,
                             "version": self.version},
                **self.request,
            },
            **self.status(),
        }
