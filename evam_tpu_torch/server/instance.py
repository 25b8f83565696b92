"""StreamInstance: one running pipeline instance.

Counterpart of ``evam_tpu/server/instance.py`` (a copy, less the
decode-pool, RTSP-demux, checkpoint and gate blocks, whose knobs raise
until their slices). The instance owns only light host work: a thread
walking its frames through the stage chain via StreamRunner; all
inference rides the shared EngineHub batch queues. A dying stream
never takes the engine down.

Lifecycle (the reference pipeline server's states): QUEUED → RUNNING →
COMPLETED | ERROR | ABORTED, with a capped, jittered reconnect between
failed attempts.
"""

from __future__ import annotations

import enum
import logging
import random
import threading
import time
import uuid
from typing import Any

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
    ):
        self.id = str(uuid.uuid4())
        self.pipeline_name = pipeline_name
        self.version = version
        self.request = request
        self.stages = stages
        #: QoS class (realtime|standard|batch): validated and reported;
        #: scheduling by class comes with a later slice
        self.priority = priority
        self.destination = destination or NullDestination()
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.max_backoff_s = max_backoff_s

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

    def _run_once(self) -> None:
        src_cfg = self.request.get("source", {})
        source = create_source(
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

    def status(self) -> dict[str, Any]:
        """Reference status payload shape: id, state, avg_fps,
        start_time, elapsed_time, priority (+ error message when failed,
        + weight provenance)."""
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
