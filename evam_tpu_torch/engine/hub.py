"""EngineHub: model-instance-id → shared BatchEngine.

Counterpart of ``evam_tpu/engine/hub.py``. Pipelines that pass the same
``model-instance-id`` share one engine and its batch queue; pipelines
that omit it share per-model-key engines — cross-stream batching by
default. The hub builds detect, classify, action encode and decode and
audio engines, and the fused detect+classify engine
(:meth:`EngineHub.fused_engine`), each as a :class:`SupervisedEngine`
around a BatchEngine (``supervise=False``: the bare engine). The hub's
own default is ``warmup=False``, as the reference's; the server passes
``Settings``, whose default is warmup on.

A classify engine carries a ``RaggedSpec`` (its ROI budget) in both
ragged modes, for the unit accounting; with ``ragged="packed"`` it is
built on ``steps.build_classify_step_ragged``. ``sched`` (an enabled
``SchedConfig``) gives every engine the scheduler's dispatch. Both are
part of the rebuild recipe.
"""

from __future__ import annotations

import logging
import threading

import numpy as np
import torch

from evam_tpu_torch.device import resolve_device
from evam_tpu_torch.engine import steps as step_builders
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.ragged import RaggedSpec, ragged_mode
from evam_tpu_torch.engine.ringbuf import STAGES
from evam_tpu_torch.engine.supervisor import SupervisedEngine
from evam_tpu_torch.models.registry import LoadedModel, ModelRegistry
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.sched.classes import PRIORITIES, SchedConfig

log = logging.getLogger("evam_tpu_torch.engine.hub")

#: kind → (builder, input names, takes a wire format)
_BUILDERS = {
    "detect": (step_builders.build_detect_step, ("frames",), True),
    "classify": (step_builders.build_classify_step, ("frames", "boxes"), True),
    "action_encode": (step_builders.build_action_encode_step, ("frames",),
                      True),
    "action_decode": (step_builders.build_action_decode_step, ("clips",),
                      False),
    "audio": (step_builders.build_audio_step, ("windows",), False),
}


class EngineHub:
    """Creates/caches engines; one per (kind, model key or instance id)."""

    def __init__(
        self,
        registry: ModelRegistry,
        device: str | torch.device | None = None,
        max_batch: int = 128,
        deadline_ms: float = 8.0,
        wire_format: str = "i420",
        warmup: bool = False,
        stall_timeout_s: float = 120.0,
        supervise: bool = True,
        max_restarts: int = 3,
        restart_window_s: float = 300.0,
        restart_backoff_s: float = 0.5,
        first_batch_grace: float = 10.0,
        transfer: str | None = None,
        transfer_depth: int = 0,
        assembly: str | None = None,
        staging_depth: int = 0,
        sched: SchedConfig | None = None,
        ragged: str | None = None,
        ragged_unit_budget: int = 4,
    ):
        self.registry = registry
        self.device = resolve_device(device)
        if self.device != registry.device:
            raise ValueError(
                f"hub device {self.device} differs from the registry's "
                f"{registry.device}")
        #: stages warm their engines' buckets in the background once
        #: built, from a zero example of the engine's input (the server
        #: sets it from EVAM_WARMUP)
        self.warmup = warmup
        self.max_batch = max_batch
        self.deadline_ms = deadline_ms
        #: host→device frame encoding for video engines
        self.wire_format = wire_format
        self.stall_timeout_s = stall_timeout_s
        #: wedged engines are quarantined and rebuilt in place, at most
        #: max_restarts times within restart_window_s
        self.supervise = supervise
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.restart_backoff_s = restart_backoff_s
        self.first_batch_grace = first_batch_grace
        #: EVAM_TRANSFER, EVAM_TRANSFER_DEPTH, EVAM_BATCH_ASSEMBLY and
        #: EVAM_STAGING_DEPTH: part of the rebuild recipe (the factory
        #: carries them); None/0 = the engine reads the environment
        self.transfer = transfer
        self.transfer_depth = transfer_depth
        self.assembly = assembly
        self.staging_depth = staging_depth
        #: EVAM_SCHED: the scheduler's config (None: single FIFO)
        self.sched = sched if (sched is not None and sched.enabled) else None
        #: EVAM_RAGGED and EVAM_RAGGED_UNIT_BUDGET
        self.ragged = ragged_mode(ragged)
        self.ragged_unit_budget = ragged_unit_budget
        self._engines: dict[str, BatchEngine | SupervisedEngine] = {}
        self._models: dict[str, LoadedModel] = {}
        # RLock: engine() calls model() while holding the lock
        self._lock = threading.RLock()

    def model(self, model_key: str) -> LoadedModel:
        with self._lock:
            if model_key not in self._models:
                self._models[model_key] = self.registry.get(model_key)
            return self._models[model_key]

    def engine(self, kind: str, model_key: str,
               instance_id: str | None = None,
               **builder_kwargs) -> BatchEngine:
        """Get or create the shared engine for (kind, model, instance)."""
        if kind not in _BUILDERS:
            raise ValueError(f"no step builder for stage kind '{kind}'")
        key = f"{kind}:{instance_id or model_key}"
        with self._lock:
            if key not in self._engines:
                model = self.model(model_key)
                builder, input_names, wired = _BUILDERS[kind]
                if wired:
                    builder_kwargs.setdefault("wire_format", self.wire_format)
                spec = self._ragged_spec(kind, builder_kwargs)
                if spec is not None and self.ragged == "packed":
                    # masked region packing: one fixed-shape step over
                    # the packed unit block (engine/ragged.py)
                    builder = step_builders.build_classify_step_ragged
                self._engines[key] = self._build(
                    key, builder(model, **builder_kwargs), input_names,
                    ragged_spec=spec)
                log.info("created engine %s (model %s)", key, model_key)
            return self._engines[key]

    def fused_engine(self, det_key: str, cls_key: str,
                     instance_id: str | None = None,
                     **builder_kwargs) -> BatchEngine:
        """The fused detect+classify engine: one upload, one readback
        a frame (``steps.build_detect_classify_step``). The builder's
        arguments (the object-class filter among them) are part of the
        key: pipelines share a fused engine only where it computes the
        same thing."""
        kw_sig = ",".join(f"{k}={v}" for k, v in sorted(builder_kwargs.items()))
        key = f"detect_classify:{instance_id or det_key + '+' + cls_key}:{kw_sig}"
        with self._lock:
            if key not in self._engines:
                det = self.model(det_key)
                cls = self.model(cls_key)
                builder_kwargs.setdefault("wire_format", self.wire_format)
                self._engines[key] = self._build(
                    key, step_builders.build_detect_classify_step(
                        det, cls, **builder_kwargs), ("frames",))
                log.info("created fused engine %s", key)
            return self._engines[key]

    def _ragged_spec(self, kind: str, builder_kwargs: dict
                     ) -> RaggedSpec | None:
        """The unit-level shape of a classify engine's boxes (the ROI
        budget each item is padded to on the dense path), attached in
        both ragged modes so the occupancy accounting counts real
        boxes; packing itself is mode-gated."""
        if kind != "classify":
            return None
        budget = int(builder_kwargs.get("roi_budget", 8))
        return RaggedSpec(
            input="boxes", unit_shape=(4,), dtype=np.float32,
            max_units=budget,
            unit_budget=min(self.ragged_unit_budget, budget),
        )

    def _build(self, key: str, step_fn, input_names: tuple[str, ...],
               ragged_spec: RaggedSpec | None = None):
        """The engine for ``key``: a SupervisedEngine whose factory is
        the rebuild recipe (a replacement gets fresh graphs and a fresh
        staging ring from the same step, with the same ragged mode and
        scheduler config), or the bare BatchEngine with supervision
        off."""

        def factory() -> BatchEngine:
            return BatchEngine(
                name=key,
                step_fn=step_fn,
                device=self.device,
                max_batch=self.max_batch,
                deadline_ms=self.deadline_ms,
                input_names=input_names,
                stall_timeout_s=self.stall_timeout_s,
                first_batch_grace=self.first_batch_grace,
                transfer=self.transfer,
                transfer_depth=self.transfer_depth or None,
                assembly=self.assembly,
                staging_depth=self.staging_depth or None,
                sched=self.sched,
                ragged=self.ragged,
                ragged_spec=ragged_spec,
            )

        if not self.supervise:
            return factory()
        return SupervisedEngine(
            key, factory,
            max_restarts=self.max_restarts,
            restart_window_s=self.restart_window_s,
            backoff_s=self.restart_backoff_s,
        )

    def stats(self) -> dict[str, dict]:
        with self._lock:
            engines = dict(self._engines)
        return {k: e.stats_row() for k, e in engines.items()}

    # ------------------------------------------- /healthz summaries
    # Same keys as the reference's (engine/hub.py stage_summary,
    # queue_summary, class_queue_depths, shed_totals, readiness) — the
    # route goldens pin them.

    def _rows(self) -> list[dict]:
        with self._lock:
            engines = list(self._engines.values())
        return [e.stats_row() for e in engines]

    def stage_summary(self) -> dict[str, float]:
        """Batch-weighted mean per-batch host-stage cost across all
        engines (ms), all eight ``STAGES`` from boot."""
        rows = self._rows()
        batches = sum(r["batches"] for r in rows)
        return {
            s: (round(sum(r["stage_ms"].get(s, 0.0) * r["batches"]
                          for r in rows) / batches, 3)
                if batches else 0.0)
            for s in STAGES
        }

    def queue_summary(self) -> dict[str, float]:
        """Total undispatched items and the oldest one's age across
        every engine; refreshes the per-engine queue gauges."""
        with self._lock:
            engines = dict(self._engines)
        depth = 0
        oldest = 0.0
        for k, e in engines.items():
            d = e.queue_depth()
            age = e.queue_age_s()
            depth += d
            oldest = max(oldest, age)
            metrics.set("evam_engine_queue_depth", d, {"engine": k})
            metrics.set("evam_engine_queue_age_s", age, {"engine": k})
        return {"depth": depth, "oldest_age_s": round(oldest, 3)}

    def class_queue_depths(self) -> dict[str, int]:
        """Per-class queued depth summed across engines (zeros with the
        scheduler off: /scheduler keeps its shape)."""
        out = {c: 0 for c in PRIORITIES}
        with self._lock:
            engines = list(self._engines.values())
        for e in engines:
            for c, n in e.class_depths().items():
                out[c] = out.get(c, 0) + n
        return out

    def shed_totals(self) -> dict[str, int]:
        """Per-class shed counts summed across engines, monotonic across
        supervisor rebuilds (``SupervisedEngine.shed_counts``)."""
        out = {c: 0 for c in PRIORITIES}
        with self._lock:
            engines = list(self._engines.values())
        for e in engines:
            for c, n in e.shed_counts().items():
                out[c] = out.get(c, 0) + n
        return out

    def retune(self, op) -> None:
        """Push the controller's operating point to every engine (the
        upload-queue depth; scalar setpoints are pulled per dispatch)."""
        with self._lock:
            engines = list(self._engines.values())
        for e in engines:
            try:
                e.retune(op)
            except Exception:  # noqa: BLE001 — an engine mid-teardown
                log.debug("retune skipped for a stopping engine",
                          exc_info=True)

    def readiness(self) -> dict[str, int | float]:
        """Engine state for /healthz: ``warming`` > 0 while an engine's
        buckets are still being captured (with warmup on); ``stalled``,
        ``restarting`` and ``degraded`` count disjoint engines."""
        with self._lock:
            engines = list(self._engines.values())
        rows = [e.stats_row() for e in engines]
        # without warmup nothing is ever warming
        warmed = (sum(1 for e in engines if e.warmed.is_set())
                  if self.warmup else len(engines))
        states = [r["state"] for r in rows]
        batches = sum(r["batches"] for r in rows)
        return {
            "engines": len(rows),
            "warmed": warmed,
            "warming": len(rows) - warmed,
            "occupancy": round(
                sum(r["mean_occupancy"] * r["batches"] for r in rows)
                / batches if batches else 0.0, 4),
            "unit_occupancy": round(
                sum(r["units"] for r in rows)
                / max(1, sum(r["unit_slots"] for r in rows))
                if batches else 0.0, 4),
            # buckets captured into CUDA graphs across engines
            "compiled_programs": sum(r["compiled_programs"] for r in rows),
            "stalled": sum(1 for e, s in zip(engines, states)
                           if s == "running" and e.stalled.is_set()),
            "restarting": sum(1 for s in states if s == "restarting"),
            "degraded": sum(1 for s in states if s == "degraded"),
            "restarts": sum(r["restarts"] for r in rows),
        }

    def stop(self) -> None:
        with self._lock:
            engines = list(self._engines.values())
            self._engines.clear()
        for e in engines:
            e.stop()
