"""EngineHub: model-instance-id → shared BatchEngine.

Counterpart of ``evam_tpu/engine/hub.py``. Pipelines that pass the same
``model-instance-id`` share one engine and its batch queue; pipelines
that omit it share per-model-key engines — cross-stream batching by
default. The hub builds detect and classify engines and the fused
detect+classify engine (:meth:`EngineHub.fused_engine`); action and
audio engines raise until their slice.
"""

from __future__ import annotations

import logging
import threading

import torch

from evam_tpu_torch import slices
from evam_tpu_torch.device import resolve_device
from evam_tpu_torch.engine import steps as step_builders
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.models.registry import LoadedModel, ModelRegistry
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.engine.hub")

#: the reference's per-batch host stages (``engine/ringbuf.py``
#: ``STAGES``), the keys of /healthz ``host_stages_ms``
HEALTH_STAGES = ("submit_wait", "slot_write", "seal", "h2d_issue",
                 "h2d_wait", "launch", "readback", "resolve")

#: kind → (builder, input names, takes a wire format)
_BUILDERS = {
    "detect": (step_builders.build_detect_step, ("frames",), True),
    "classify": (step_builders.build_classify_step, ("frames", "boxes"), True),
}

#: kinds the reference serves that come with later port slices
_LATER_KINDS = {
    "action_encode": slices.ACTION_AUDIO,
    "action_decode": slices.ACTION_AUDIO,
    "audio": slices.ACTION_AUDIO,
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
    ):
        self.registry = registry
        self.device = resolve_device(device)
        if self.device != registry.device:
            raise ValueError(
                f"hub device {self.device} differs from the registry's "
                f"{registry.device}")
        self.max_batch = max_batch
        self.deadline_ms = deadline_ms
        #: host→device frame encoding for video engines
        self.wire_format = wire_format
        self._engines: dict[str, BatchEngine] = {}
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
        if kind in _LATER_KINDS:
            raise NotImplementedError(
                f"{kind} engines come with {_LATER_KINDS[kind]}")
        if kind not in _BUILDERS:
            raise ValueError(f"no step builder for stage kind '{kind}'")
        key = f"{kind}:{instance_id or model_key}"
        with self._lock:
            if key not in self._engines:
                model = self.model(model_key)
                builder, input_names, wired = _BUILDERS[kind]
                if wired:
                    builder_kwargs.setdefault("wire_format", self.wire_format)
                # a classify item is padded to the ROI budget in the
                # step: the unit accounting counts its real boxes
                max_units = (int(builder_kwargs.get("roi_budget", 8))
                             if kind == "classify" else None)
                self._engines[key] = self._build(
                    key, builder(model, **builder_kwargs), input_names,
                    max_units)
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

    def _build(self, key: str, step_fn, input_names: tuple[str, ...],
               max_units: int | None = None) -> BatchEngine:
        return BatchEngine(
            name=key,
            step_fn=step_fn,
            device=self.device,
            max_batch=self.max_batch,
            deadline_ms=self.deadline_ms,
            input_names=input_names,
            max_units=max_units,
        )

    def stats(self) -> dict[str, dict]:
        with self._lock:
            engines = dict(self._engines)
        return {k: e.stats_row() for k, e in engines.items()}

    # ------------------------------------------- /healthz summaries
    # Same keys as the reference's (engine/hub.py stage_summary,
    # queue_summary, readiness) — the route golden pins them; the
    # reference's ``shed_totals`` reads zeros with its scheduler off,
    # and /healthz (server/app.py) states them. The port's engine runs
    # the reference's legacy assembly with the inline transfer, so
    # ``seal`` and ``h2d_wait`` read 0 there as they do in the
    # reference on that path; no warmup, supervisor,
    # scheduler or ragged packing (later slices) means nothing is ever
    # warming, stalled or restarting and nothing is shed; a classify
    # item counts its real boxes against the ROI budget it computes.

    def _rows(self) -> list[dict]:
        with self._lock:
            engines = list(self._engines.values())
        return [e.stats_row() for e in engines]

    def stage_summary(self) -> dict[str, float]:
        """Batch-weighted mean per-batch host-stage cost across all
        engines (ms), fixed keys from boot."""
        rows = self._rows()
        batches = sum(r["batches"] for r in rows)
        return {
            s: (round(sum(r["stage_ms"].get(s, 0.0) * r["batches"]
                          for r in rows) / batches, 3)
                if batches else 0.0)
            for s in HEALTH_STAGES
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

    def readiness(self) -> dict[str, int | float]:
        """Engine state for /healthz."""
        rows = self._rows()
        batches = sum(r["batches"] for r in rows)
        return {
            "engines": len(rows),
            "warmed": len(rows),
            "warming": 0,
            "occupancy": round(
                sum(r["mean_occupancy"] * r["batches"] for r in rows)
                / batches if batches else 0.0, 4),
            "unit_occupancy": round(
                sum(r["units"] for r in rows)
                / max(1, sum(r["unit_slots"] for r in rows))
                if batches else 0.0, 4),
            # eager steps: nothing is compiled ahead
            "compiled_programs": 0,
            "stalled": 0,
            "restarting": 0,
            "degraded": 0,
            "restarts": 0,
        }

    def stop(self) -> None:
        with self._lock:
            engines = list(self._engines.values())
            self._engines.clear()
        for e in engines:
            e.stop()
