"""EngineHub: model-instance-id → shared BatchEngine.

Counterpart of ``evam_tpu/engine/hub.py``. Pipelines that pass the same
``model-instance-id`` share one engine and its batch queue; pipelines
that omit it share per-model-key engines — cross-stream batching by
default. This slice builds detect engines.
"""

from __future__ import annotations

import logging
import threading

import torch

from evam_tpu_torch.device import resolve_device
from evam_tpu_torch.engine import steps as step_builders
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.models.registry import LoadedModel, ModelRegistry

log = logging.getLogger("evam_tpu_torch.engine.hub")

#: kind → (builder, input names, takes a wire format)
_BUILDERS = {
    "detect": (step_builders.build_detect_step, ("frames",), True),
}

#: kinds the reference serves that come with later port slices
_LATER_KINDS = {
    "classify": "slice 3 (detect+classify)",
    "action_encode": "slice 5 (action and audio)",
    "action_decode": "slice 5 (action and audio)",
    "audio": "slice 5 (action and audio)",
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
                f"{kind} engines come with port {_LATER_KINDS[kind]}")
        if kind not in _BUILDERS:
            raise ValueError(f"no step builder for stage kind '{kind}'")
        key = f"{kind}:{instance_id or model_key}"
        with self._lock:
            if key not in self._engines:
                model = self.model(model_key)
                builder, input_names, wired = _BUILDERS[kind]
                if wired:
                    builder_kwargs.setdefault("wire_format", self.wire_format)
                self._engines[key] = BatchEngine(
                    name=key,
                    step_fn=builder(model, **builder_kwargs),
                    device=self.device,
                    max_batch=self.max_batch,
                    deadline_ms=self.deadline_ms,
                    input_names=input_names,
                )
                log.info("created engine %s (model %s)", key, model_key)
            return self._engines[key]

    def stats(self) -> dict[str, dict]:
        with self._lock:
            engines = dict(self._engines)
        return {k: e.stats_row() for k, e in engines.items()}

    def stop(self) -> None:
        with self._lock:
            engines = list(self._engines.values())
            self._engines.clear()
        for e in engines:
            e.stop()
