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

``devices`` is the hub's device list, the reference's mesh plan
(``tpu.mesh_shape`` [-1] maps to every visible CUDA device,
``device.mesh_devices``; tests pass ``["cpu"] * N``). With
``fleet="sharded"`` and more than one entry, every engine key is a
``FleetEngine`` (``fleet/engine.py``): one supervised shard per entry,
its ladder capped at ``fleet_shard_max_batch``, behind a consistent-hash
stream placer, and a mesh twin for the batch class. With one entry
``sharded`` degrades to off, and says so in the log, as the
reference's does. A shard on another device gets its own copy of the
model's weights; shards on one device share them.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import threading

import numpy as np
import torch

from evam_tpu_torch.device import resolve_device, same_device
from evam_tpu_torch.engine import steps as step_builders
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.ragged import RaggedSpec, ragged_mode
from evam_tpu_torch.engine.ringbuf import STAGES
from evam_tpu_torch.engine.supervisor import SupervisedEngine
from evam_tpu_torch.fleet.engine import FleetEngine, MeshStep, fleet_mode
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
        devices: list | None = None,
        fleet: str | None = None,
        fleet_shard_max_batch: int = 0,
        fleet_max_shards: int = 0,
        fleet_initial_shards: int = 0,
    ):
        self.registry = registry
        self.device = resolve_device(
            devices[0] if device is None and devices else device)
        if not same_device(self.device, registry.device):
            raise ValueError(
                f"hub device {self.device} differs from the registry's "
                f"{registry.device}")
        #: the device list (the reference's mesh plan); its first entry
        #: is the hub's device
        self.devices = ([resolve_device(d) for d in devices] if devices
                        else [self.device])
        if not same_device(self.devices[0], self.device):
            raise ValueError(f"hub device {self.device} is not the first "
                             f"of its devices {self.devices}")
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
        #: EVAM_FLEET: "sharded" fronts every engine key with a
        #: FleetEngine over ``devices``; with one device the two modes
        #: are the same thing, so sharded degrades to off
        self.fleet = fleet_mode(fleet)
        self.fleet_active = self.fleet == "sharded" and len(self.devices) > 1
        if self.fleet == "sharded" and not self.fleet_active:
            log.warning("EVAM_FLEET=sharded needs more than one device "
                        "(have %d: %s) — running single-device",
                        len(self.devices), self.devices[0])
        #: EVAM_FLEET_SHARD_MAX_BATCH: a shard serving 1/N of the
        #: streams does not need the fleet-wide ladder top
        self.fleet_shard_max_batch = fleet_shard_max_batch or (
            max(1, max_batch // len(self.devices)) if self.fleet_active
            else max_batch)
        #: EVAM_FLEET_MAX_SHARDS: the eighth control law's ceiling; 0
        #: keeps the law inert
        self.fleet_max_shards = fleet_max_shards
        #: the boot fleet size with autoscaling (0: every device)
        self.fleet_initial_shards = fleet_initial_shards
        self._engines: dict[str, BatchEngine | SupervisedEngine
                            | FleetEngine] = {}
        self._models: dict[str, LoadedModel] = {}
        #: per-device copies of the models, for shards on other devices
        self._device_models: dict[tuple[str, str], LoadedModel] = {}
        # RLock: engine() calls model() while holding the lock
        self._lock = threading.RLock()

    def model(self, model_key: str) -> LoadedModel:
        with self._lock:
            if model_key not in self._models:
                self._models[model_key] = self.registry.get(model_key)
            return self._models[model_key]

    def _model_on(self, model_key: str, device: torch.device
                  ) -> LoadedModel:
        """The model on ``device``: the registry's own where it is that
        device, else a copy of its weights moved there (made once)."""
        model = self.model(model_key)
        if same_device(device, model.device):
            return model
        with self._lock:
            key = (model_key, str(device))
            if key not in self._device_models:
                self._device_models[key] = dataclasses.replace(
                    model, module=copy.deepcopy(model.module).to(device),
                    device=device)
            return self._device_models[key]

    def engine(self, kind: str, model_key: str,
               instance_id: str | None = None,
               **builder_kwargs) -> BatchEngine:
        """Get or create the shared engine for (kind, model, instance)."""
        if kind not in _BUILDERS:
            raise ValueError(f"no step builder for stage kind '{kind}'")
        key = f"{kind}:{instance_id or model_key}"
        with self._lock:
            if key not in self._engines:
                builder, input_names, wired = _BUILDERS[kind]
                if wired:
                    builder_kwargs.setdefault("wire_format", self.wire_format)
                spec = self._ragged_spec(kind, builder_kwargs)
                if spec is not None and self.ragged == "packed":
                    # masked region packing: one fixed-shape step over
                    # the packed unit block (engine/ragged.py)
                    builder = step_builders.build_classify_step_ragged

                def make_step(dev):
                    return builder(self._model_on(model_key, dev),
                                   **builder_kwargs)

                self._engines[key] = self._build(
                    key, make_step(self.device), input_names,
                    ragged_spec=spec, make_step=make_step)
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
                builder_kwargs.setdefault("wire_format", self.wire_format)

                def make_step(dev):
                    return step_builders.build_detect_classify_step(
                        self._model_on(det_key, dev),
                        self._model_on(cls_key, dev), **builder_kwargs)

                self._engines[key] = self._build(
                    key, make_step(self.device), ("frames",),
                    make_step=make_step)
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
               ragged_spec: RaggedSpec | None = None, make_step=None):
        """The engine for ``key`` over ``step_fn`` (its step on the hub's
        device); ``make_step(device)`` builds the step on another device
        of the fleet (None: ``step_fn`` serves every device). A
        SupervisedEngine whose factory is the rebuild
        recipe (a replacement gets fresh graphs and a fresh staging ring
        from the same step, with the same ragged mode and scheduler
        config), or the bare BatchEngine with supervision off.

        With the fleet on, the same recipe once per device (the shard's
        ladder capped at ``fleet_shard_max_batch``) behind a FleetEngine,
        plus the mesh twin at ``max_batch`` over every device — each
        shard supervised on its own, so a wedge on one device is that
        shard's quarantine, not the fleet's."""
        # the AOT cache's program fingerprint (the reference's): what at
        # the hub level changes what the step computes — key, wire
        # format, device synth (the port has none: 0), ragged mode, unit
        # budget, scheduler. Every factory of the key (the engine, its
        # supervisor's rebuilds, each fleet shard and the twin) carries
        # it, so their warm runs attribute hits and misses alike
        aot_key = (f"{key}|wire={self.wire_format}|synth=0"
                   f"|ragged={self.ragged}|ub={self.ragged_unit_budget}"
                   f"|sched={int(self.sched is not None)}")
        steps: list[tuple[torch.device, object]] = [(self.device, step_fn)]

        def step_on(device):
            for dev, step in steps:
                if same_device(dev, device):
                    return step
            steps.append((device, step_fn if make_step is None
                          else make_step(device)))
            return steps[-1][1]

        def make(device, name, max_batch, step_fn, data_size=1):
            def factory() -> BatchEngine:
                return BatchEngine(
                    name=name,
                    step_fn=step_fn,
                    device=device,
                    max_batch=max_batch,
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
                    data_size=data_size,
                    aot_key=aot_key,
                )

            if not self.supervise:
                return factory()
            return SupervisedEngine(
                name, factory,
                max_restarts=self.max_restarts,
                restart_window_s=self.restart_window_s,
                backoff_s=self.restart_backoff_s,
            )

        if not self.fleet_active:
            return make(self.device, key, self.max_batch, step_fn)
        # every device's step up front: shards built later (scale_up,
        # supervisor rebuilds) reuse them
        for dev in self.devices:
            step_on(dev)
        if ragged_spec is not None and self.ragged == "packed":
            # a packed block's unit rows do not split by batch row: the
            # packed twin runs whole on the first device
            def mesh_factory(label):
                return make(self.devices[0], label, self.max_batch,
                            step_on(self.devices[0]))
        else:
            def mesh_factory(label):
                return make(self.devices[0], label, self.max_batch,
                            MeshStep([step_on(d) for d in self.devices],
                                     self.devices),
                            data_size=len(self.devices))
        return FleetEngine(
            key,
            shard_factory=lambda dev, label: make(
                dev, label, self.fleet_shard_max_batch, step_on(dev)),
            devices=self.devices,
            mesh_factory=mesh_factory,
            initial=self.fleet_initial_shards,
        )

    def stats(self) -> dict[str, dict]:
        """The /engines rows: one per engine, one per shard (and the
        mesh twin) of a fleet, each naming its shard, device and the
        engine key it counts under (admission sums capacity per group)."""
        with self._lock:
            engines = dict(self._engines)
        out: dict[str, dict] = {}
        for k, e in engines.items():
            if isinstance(e, FleetEngine):
                for label, dev, sub in e.shard_rows():
                    out[f"{k}@{label}"] = self._stat_row(sub, label, dev, k)
            else:
                out[k] = self._stat_row(e, None, str(self.device), k)
        return out

    @staticmethod
    def _stat_row(e, shard: str | None, device: str | None,
                  group: str) -> dict:
        return {**e.stats_row(), "shard": shard, "device": device,
                "group": group}

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

    def fleet_summary(self) -> dict:
        """The /scheduler fleet block (fixed keys): placement counts per
        shard, live and degraded shards, rebalances, and the autoscaling
        ceiling and totals. With the fleet off: the same keys, zeros."""
        with self._lock:
            engines = list(self._engines.values())
        out = {"mode": "sharded" if self.fleet_active else "off",
               "shards": 0, "degraded_shards": 0, "rebalances": 0,
               "streams": {}, "max_shards": 0, "scale_ups": 0,
               "scale_downs": 0}
        for e in engines:
            if not isinstance(e, FleetEngine):
                continue
            s = e.fleet_summary()
            # every engine kind shards over the same devices: shard
            # counts report the widest view, placement counts sum (a
            # stream pins once per engine kind it passes through)
            out["shards"] = max(out["shards"], s["shards"])
            out["degraded_shards"] = max(out["degraded_shards"],
                                         s["degraded_shards"])
            out["rebalances"] += s["rebalances"]
            out["max_shards"] = max(out["max_shards"], s["max_shards"])
            out["scale_ups"] += s["scale_ups"]
            out["scale_downs"] += s["scale_downs"]
            for label, n in s["streams"].items():
                out["streams"][label] = out["streams"].get(label, 0) + n
        # the ceiling: the device list, clamped by EVAM_FLEET_MAX_SHARDS;
        # 0 (its default) keeps the eighth law inert
        if self.fleet_active and self.fleet_max_shards > 0:
            cap = self.fleet_max_shards
            if out["max_shards"]:
                cap = min(cap, out["max_shards"])
            out["max_shards"] = cap
        else:
            out["max_shards"] = 0
        return out

    def retune(self, op) -> None:
        """Push the controller's operating point to every engine (the
        upload-queue depth; scalar setpoints are pulled per dispatch; a
        fleet also takes its target size)."""
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
