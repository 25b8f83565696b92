"""PipelineRegistry: definitions + shared engines + instance table.

Counterpart of ``evam_tpu/server/registry.py``. The registry owns the
one EngineHub — instances are lightweight adapters around shared
per-model batch engines — and the table of running instances.

The QoS layer (``sched/``): a start names its ``priority`` (request,
then the pipeline spec, then ``standard``) and its ``fps``; admission
reserves capacity for it before any resource is built, or refuses it
(``AdmissionError``, a 503 with Retry-After), and the instance's end
releases the reservation. With the scheduler off admission admits
everything and counts it. With ``EVAM_TUNE`` on the registry runs the
self-tuning controller (``control/``) until ``stop_all``.
``scheduler_status`` is the ``GET /scheduler`` payload.

The hub's device list comes from ``tpu.mesh_shape`` / ``tpu.mesh_axes``
(``device.mesh_devices``), narrowed by EVAM_FLEET_SHARDS or
EVAM_FLEET_MAX_SHARDS with the fleet on, as the reference narrows its
mesh.

Left out until their slices (ROADMAP.md): the RTSP and WebRTC frame
destinations, the decode pool and RTSP demux, checkpoints, and
persistence (``_persist`` / ``resume``).
"""

from __future__ import annotations

import logging
import threading
from typing import Any

from evam_tpu_torch import slices
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.control import state as control_state
from evam_tpu_torch.device import mesh_devices
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
from evam_tpu_torch.media.source import check_source
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.publish.base import create_destination
from evam_tpu_torch.sched import (
    DEFAULT_PRIORITY,
    AdmissionController,
    SchedConfig,
    validate_priority,
)
from evam_tpu_torch.server.instance import StreamInstance
from evam_tpu_torch.stages.build import build_stages

log = logging.getLogger("evam_tpu_torch.server.registry")


class RequestError(ValueError):
    """400-class problem with a start request."""


class PipelineRegistry:
    def __init__(self, settings: Settings, hub: EngineHub | None = None):
        self.settings = settings
        self.loader = PipelineLoader(settings.pipelines_dir)
        if hub is None:
            registry = ModelRegistry(
                models_dir=settings.models_dir,
                dtype=settings.engine.precision,
                allow_random_weights=settings.allow_random_weights,
                device=settings.device,
            )
            eng = settings.engine
            sched_cfg = SchedConfig.from_settings(
                settings.sched, standard_deadline_ms=eng.batch_deadline_ms)
            devices = mesh_devices(settings.device, eng.mesh_shape,
                                   eng.mesh_axes)
            n_devices = max(eng.fleet_shards, eng.fleet_max_shards)
            if eng.fleet == "sharded" and n_devices > 0:
                # shard over the first N devices only; with autoscaling
                # the list spans the ceiling, and the fleet boots at
                # EVAM_FLEET_SHARDS shards and grows into the rest
                devices = devices[:n_devices]
            hub = EngineHub(
                registry,
                device=settings.device,
                devices=devices,
                max_batch=eng.max_batch,
                deadline_ms=eng.batch_deadline_ms,
                warmup=eng.warmup,
                stall_timeout_s=eng.stall_timeout_s,
                supervise=eng.supervise,
                max_restarts=eng.max_restarts,
                restart_window_s=eng.restart_window_s,
                restart_backoff_s=eng.restart_backoff_s,
                first_batch_grace=eng.first_batch_grace,
                transfer=eng.transfer,
                transfer_depth=eng.transfer_depth,
                assembly=eng.batch_assembly,
                staging_depth=eng.staging_depth,
                sched=sched_cfg,
                ragged=eng.ragged,
                ragged_unit_budget=eng.ragged_unit_budget,
                fleet=eng.fleet,
                fleet_shard_max_batch=eng.fleet_shard_max_batch,
                fleet_max_shards=eng.fleet_max_shards,
                # the boot size means something only under a ceiling:
                # without one the fleet spans the device list
                fleet_initial_shards=(eng.fleet_shards
                                      if eng.fleet_max_shards > 0 else 0),
            )
        self.hub = hub
        #: the hub's scheduler config is the one source; a hub without
        #: one (tests, embedders) gets admission that admits everything
        self.sched_cfg = (getattr(hub, "sched", None)
                          or SchedConfig.disabled())
        self.admission = AdmissionController(hub, self.sched_cfg)
        #: the self-tuning controller, with EVAM_TUNE on
        self.tuner = None
        tune_state = control_state.active()
        if tune_state is not None:
            from evam_tpu_torch.control import TuneController

            self.tuner = TuneController(hub, tune_state,
                                        admission=self.admission)
            self.tuner.start()
        self.instances: dict[str, StreamInstance] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------- preload

    def preload(self, names: str) -> int:
        """Build the engines of the named pipelines (and start their
        bucket warmup, with ``warmup`` on) before the REST port opens,
        so the first POST pays neither the model build nor the graph
        captures. ``names``: comma list of ``name/version`` (or a bare
        ``name``: all its versions), or ``all``. Engines are cached in
        the hub, so later instances find them. Returns the count."""
        wanted = [n.strip() for n in names.split(",") if n.strip()]
        count = 0
        for name, version in self.loader.names():
            label = f"{name}/{version}"
            if "all" not in wanted and not any(
                    w in (name, label) for w in wanted):
                continue
            try:
                stage_specs, _ = resolve_parameters(
                    self.loader.get(name, version), {})
                build_stages(stage_specs, self.hub,
                             publish_fn=lambda ctx: None)
            except Exception:  # noqa: BLE001 — preload is best-effort
                log.exception("preload %s failed", label)
                continue
            count += 1
            log.info("preloaded %s", label)
        return count

    # ----------------------------------------------------- definitions

    def pipelines(self) -> list[dict[str, Any]]:
        return [self.describe(name, version)
                for name, version in self.loader.names()]

    def describe(self, name: str, version: str) -> dict[str, Any] | None:
        spec = self.loader.get(name, version)
        if spec is None:
            return None
        return {
            "name": name,
            "version": version,
            "type": spec.raw.get("type", "evam_tpu"),
            "description": spec.description,
            "parameters": spec.parameters,
        }

    # -------------------------------------------------------- instances

    def start_instance(self, name: str, version: str,
                       request: dict[str, Any], publish_fn=None,
                       source=None, sink_fn=None) -> StreamInstance:
        """``publish_fn``, ``source`` and ``sink_fn`` are embedder
        overrides: the EII manager publishes (meta, frame) over the
        message bus from the publish stage (or from the sink of a
        pipeline without one) and injects an ``AppSource`` its
        subscriber feeds. With an injected source, ``request.source``
        is not validated."""
        spec = self.loader.get(name, version)
        if spec is None:
            raise KeyError(f"pipeline {name}/{version} not found")
        src = request.get("source")
        if source is None:
            if not isinstance(src, dict):
                raise RequestError("request.source must be an object")
            if "uri" not in src and src.get("type", "uri") == "uri":
                raise RequestError("request.source.uri is required")
        # request body beats the pipeline spec's default beats
        # `standard` — a bad value is a 400, never a silent `standard`
        priority = request.get("priority")
        if priority is None:
            priority = spec.raw.get("priority", DEFAULT_PRIORITY)
        try:
            priority = validate_priority(priority)
        except ValueError as exc:
            raise RequestError(str(exc)) from None
        try:
            fps = float(request.get("fps") or self.sched_cfg.default_fps)
        except (TypeError, ValueError):
            raise RequestError("request.fps must be a number") from None
        if fps <= 0:
            raise RequestError("request.fps must be > 0")
        # admission before any resource is built: an over-capacity
        # start costs nothing (AdmissionError → 503 in server/app.py);
        # the ticket is released by the instance's end or the unwind
        ticket = self.admission.admit(priority, fps)
        try:
            return self._start_admitted(name, version, spec, src, request,
                                        priority, ticket, publish_fn,
                                        source, sink_fn)
        except BaseException:
            ticket.release()
            raise

    def _start_admitted(self, name: str, version: str, spec, src,
                        request: dict[str, Any], priority: str,
                        ticket, publish_fn, source,
                        sink_fn) -> StreamInstance:
        if source is None:
            check_source(src)
        frame_cfg = (request.get("destination") or {}).get("frame") or {}
        if frame_cfg.get("type"):
            raise NotImplementedError(
                f"frame destination '{frame_cfg['type']}' comes with "
                f"{slices.INGEST_EGRESS}")

        params = request.get("parameters") or {}
        # Resolve stages BEFORE opening the destination: a bad
        # parameter must not truncate/leak the operator's output file.
        stage_specs, _ = resolve_parameters(spec, params)
        dest_cfg = (request.get("destination") or {}).get("metadata")
        destination = create_destination(dest_cfg)
        try:
            stages = build_stages(
                stage_specs,
                self.hub,
                source_uri=(src.get("uri", "") if isinstance(src, dict)
                            else ""),
                publish_fn=publish_fn or (
                    lambda ctx: destination.publish(ctx.metadata)),
                sink_fn=sink_fn,
            )
        except BaseException:
            # the destination must not leak on a failed start
            destination.close()
            raise
        instance = StreamInstance(
            pipeline_name=name,
            version=version,
            stages=stages,
            request=request,
            destination=destination,
            priority=priority,
            on_finish=lambda _inst: ticket.release(),
            source=source,
        )
        with self._lock:
            self.instances[instance.id] = instance
        instance.start()
        log.info("started %s/%s instance %s", name, version, instance.id)
        return instance

    def get_instance(self, instance_id: str) -> StreamInstance | None:
        return self.instances.get(instance_id)

    def stop_instance(self, instance_id: str) -> StreamInstance | None:
        inst = self.instances.get(instance_id)
        if inst is not None:
            inst.stop()
        return inst

    def scheduler_status(self) -> dict[str, Any]:
        """GET /scheduler: the admission snapshot, the engines' per-class
        queue depths and shed totals, the queue summary, the fleet block
        (``EngineHub.fleet_summary``) and the control plane's
        block — fixed keys whatever the knobs (the route golden)."""
        out = self.admission.snapshot()
        out["shed"] = self.hub.shed_totals()
        out["queues"] = self.hub.class_queue_depths()
        out["queue"] = self.hub.queue_summary()
        out["fleet"] = self.hub.fleet_summary()
        st = control_state.active()
        out["tuning"] = (st.snapshot() if st is not None
                         else control_state.disabled_snapshot())
        return out

    def statuses(self) -> list[dict[str, Any]]:
        with self._lock:
            instances = list(self.instances.values())
        return [i.status() for i in instances]

    def stop_all(self) -> int:
        """Drain every instance and shut the engines down. Returns the
        number of LEAKED instances — worker threads still alive after
        the per-instance drain budget (``settings.drain_timeout_s``),
        logged and counted in ``evam_shutdown_leaked_streams``."""
        if self.tuner is not None:
            self.tuner.stop()
        with self._lock:
            instances = list(self.instances.values())
        for inst in instances:
            inst.stop()
        for inst in instances:
            inst.wait(timeout=self.settings.drain_timeout_s)
        leaked = sum(1 for inst in instances
                     if inst._thread is not None and inst._thread.is_alive())
        metrics.set("evam_shutdown_leaked_streams", leaked)
        if leaked:
            log.error(
                "shutdown drain abandoned %d straggler stream(s) after "
                "%.1fs each (daemon threads; the process exit reaps "
                "them)", leaked, self.settings.drain_timeout_s,
            )
        self.hub.stop()
        return leaked
