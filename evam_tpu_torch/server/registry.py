"""PipelineRegistry: definitions + shared engines + instance table.

Counterpart of ``evam_tpu/server/registry.py``. The registry owns the
one EngineHub — instances are lightweight adapters around shared
per-model batch engines — and the table of running instances.

Left out until their slices (ROADMAP.md): the mesh and fleet, the
admission controller (503) and the self-tuning controller, the RTSP
and WebRTC frame destinations, the decode pool and RTSP demux,
checkpoints, and persistence (``_persist`` / ``resume``) and preload.
With the scheduler off, the reference validates a request's
``priority`` and ``fps`` and reports ``priority``; so does the port.
"""

from __future__ import annotations

import logging
import threading
from typing import Any

from evam_tpu_torch import slices
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
from evam_tpu_torch.media.source import check_source
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.publish.base import create_destination
from evam_tpu_torch.server.instance import StreamInstance
from evam_tpu_torch.stages.build import build_stages

log = logging.getLogger("evam_tpu_torch.server.registry")

#: the reference's scheduling classes, highest priority first, and its
#: default class (``evam_tpu/sched/classes.py``)
PRIORITIES = ("realtime", "standard", "batch")
DEFAULT_PRIORITY = "standard"
#: assumed per-stream fps when a start request declares none (the
#: reference's ``SchedSettings.default_fps``)
DEFAULT_FPS = 30.0


def validate_priority(value: Any) -> str:
    """Normalize + validate a request/spec ``priority`` value (a copy of
    the reference's ``sched/classes.py`` ``validate_priority``)."""
    if not isinstance(value, str):
        raise ValueError(
            f"priority must be one of {'|'.join(PRIORITIES)}, "
            f"got {value!r}")
    prio = value.strip().lower()
    if prio not in PRIORITIES:
        raise ValueError(
            f"unknown priority {value!r}; valid values: "
            f"{'|'.join(PRIORITIES)}")
    return prio


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
            hub = EngineHub(
                registry,
                device=settings.device,
                max_batch=settings.engine.max_batch,
                deadline_ms=settings.engine.batch_deadline_ms,
            )
        self.hub = hub
        self.instances: dict[str, StreamInstance] = {}
        #: starts that passed validation, per class (the reference's
        #: admission controller counts them with the scheduler off too)
        self.admitted = dict.fromkeys(PRIORITIES, 0)
        self._lock = threading.Lock()

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
                       request: dict[str, Any]) -> StreamInstance:
        spec = self.loader.get(name, version)
        if spec is None:
            raise KeyError(f"pipeline {name}/{version} not found")
        src = request.get("source")
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
            fps = float(request.get("fps") or DEFAULT_FPS)
        except (TypeError, ValueError):
            raise RequestError("request.fps must be a number") from None
        if fps <= 0:
            raise RequestError("request.fps must be > 0")
        with self._lock:
            self.admitted[priority] += 1
        metrics.inc("evam_sched_admitted", labels={"class": priority})
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
                source_uri=src.get("uri", ""),
                publish_fn=lambda ctx: destination.publish(ctx.metadata),
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

    def statuses(self) -> list[dict[str, Any]]:
        with self._lock:
            instances = list(self.instances.values())
        return [i.status() for i in instances]

    def stop_all(self) -> int:
        """Drain every instance and shut the engines down. Returns the
        number of LEAKED instances — worker threads still alive after
        the per-instance drain budget (``settings.drain_timeout_s``),
        logged and counted in ``evam_shutdown_leaked_streams``."""
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
