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

Stream persistence: with ``EVAM_STATE_DIR`` the registry keeps
``streams.json`` there (each active stream's pipeline, request and
stage state; written atomically on every start, stop and finish, and
every 30 s while a stream runs), and ``resume()`` restarts the streams
a previous process left. With ``EVAM_CKPT`` on a stream's state is its
CRC-guarded ``StreamCheckpoint`` blob (``state/``), restored through
the store's degradation ladder before its first frame; ``stop_all``
captures every live stream at the ``drain`` barrier and keeps
``streams.json`` (a DELETE removes its stream from it).

Left out until their slices (ROADMAP.md): the RTSP and WebRTC frame
destinations, the decode pool and the RTSP demux.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from pathlib import Path
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
from evam_tpu_torch.server.instance import InstanceState, StreamInstance
from evam_tpu_torch.stages.build import build_stages
from evam_tpu_torch.state import active as ckpt_active
from evam_tpu_torch.state import is_checkpoint_blob

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
        self._draining = False
        #: the checkpoint store (EVAM_CKPT), resolved once: None when
        #: off, and every hook below is one None check
        self._ckpt = ckpt_active()
        self._state_file = (Path(settings.state_dir) / "streams.json"
                            if settings.state_dir else None)
        self._persist_lock = threading.Lock()
        #: persists fire on start, stop and finish; a quiet stream's
        #: stage state (the tracker's next id) is re-persisted this
        #: often, bounding what a SIGKILL loses
        self._persist_interval_s = 30.0
        self._persist_stop = threading.Event()
        if self._state_file is not None:
            threading.Thread(target=self._periodic_persist,
                             name="registry-persist", daemon=True).start()

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
                       source=None, sink_fn=None,
                       saved_state: dict | None = None) -> StreamInstance:
        """``publish_fn``, ``source`` and ``sink_fn`` are embedder
        overrides: the EII manager publishes (meta, frame) over the
        message bus from the publish stage (or from the sink of a
        pipeline without one) and injects an ``AppSource`` its
        subscriber feeds. With an injected source, ``request.source``
        is not validated. ``saved_state`` (``resume``) is a stream's
        persisted stage state or checkpoint blob, restored before its
        first frame."""
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
                                        source, sink_fn, saved_state)
        except BaseException:
            ticket.release()
            raise

    def _start_admitted(self, name: str, version: str, spec, src,
                        request: dict[str, Any], priority: str,
                        ticket, publish_fn, source, sink_fn,
                        saved_state: dict | None) -> StreamInstance:
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
            on_finish=lambda _inst: self._on_instance_finish(ticket),
            source=source,
        )
        if saved_state:
            # before start(): the first resumed frame must already see
            # the restored state (the tracker's next id)
            if self._ckpt is not None and is_checkpoint_blob(saved_state):
                # a checkpoint blob: restored through the store's
                # degradation ladder (corrupt, stale or slow → a loud
                # cold start, never a failed start)
                self._ckpt.restore_into(saved_state, instance)
            else:
                instance.restore_stage_state(saved_state)
        if self._ckpt is not None:
            # before start(): the runner's first post-resolve capture
            # must find the instance
            self._ckpt.register(instance.id, instance)
        with self._lock:
            self.instances[instance.id] = instance
        instance.start()
        log.info("started %s/%s instance %s", name, version, instance.id)
        self._persist()
        return instance

    def _on_instance_finish(self, ticket) -> None:
        ticket.release()
        self._persist()

    def get_instance(self, instance_id: str) -> StreamInstance | None:
        return self.instances.get(instance_id)

    def stop_instance(self, instance_id: str) -> StreamInstance | None:
        inst = self.instances.get(instance_id)
        if inst is not None:
            inst.deleted = True  # survives the drain's filter
            if self._ckpt is not None:
                # a DELETE must not leave a checkpoint that could
                # resurrect the stream at the next start
                self._ckpt.unregister(instance_id)
            inst.stop()
            self._persist()
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
        logged and counted in ``evam_shutdown_leaked_streams``; with
        EVAM_CKPT on a straggler is checkpointed at the ``drain``
        barrier instead, and so is every stream that stopped cleanly.
        ``streams.json`` keeps the streams that were live (not the
        deleted, completed or failed ones), for the next start's
        ``resume()``."""
        if self.tuner is not None:
            self.tuner.stop()
        with self._lock:
            instances = list(self.instances.values())
        # which streams were live before stop() flips their intent;
        # their state is read after the drain, so no id assigned
        # mid-drain is lost
        active = [i for i in instances if self._is_active(i)]
        self._draining = True
        self._persist_stop.set()
        for inst in instances:
            inst.stop()
        for inst in instances:
            inst.wait(timeout=self.settings.drain_timeout_s)
        leaked = 0
        for inst in instances:
            if inst._thread is None or not inst._thread.is_alive():
                continue
            if (self._ckpt is not None
                    and self._ckpt.capture(inst.id, barrier="drain",
                                           reason="drain") is not None):
                # banked for the next start's resume(): a migration,
                # not a loss
                log.warning("stream %s still draining at shutdown; "
                            "checkpointed for resume", inst.id[:8])
                continue
            leaked += 1
            log.warning("stream %s still draining at shutdown; persisted "
                        "state may lag", inst.id[:8])
        if self._ckpt is not None:
            # the drain barrier of the cleanly stopped streams: their
            # workers are quiesced, so this is their last frame's state
            for inst in active:
                if inst._thread is None or not inst._thread.is_alive():
                    self._ckpt.capture(inst.id, barrier="drain")
        metrics.set("evam_shutdown_leaked_streams", leaked)
        if leaked:
            log.error(
                "shutdown drain abandoned %d straggler stream(s) after "
                "%.1fs each (daemon threads; the process exit reaps "
                "them)", leaked, self.settings.drain_timeout_s,
            )
        # a DELETE racing the shutdown stays deleted, and a stream that
        # finished during the drain is not replayed
        self._write_state([
            self._entry(i) for i in active
            if not i.deleted
            and i.state not in (InstanceState.COMPLETED, InstanceState.ERROR)
        ])
        self.hub.stop()
        return leaked

    # ------------------------------------------------- restart/resume

    def _persist(self) -> None:
        """Write the active streams to streams.json (with
        EVAM_STATE_DIR), so a restarted server can re-attach them."""
        if self._state_file is None or self._draining:
            return
        with self._lock:
            instances = list(self.instances.values())
        self._write_state([self._entry(i) for i in instances
                           if self._is_active(i)])

    def _entry(self, inst: StreamInstance) -> dict:
        """One streams.json record (the drain and the event persists
        write the same schema)."""
        state: dict = inst.stage_state()
        if self._ckpt is not None:
            # the barrier-consistent, CRC-guarded checkpoint blob over
            # the live read; resume() feeds it back through the
            # store's degradation ladder
            blob = self._ckpt.export(inst.id)
            if blob is not None:
                state = blob
        return {"pipeline": inst.pipeline_name, "version": inst.version,
                "request": inst.request, "state": state}

    @staticmethod
    def _is_active(inst: StreamInstance) -> bool:
        # _stop records the intent at once; the worker flips the state
        # to ABORTED later, so the state alone would resurrect a
        # deliberately stopped stream
        return (inst.state in (InstanceState.QUEUED, InstanceState.RUNNING)
                and not inst._stop.is_set())

    def _periodic_persist(self) -> None:
        while not self._persist_stop.wait(self._persist_interval_s):
            if self._draining:
                return
            with self._lock:
                any_active = any(self._is_active(i)
                                 for i in self.instances.values())
            if any_active:
                self._persist()

    def _write_state(self, entries: list[dict]) -> None:
        """Atomic replace under a lock: a finishing stream's persist
        races a DELETE's, and a torn file would poison the next
        resume()."""
        if self._state_file is None:
            return
        with self._persist_lock:
            self._state_file.parent.mkdir(parents=True, exist_ok=True)
            tmp = self._state_file.with_suffix(".tmp")
            tmp.write_text(json.dumps(entries, indent=2))
            os.replace(tmp, self._state_file)

    def resume(self) -> int:
        """Restart the streams a previous run recorded. Returns the
        count."""
        if self._state_file is None or not self._state_file.exists():
            return 0
        try:
            entries = json.loads(self._state_file.read_text())
        except (OSError, json.JSONDecodeError) as exc:
            log.warning("stream state file unreadable (%s); skipping resume",
                        exc)
            return 0
        n = 0
        for e in entries:
            try:
                self.start_instance(e["pipeline"], e["version"], e["request"],
                                    saved_state=e.get("state") or None)
                n += 1
            except Exception as exc:  # noqa: BLE001 — one bad entry is not fatal
                log.warning("resume of %s/%s failed: %s",
                            e.get("pipeline"), e.get("version"), exc)
        if n:
            log.info("resumed %d stream(s) from %s", n, self._state_file)
        return n
