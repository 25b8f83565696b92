"""EiiManager: the EII-mode service (counterpart of
``evam_tpu/eii/manager.py``).

Boot: read the app config (``ConfigMgr``: the file ``EVAM_EII_CONFIG``
names, or etcd) → the message-bus publisher → with ``source: msgbus``
a subscriber feeding an ``AppSource`` → start ONE configured pipeline
through ``PipelineRegistry.start_instance`` (admission runs there: a
start it refuses raises at boot) → run until stopped. The config
watcher restarts the pipeline on a change, and falls back to the last
config that ran when the new one fails (``reload_error``).

Published message: ``(meta, frame-bytes)`` when ``publish_frame``, else
meta alone; meta carries img_handle / width / height / channels / caps,
the encoding when the frame is encoded, the per-region ``gva_meta``
list (rect in pixels, object_id, tensors with name / confidence /
label_id / label) and the EVA-schema fields of the frame's metadata.

The bus is the port's own ZeroMQ wire (``eii/zmtp.py``); frames are
encoded and, on ingest, decoded by ``publish/encode.py`` (``raw`` and
``png`` need nothing, ``jpeg`` needs cv2).
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import threading
from typing import Any

import numpy as np

from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.eii.configmgr import ConfigMgr
from evam_tpu_torch.eii.msgbus import MsgBusPublisher, MsgBusSubscriber
from evam_tpu_torch.graph.spec import StageKind
from evam_tpu_torch.media.source import AppSource
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.publish.encode import decode_frame, encode_frame
from evam_tpu_torch.server.registry import PipelineRegistry
from evam_tpu_torch.stages.context import FrameContext

log = logging.getLogger("evam_tpu_torch.eii.manager")


def _gva_meta(ctx: FrameContext) -> list[dict[str, Any]]:
    """Regions → the gva_meta rects of the EII message."""
    out = []
    for r in ctx.regions:
        x, y, w, h = r.rect(ctx.width, ctx.height)
        entry: dict[str, Any] = {
            "x": x, "y": y, "width": w, "height": h,
            "object_id": r.object_id,
            "tensor": [
                {
                    "name": t.name,
                    "confidence": t.confidence,
                    "label_id": t.label_id,
                    "label": t.label,
                }
                for t in r.tensors
            ],
        }
        out.append(entry)
    return out


class EiiManager:
    def __init__(
        self,
        settings: Settings,
        cfg_mgr: ConfigMgr | None = None,
        registry: PipelineRegistry | None = None,
    ):
        self.settings = settings
        self.cfg = cfg_mgr or ConfigMgr(os.environ.get("EVAM_EII_CONFIG"))
        self.registry = registry or PipelineRegistry(settings)
        self._stop = threading.Event()
        self._ingest_stop = threading.Event()
        self._sub_thread: threading.Thread | None = None
        self.subscriber: MsgBusSubscriber | None = None
        self.app_source: AppSource | None = None
        self.instance = None
        self.publish_frame = False
        self.enc_type = None
        self.enc_level = None

        self.publisher: MsgBusPublisher | None = None
        self._pub_cfg_snapshot: str = ""
        #: last hot-reload failure message (None = healthy); the last
        #: config that produced a running pipeline backs the fallback.
        self.reload_error: str | None = None
        self._last_good_cfg: dict[str, Any] | None = None
        self._build_publisher()

        boot_cfg = self.cfg.get_app_config()
        self._start_pipeline(boot_cfg)
        self._last_good_cfg = boot_cfg
        # Working hot-reload: restart the pipeline when the config
        # store changes.
        self.cfg.watch(self._on_config_update)

    def _build_publisher(self) -> None:
        """(Re)create the results publisher from the current interface
        config — hot reload must honor edited Publishers entries too."""
        if self.cfg.get_num_publishers() < 1:
            raise ValueError(
                "EII config needs at least one interfaces.Publishers entry")
        pub_cfg = self.cfg.get_publisher_by_index(0)
        snapshot = json.dumps(pub_cfg, sort_keys=True)
        if self.publisher is not None and snapshot == self._pub_cfg_snapshot:
            return
        topics = pub_cfg.get("Topics") or ["evam_tpu"]
        # build-then-swap: a failing new publisher must leave the old
        # one usable for the hot-reload fallback path
        new_pub = MsgBusPublisher(pub_cfg, topics[0])
        if self.publisher is not None:
            self.publisher.close()
        self.publisher = new_pub
        self._pub_cfg_snapshot = snapshot

    # ------------------------------------------------------- pipeline

    def _start_pipeline(self, app_cfg: dict[str, Any]) -> None:
        # Publish-side settings refresh with the pipeline (hot reload
        # must honor edited publish_frame/encoding too).
        self.publish_frame = bool(app_cfg.get("publish_frame", False))
        enc = app_cfg.get("encoding") or {}
        self.enc_type = enc.get("type")
        self.enc_level = enc.get("level")
        pipeline = app_cfg.get(
            "pipeline", "object_detection/person_vehicle_bike"
        )
        name, _, version = pipeline.partition("/")
        request: dict[str, Any] = {
            "source": dict(app_cfg.get("source_parameters") or {}),
            "parameters": dict(app_cfg.get("model_parameters") or {}),
        }
        source_obj = None
        if app_cfg.get("source") == "msgbus":
            # frames arrive over the bus instead of from a decoder
            if self.cfg.get_num_subscribers() < 1:
                raise ValueError(
                    "source=msgbus needs an interfaces.Subscribers entry")
            sub_cfg = self.cfg.get_subscriber_by_index(0)
            sub_topic = (sub_cfg.get("Topics") or ["camera1_stream"])[0]
            self._ingest_stop = threading.Event()
            self.subscriber = MsgBusSubscriber(sub_cfg, sub_topic)
            self.app_source = AppSource(maxsize=64)
            source_obj = self.app_source
            request["source"] = {"type": "application"}
            self._sub_thread = threading.Thread(
                target=self._ingest_loop,
                args=(self._ingest_stop, self.subscriber, self.app_source),
                name="msgbus-ingest", daemon=True,
            )
            self._sub_thread.start()
        # pipelines without a metapublish stage (appsink-terminated,
        # like the EII variants of eii/pipelines/) publish from the sink
        spec = self.registry.loader.get(name, version)
        has_publish = spec is not None and any(
            s.kind == StageKind.PUBLISH for s in spec.stages
        )
        try:
            self.instance = self.registry.start_instance(
                name, version, request,
                publish_fn=self._publish, source=source_obj,
                sink_fn=None if has_publish else self._publish,
            )
        except Exception:
            # A failed (re)start must not orphan the just-started
            # ingest thread / ZMQ subscription.
            self._teardown_ingest()
            raise
        log.info("EII pipeline %s started (instance %s)",
                 pipeline, self.instance.id[:8])

    def _teardown_ingest(self) -> None:
        """Stop the current subscriber/ingest thread so a restart never
        stacks leaked threads or stale ZMQ subscriptions."""
        self._ingest_stop.set()
        if self._sub_thread is not None:
            self._sub_thread.join(timeout=5)
            self._sub_thread = None
        if self.subscriber is not None:
            self.subscriber.close()
            self.subscriber = None
        self.app_source = None

    def _on_config_update(self, data: dict[str, Any]) -> None:
        log.info("config changed: restarting pipeline")
        if self.instance is not None:
            self.registry.stop_instance(self.instance.id)
            self.instance.wait(timeout=10)
            self.instance = None
        self._teardown_ingest()
        try:
            # publisher rebuild and config fetch can fail on a bad
            # Publishers entry too — everything after the old pipeline
            # stopped must fall back, or the service is left silently
            # pipeline-less while reporting healthy
            self._build_publisher()
            new_cfg = self.cfg.get_app_config()
            self._start_pipeline(new_cfg)
        except Exception as exc:  # noqa: BLE001 — keep serving on bad reload
            # A bad new config must not leave the service silently
            # pipeline-less (the watch loop swallows exceptions): fall
            # back to the last known-good config and flag the failure
            # so /healthz-style monitoring can see it.
            log.error("hot-reload failed (%s); reverting to last "
                      "known-good config", exc)
            self.reload_error = str(exc)
            if self._last_good_cfg is not None:
                try:
                    self._start_pipeline(self._last_good_cfg)
                except Exception as exc2:  # noqa: BLE001
                    log.error("fallback restart also failed: %s", exc2)
            return
        self.reload_error = None
        self._last_good_cfg = new_cfg

    # -------------------------------------------------------- publish

    def _publish(self, ctx: FrameContext) -> None:
        meta: dict[str, Any] = {
            "img_handle": secrets.token_hex(6),
            "width": ctx.width,
            "height": ctx.height,
            "channels": 3,
            "caps": (
                f"video/x-raw, format=BGR, width={ctx.width}, "
                f"height={ctx.height}"
            ),
            "gva_meta": _gva_meta(ctx),
        }
        if ctx.metadata:
            # Keep the EVA-schema fields too (timestamp, source, UDF
            # events) — consumers of either dialect see their keys.
            for k, v in ctx.metadata.items():
                meta.setdefault(k, v)
        blob = None
        if self.publish_frame and ctx.frame is not None:
            if self.enc_type:
                blob = encode_frame(ctx.frame, self.enc_type, self.enc_level)
                meta["encoding_type"] = self.enc_type
                meta["encoding_level"] = self.enc_level
            else:
                blob = np.ascontiguousarray(ctx.frame).tobytes()
        self.publisher.publish(meta, blob)
        metrics.inc("evam_eii_published")

    # --------------------------------------------------------- ingest

    def _ingest_loop(
        self,
        stop: threading.Event,
        subscriber: MsgBusSubscriber,
        app_source: AppSource,
    ) -> None:
        while not self._stop.is_set() and not stop.is_set():
            msg = subscriber.recv()
            if msg is None:
                continue
            meta, blob = msg
            if blob is None:
                continue
            try:
                h = int(meta.get("height", 0))
                w = int(meta.get("width", 0))
                if meta.get("encoding_type"):
                    frame = decode_frame(blob, meta["encoding_type"])
                else:
                    frame = np.frombuffer(blob, np.uint8).reshape(h, w, 3)
                app_source.push(frame)
            except Exception as exc:  # noqa: BLE001 — bad frame, keep going
                log.warning("msgbus ingest: dropped bad frame (%s)", exc)
                metrics.inc("evam_eii_ingest_drops")

    # ------------------------------------------------------ lifecycle

    def run_forever(self) -> None:
        """Block until stopped, then stop everything."""
        try:
            while not self._stop.wait(0.5):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        if self.app_source is not None:
            self.app_source.end()
        self._teardown_ingest()
        self.cfg.close()
        self.registry.stop_all()
        self.publisher.close()


def run_eii_service(settings: Settings) -> int:
    """Blocking entry point of ``serve --mode EII`` (``RUN_MODE=EII``).

    Runs on ``settings.device``: the card unless ``EVAM_PLATFORM=cpu``,
    raising without one, as ``serve`` in EVA mode does, after
    ``init_observability`` (PROFILING_MODE's ranges). SIGTERM (a
    container stop) drains the pipeline and closes the bus sockets; the
    process then returns 0. The start-up heap is settled
    (``server.app.settle_heap``) once the pipeline is up.
    """
    import signal

    from evam_tpu_torch.obs.trace import init_observability
    from evam_tpu_torch.server.app import settle_heap

    init_observability(settings)
    manager = EiiManager(settings)

    def _on_term(signum, frame):  # noqa: ARG001 — signal API
        log.info("SIGTERM: draining EII service")
        manager._stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    log.info("start-up heap settled: %d objects frozen", settle_heap())
    log.info("EII service running (device %s)", settings.device)
    manager.run_forever()
    return 0
