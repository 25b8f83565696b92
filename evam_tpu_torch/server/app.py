"""REST API — route-for-route counterpart of ``evam_tpu/server/app.py``:

    GET    /pipelines
    GET    /pipelines/status
    GET    /pipelines/{name}/{version}
    POST   /pipelines/{name}/{version}        → instance id
    GET    /pipelines/{name}/{version}/{id}
    GET    /pipelines/{name}/{version}/{id}/status
    DELETE /pipelines/{name}/{version}/{id}
    GET    /models, /engines, /scheduler, /metrics, /traces, /healthz

``/metrics`` also carries ``evam_kernel_launches{kernel, variant}``,
the hand kernels' launch counts since the process started.

The card's machine has no aiohttp, so the front end is the standard
library's ``ThreadingHTTPServer``: one daemon thread per request, so a
POST that builds an engine (and, on a cold cache, its kernel) holds
only its own connection. Frames never touch it. Status codes and
``{"error": ...}`` bodies follow the reference: bad JSON or a body
that is not an object → 400, ``KeyError`` → 404, ``MissingWeightsError``
/ ``RequestError`` / ``ValueError`` → 400; a pipeline, source or
destination that waits for a later slice (``NotImplementedError``) →
501 with the slice in the error; a start over the admission ceiling
(``AdmissionError``) → 503 with ``Retry-After`` and ``{"error",
"retry_after_s"}``. ``/traces`` serves the trace ring
(``obs/trace.py`` ``traces_payload``: the ring's counters and its
frames and batches as Chrome trace events); ``/engines`` carries the
checkpoint store's ``checkpoint`` block with EVAM_CKPT on.
"""

from __future__ import annotations

import gc
import json
import logging
import re
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import unquote, urlsplit

from evam_tpu_torch import aot
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.models.registry import MissingWeightsError
from evam_tpu_torch.obs import trace
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.ops import qgemm
from evam_tpu_torch.publish.rtsp import RtspServer
from evam_tpu_torch.sched import AdmissionError
from evam_tpu_torch.server.registry import PipelineRegistry, RequestError
from evam_tpu_torch.stages.gate import registry as gate_registry

log = logging.getLogger("evam_tpu_torch.server.app")

class Response:
    """Status, body bytes and content type of one answer."""

    def __init__(self, status: int, payload: Any = None,
                 text: str | None = None,
                 headers: dict[str, str] | None = None):
        self.status = status
        self.headers = headers or {}
        if text is not None:
            self.body = text.encode()
            self.content_type = "text/plain; charset=utf-8"
        else:
            self.body = json.dumps(payload).encode()
            self.content_type = "application/json; charset=utf-8"


def _error(status: int, message: str) -> Response:
    return Response(status, {"error": message})


Handler = Callable[[dict[str, str], bytes], Response]


class App:
    """The route table over one PipelineRegistry; :meth:`handle` answers
    a request without any socket (the HTTP layer only moves bytes)."""

    def __init__(self, registry: PipelineRegistry):
        self.registry = registry
        self.routes: list[tuple[str, re.Pattern, Handler]] = []
        for method, path, handler in [
            ("GET", "/pipelines", self.list_pipelines),
            ("GET", "/pipelines/status", self.all_statuses),
            ("GET", "/pipelines/{name}/{version}", self.describe),
            ("POST", "/pipelines/{name}/{version}", self.start),
            ("GET", "/pipelines/{name}/{version}/{instance_id}",
             self.instance_summary),
            ("GET", "/pipelines/{name}/{version}/{instance_id}/status",
             self.instance_status),
            ("DELETE", "/pipelines/{name}/{version}/{instance_id}",
             self.instance_stop),
            ("GET", "/models", self.list_models),
            ("GET", "/engines", self.engines),
            ("GET", "/scheduler", self.scheduler),
            ("GET", "/metrics", self.metrics_endpoint),
            ("GET", "/traces", self.traces),
            ("GET", "/healthz", self.healthz),
        ]:
            pattern = re.compile(
                "^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", path) + "$")
            self.routes.append((method, pattern, handler))

    def handle(self, method: str, path: str, body: bytes) -> Response:
        path = urlsplit(path).path
        allowed = False
        for route_method, pattern, handler in self.routes:
            m = pattern.match(path)
            if m is None:
                continue
            if route_method != method:
                allowed = True
                continue
            params = {k: unquote(v) for k, v in m.groupdict().items()}
            try:
                return handler(params, body)
            except Exception as exc:  # noqa: BLE001 — the request boundary
                log.exception("%s %s failed", method, path)
                return _error(500, f"{type(exc).__name__}: {exc}")
        if allowed:
            return _error(405, f"method {method} not allowed on {path}")
        return _error(404, f"no route {path}")

    # ---------------------------------------------------------- routes

    def list_pipelines(self, params, body) -> Response:
        return Response(200, self.registry.pipelines())

    def all_statuses(self, params, body) -> Response:
        return Response(200, self.registry.statuses())

    def describe(self, params, body) -> Response:
        name, version = params["name"], params["version"]
        desc = self.registry.describe(name, version)
        if desc is None:
            return _error(404, f"pipeline {name}/{version} not found")
        return Response(200, desc)

    def start(self, params, body) -> Response:
        try:
            request = json.loads(body or b"")
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _error(400, "request body must be JSON")
        if not isinstance(request, dict):
            return _error(400, "request body must be a JSON object")
        try:
            instance = self.registry.start_instance(
                params["name"], params["version"], request)
        except AdmissionError as exc:
            # over capacity: 503 and a back-off hint, never an
            # oversubscription that degrades the admitted streams
            return Response(
                503, {"error": str(exc), "retry_after_s": exc.retry_after_s},
                headers={"Retry-After": str(int(exc.retry_after_s))})
        except KeyError as exc:
            return _error(404, str(exc.args[0]))
        except MissingWeightsError as exc:
            # deployment problem, not a server bug: surface the
            # actionable message (install weights / set the allow flag)
            return _error(400, str(exc))
        except (RequestError, ValueError) as exc:
            return _error(400, str(exc))
        except NotImplementedError as exc:
            return _error(501, str(exc))
        # The reference returns the bare instance id.
        return Response(200, instance.id)

    def _find(self, params):
        inst = self.registry.get_instance(params["instance_id"])
        if inst is None or (inst.pipeline_name, inst.version) != (
                params["name"], params["version"]):
            return None
        return inst

    def instance_summary(self, params, body) -> Response:
        inst = self._find(params)
        if inst is None:
            return _error(404, "instance not found")
        return Response(200, inst.summary())

    def instance_status(self, params, body) -> Response:
        inst = self._find(params)
        if inst is None:
            return _error(404, "instance not found")
        return Response(200, inst.status())

    def instance_stop(self, params, body) -> Response:
        inst = self._find(params)
        if inst is None:
            return _error(404, "instance not found")
        self.registry.stop_instance(inst.id)
        return Response(200, inst.status())

    def list_models(self, params, body) -> Response:
        # name/version rows + weight provenance (msgpack / ir-bin /
        # random / absent)
        return Response(200, self.registry.hub.registry.describe())

    def engines(self, params, body) -> Response:
        payload = self.registry.hub.stats()
        # the checkpoint store's counters beside the engine rows (an
        # engine key always holds ':', so the key cannot collide);
        # absent with EVAM_CKPT off
        from evam_tpu_torch.state import active as ckpt_active

        store = ckpt_active()
        if store is not None:
            payload["checkpoint"] = store.summary()
        return Response(200, payload)

    def scheduler(self, params, body) -> Response:
        return Response(200, self.registry.scheduler_status())

    def metrics_endpoint(self, params, body) -> Response:
        # the hand kernel's launches so far, as its wrapper counts them
        # where it launches (the plain version on the CPU counts none)
        for variant, n in qgemm.variant_launches.items():
            metrics.set("evam_kernel_launches", n,
                        labels={"kernel": "qgemm", "variant": variant})
        return Response(200, text=metrics.render())

    def traces(self, params, body) -> Response:
        # each request has its own thread: the snapshot never holds up
        # another route
        return Response(200, trace.traces_payload())

    def healthz(self, params, body) -> Response:
        hub = self.registry.hub
        ready: dict[str, Any] = dict(hub.readiness())
        ready["host_stages_ms"] = hub.stage_summary()
        ready["queue"] = hub.queue_summary()
        # the QoS ladder (admit → queue → shed) per class
        counts = self.registry.admission.counts()
        ready["scheduler"] = {
            "enabled": self.registry.sched_cfg.enabled,
            "admitted": counts["admitted"],
            "rejected": counts["rejected"],
            "shed": hub.shed_totals(),
        }
        # the motion gates' run/skip totals and live skipped-frames/s
        # (fixed keys, all zero while nothing gates)
        ready["gate"] = gate_registry.summary()
        # the persistent AOT cache: entry/byte counts, hits and the
        # per-reason miss ladder (aot.MISS_REASONS); fixed keys from
        # boot, zeros with EVAM_AOT=off — golden shape
        ready["aot"] = aot.summary()
        # the shared ingest serves every live stream: its frame
        # counters beside the engines' readiness
        if self.registry.rtsp_demux is not None:
            ready["rtsp_demux"] = self.registry.rtsp_demux.stats()
        if self.registry.decode_pool is not None:
            ready["decode_pool"] = self.registry.decode_pool.stats()
        # the engine-failure ladder, most severe first, all 503 so a
        # readiness probe takes the process out of rotation: degraded
        # is terminal (restart budget spent), restarting transient (a
        # supervisor rebuild), stalled a wedge with supervision off
        for state in ("degraded", "restarting", "stalled"):
            if ready.get(state):
                return Response(503, {"status": state, **ready})
        status = "warming" if ready["warming"] else "ok"
        return Response(200, {"status": status, **ready})


def _handler_class(app: App) -> type[BaseHTTPRequestHandler]:
    class RequestHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _answer(self) -> None:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            resp = app.handle(self.command, self.path, body)
            self.send_response(resp.status)
            for key, value in resp.headers.items():
                self.send_header(key, value)
            self.send_header("Content-Type", resp.content_type)
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            self.wfile.write(resp.body)

        do_GET = do_POST = do_DELETE = do_PUT = do_PATCH = _answer

        def log_message(self, fmt, *args) -> None:
            log.debug("%s %s", self.address_string(), fmt % args)

    return RequestHandler


def make_server(app: App, host: str = "0.0.0.0",
                port: int = 8080) -> ThreadingHTTPServer:
    """A bound (not yet serving) HTTP server for ``app``; port 0 picks a
    free one (``server.server_address[1]``)."""
    server = ThreadingHTTPServer((host, port), _handler_class(app))
    server.daemon_threads = True
    return server


def settle_heap() -> int:
    """Take the start-up heap out of the cyclic collector's scans; returns
    the objects frozen.

    A full collection walks every tracked object with the interpreter
    lock held, so every stream, dispatcher, launcher and completer
    thread waits for it, and a realtime frame can outlive its staleness
    budget in the queue meanwhile. Most of those objects (torch, the
    port's modules, the preloaded models and engines) live as long as
    the process: after a full collection, ``gc.freeze`` moves them to
    the permanent generation, and every later collection walks only
    what came after. Called once, when a serving process's start-up is
    done."""
    gc.collect()
    gc.freeze()
    return gc.get_freeze_count()


def run_server(settings: Settings) -> int:
    """Blocking entry point of ``serve``: answers until SIGINT or
    SIGTERM, then stops every instance and the engines, and returns 0.
    With ENABLE_RTSP the RTSP re-stream server listens on RTSP_PORT
    first; then the streams a previous run left in ``EVAM_STATE_DIR``
    are resumed (a resumed ``destination.frame`` mounts again), and the
    start-up heap is settled (``settle_heap``), before the port
    opens."""
    trace.init_observability(settings)
    registry = PipelineRegistry(settings)
    extras = []
    if settings.enable_rtsp:
        rtsp = RtspServer(port=settings.rtsp_port)
        rtsp.start()
        registry.rtsp = rtsp
        extras.append(f"rtsp://0.0.0.0:{rtsp.port}")
    registry.resume()
    if settings.preload:
        n = registry.preload(settings.preload)
        log.info("preloaded %d pipeline(s) before opening the port", n)
    log.info("start-up heap settled: %d objects frozen", settle_heap())
    server = make_server(App(registry), port=settings.rest_port)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    thread = threading.Thread(target=server.serve_forever,
                              name="rest-server", daemon=True)
    thread.start()
    log.info("REST serving on :%d (device %s)%s", settings.rest_port,
             settings.device, f" + {', '.join(extras)}" if extras else "")
    try:
        while not stop.wait(0.5):
            pass
    finally:
        log.info("shutting down")
        server.shutdown()
        server.server_close()
        registry.stop_all()
        if registry.rtsp is not None:
            registry.rtsp.stop()
    return 0
