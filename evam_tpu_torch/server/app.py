"""REST API — route-for-route counterpart of ``evam_tpu/server/app.py``:

    GET    /pipelines
    GET    /pipelines/status
    GET    /pipelines/{name}/{version}
    POST   /pipelines/{name}/{version}        → instance id
    GET    /pipelines/{name}/{version}/{id}
    GET    /pipelines/{name}/{version}/{id}/status
    DELETE /pipelines/{name}/{version}/{id}
    GET    /models, /engines, /metrics, /healthz

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
501 with the slice in the error. ``/scheduler`` and ``/traces`` answer
501 until their slices.
"""

from __future__ import annotations

import json
import logging
import re
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
from urllib.parse import unquote, urlsplit

from evam_tpu_torch import slices
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.models.registry import MissingWeightsError
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.ops import qgemm
from evam_tpu_torch.server.registry import (
    PRIORITIES,
    PipelineRegistry,
    RequestError,
)

log = logging.getLogger("evam_tpu_torch.server.app")

#: the reference's persistent AOT cache miss reasons (the /healthz
#: ``aot`` block's keys; the cache comes with a later slice)
_AOT_MISS_REASONS = ("absent", "version", "crc", "deserialize", "execute")


class Response:
    """Status, body bytes and content type of one answer."""

    def __init__(self, status: int, payload: Any = None,
                 text: str | None = None):
        self.status = status
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
            ("GET", "/scheduler", self.later(slices.ENGINE_DEPTH)),
            ("GET", "/metrics", self.metrics_endpoint),
            ("GET", "/traces", self.later(slices.TRACE_STATE)),
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
        return Response(200, self.registry.hub.stats())

    def metrics_endpoint(self, params, body) -> Response:
        # the hand kernel's launches so far, as its wrapper counts them
        # where it launches (the plain version on the CPU counts none)
        for variant, n in qgemm.variant_launches.items():
            metrics.set("evam_kernel_launches", n,
                        labels={"kernel": "qgemm", "variant": variant})
        return Response(200, text=metrics.render())

    @staticmethod
    def later(slice_: str) -> Handler:
        def handler(params, body) -> Response:
            return _error(501, f"this route comes with {slice_}")
        return handler

    def healthz(self, params, body) -> Response:
        hub = self.registry.hub
        ready: dict[str, Any] = dict(hub.readiness())
        ready["host_stages_ms"] = hub.stage_summary()
        ready["queue"] = hub.queue_summary()
        # the reference's off-path blocks: no scheduler (every start is
        # admitted and counted, none rejected or shed), no gate, no AOT
        # cache in this slice
        ready["scheduler"] = {
            "enabled": False,
            "admitted": dict(self.registry.admitted),
            "rejected": dict.fromkeys(PRIORITIES, 0),
            "shed": dict.fromkeys(PRIORITIES, 0),
        }
        ready["gate"] = {"streams": 0, "ran": 0, "skipped": 0,
                         "skip_rate": 0.0, "skipped_fps": 0.0}
        ready["aot"] = {"enabled": False, "entries": 0, "bytes": 0,
                        "max_bytes": 0, "hits": 0,
                        "misses": dict.fromkeys(_AOT_MISS_REASONS, 0),
                        "evictions": 0}
        return Response(200, {"status": "ok", **ready})


def _handler_class(app: App) -> type[BaseHTTPRequestHandler]:
    class RequestHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _answer(self) -> None:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            resp = app.handle(self.command, self.path, body)
            self.send_response(resp.status)
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


def run_server(settings: Settings) -> int:
    """Blocking entry point of ``serve``: answers until SIGINT or
    SIGTERM, then stops every instance and the engines, and returns 0."""
    registry = PipelineRegistry(settings)
    server = make_server(App(registry), port=settings.rest_port)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    thread = threading.Thread(target=server.serve_forever,
                              name="rest-server", daemon=True)
    thread.start()
    log.info("REST serving on :%d (device %s)", settings.rest_port,
             settings.device)
    try:
        while not stop.wait(0.5):
            pass
    finally:
        log.info("shutting down")
        server.shutdown()
        server.server_close()
        registry.stop_all()
    return 0
