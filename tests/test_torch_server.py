"""The port's REST surface on the CPU, over real HTTP on 127.0.0.1.

* Every in-scope route golden of ``tests/golden/`` holds for the port's
  answers in canonical form (the goldens are read, never written).
* The same request, with the same weights (the reference's registry
  saves its parameters into a models dir that both registries read),
  goes through the reference's server and the port's, for each SSD
  pipeline the port serves (person-vehicle-bike, vehicle, and person,
  whose 320×544 input is cut to a non-square 64×96 in both registries
  so the anchor grid, resize and box scaling at H ≠ W are compared);
  the published JSON lines agree:

  - same count, timestamps and resolutions;
  - float32: equal labels, boxes and confidences within 1e-4;
  - INT8 with ``EVAM_QGEMM=pallas``: at least 95 % of the reference's
    objects are matched by a port object of the same label with IoU ≥
    0.9 (the tolerance of ``tests/test_torch_slice.py``: bf16 rounding
    at another place can reorder near-ties in top-k and NMS).

* The EII pipelines (detect → sink, no publish stage) complete in both
  servers with the same engine and frame count and publish nothing;
  their detect stage is the one compared above (same model key, and
  the same resolved stage specs, ``tests/test_torch_graph.py``).
* ``GET /scheduler`` holds ``route_scheduler.json``, and a start past
  a declared capacity answers 503 with ``Retry-After`` in the shape of
  ``route_503_admission.json``.
* DELETE reaches ABORTED; an application source and a zmq destination
  answer as the reference's do (a pyzmq subscriber reads the zmq
  destination's metadata); the WebRTC frame destination is ignored
  without ENABLE_WEBRTC, as in the reference, and registers its stream
  with a signalling server with it; every pipeline serves, and
  the requests slice 4 brought (tracking, zone count, the motion gate)
  serve; ``EVAM_GATE=on`` builds a gate in ``DetectStage`` and
  ``EVAM_GATE=off`` beats ``adaptive``; ``python -m
  evam_tpu_torch.cli.main list`` prints the reference's JSON, and
  ``serve`` answers on the CPU with ``EVAM_PLATFORM=cpu``, with ragged
  packing, the scheduler and the control plane on too (and refuses to
  start without a card otherwise; EVAM_FLEET=sharded on its one device
  degrades to off).
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from test_golden import canonical  # read-only use: never check_golden

from evam_tpu import native
from evam_tpu.cli import main as ref_cli
from evam_tpu.config import settings as ref_settings
from evam_tpu.engine import EngineHub as JaxHub
from evam_tpu.models import ModelRegistry as JaxRegistry
from evam_tpu.ops import qlinear as jql
from evam_tpu.parallel import build_mesh
from evam_tpu.server.app import build_app
from evam_tpu.server.instance import _retry_delay as ref_retry_delay
from evam_tpu.server.registry import PipelineRegistry as JaxPipelineRegistry
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.engine.ringbuf import STAGES
from evam_tpu_torch.graph import PipelineLoader
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops import qgemm as tqg
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.sched import SchedConfig
from evam_tpu_torch.server import app as app_module
from evam_tpu_torch.server.app import App, make_server, settle_heap
from evam_tpu_torch.server.instance import StreamInstance, _retry_delay
from evam_tpu_torch.server.registry import PipelineRegistry
from evam_tpu_torch.stages.infer import DetectStage

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
GOLDEN_DIR = REPO / "tests" / "golden"
KEY = "object_detection/person_vehicle_bike"
PIPE = "/pipelines/" + KEY
#: every SSD the port serves, at a small input (the person model's
#: 320×544 cut to 64×96 stays non-square, H < W) and width 8; each key
#: is also the name of the pipeline that serves it
SMALL = {KEY: (64, 64), "object_detection/person": (64, 96),
         "object_detection/vehicle": (64, 64)}
NARROW = {k: 8 for k in SMALL}


def _golden(name: str):
    return json.loads((GOLDEN_DIR / f"{name}.json").read_text())


def _assert_golden(name: str, got) -> None:
    assert canonical(got) == _golden(name), (
        f"{name}: {json.dumps(canonical(got), indent=1, sort_keys=True)}")


class PortServer:
    """The port's server on a free 127.0.0.1 port, in a thread."""

    def __init__(self, registry: PipelineRegistry):
        self.registry = registry
        self.server = make_server(App(registry), "127.0.0.1", 0)
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def request(self, method: str, path: str, body=None, raw: bytes | None = None):
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                payload = resp.read()
                status = resp.status
        except urllib.error.HTTPError as exc:
            payload, status = exc.read(), exc.code
        try:
            return status, json.loads(payload)
        except json.JSONDecodeError:
            return status, payload.decode()

    def wait(self, iid: str, timeout: float = 60, path: str = PIPE) -> dict:
        deadline = time.time() + timeout
        while time.time() < deadline:
            _, st = self.request("GET", f"{path}/{iid}/status")
            if st["state"] in ("COMPLETED", "ERROR", "ABORTED"):
                return st
            time.sleep(0.05)
        raise TimeoutError(f"instance {iid} did not finish")

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.registry.stop_all()


def _port_registry(models_dir=None, dtype="float32",
                   pipelines="pipelines", **hub_kw) -> PipelineRegistry:
    registry = ModelRegistry(models_dir=models_dir, dtype=dtype, device="cpu",
                             input_overrides=SMALL, width_overrides=NARROW,
                             allow_random_weights=True)
    hub = EngineHub(registry, device="cpu", max_batch=16, deadline_ms=4.0,
                    **hub_kw)
    settings = Settings(pipelines_dir=str(REPO / pipelines), device="cpu",
                        drain_timeout_s=10.0)
    return PipelineRegistry(settings, hub=hub)


@pytest.fixture
def server():
    """A port server whose model serves seeded random weights (the
    goldens' ``weights: random``)."""
    srv = PortServer(_port_registry())
    yield srv
    srv.close()


def _body(out: Path, uri="synthetic://96x96@30?count=6", **extra) -> dict:
    return {"source": {"uri": uri, "type": "uri"},
            "destination": {"metadata": {"type": "file", "path": str(out)}},
            **extra}


# ------------------------------------------------------------- goldens


def test_definition_routes_hold_their_goldens(server):
    status, data = server.request("GET", "/pipelines")
    assert status == 200
    _assert_golden("route_get_pipelines", data)
    status, data = server.request("GET", PIPE)
    assert status == 200
    _assert_golden("route_describe_pipeline", data)
    status, data = server.request("GET", "/models")
    assert status == 200
    _assert_golden("route_get_models", data)


def test_running_instance_routes_and_delete_aborts(server, tmp_path):
    """A stream with no frame count runs until DELETE: its summary and
    status hold their goldens (state RUNNING), and DELETE aborts it."""
    status, iid = server.request(
        "POST", PIPE, _body(tmp_path / "o.jsonl", "synthetic://96x96@30"))
    assert status == 200
    _assert_golden("route_post_start", iid)
    status, summary = server.request("GET", f"{PIPE}/{iid}")
    assert status == 200
    _assert_golden("route_instance_summary", summary)
    status, st = server.request("GET", f"{PIPE}/{iid}/status")
    assert status == 200
    _assert_golden("route_instance_status", st)
    deadline = time.time() + 60
    while not (tmp_path / "o.jsonl").exists() or \
            not (tmp_path / "o.jsonl").read_text():
        assert time.time() < deadline, "the stream published nothing"
        time.sleep(0.05)
    status, stopped = server.request("DELETE", f"{PIPE}/{iid}")
    assert status == 200
    assert server.wait(iid)["state"] == "ABORTED"


def test_completed_instance_routes_and_health(server, tmp_path):
    status, iid = server.request("POST", PIPE, _body(tmp_path / "o.jsonl"))
    assert status == 200
    assert server.wait(iid)["state"] == "COMPLETED"
    status, stopped = server.request("DELETE", f"{PIPE}/{iid}")
    assert status == 200
    _assert_golden("route_delete_instance", stopped)
    status, all_st = server.request("GET", "/pipelines/status")
    assert status == 200
    _assert_golden("route_all_statuses", all_st)
    status, health = server.request("GET", "/healthz")
    assert status == 200
    _assert_golden("route_healthz", health)
    assert health["scheduler"]["enabled"] is False
    assert health["scheduler"]["admitted"]["standard"] == 1
    assert health["host_stages_ms"]["launch"] > 0
    # the default engine seals a staging slot per batch
    assert health["host_stages_ms"]["seal"] > 0.0
    status, engines = server.request("GET", "/engines")
    assert list(engines) == [f"detect:{KEY}"]
    assert engines[f"detect:{KEY}"]["items"] == 6
    lines = (tmp_path / "o.jsonl").read_text().splitlines()
    assert len(lines) == 6
    status, text = server.request("GET", "/metrics")
    assert status == 200 and "evam_frames_processed_total" in text
    # the float model on the CPU launches no kernel; the lines read the
    # wrapper's own counts
    for variant, n in tqg.variant_launches.items():
        assert (f'evam_kernel_launches{{kernel="qgemm",variant="{variant}"}} '
                f"{n}\n") in text


def test_error_routes_hold_their_goldens(server, tmp_path):
    status, data = server.request("GET", "/pipelines/object_detection/nope")
    assert status == 404
    _assert_golden("route_404_pipeline", data)
    status, data = server.request("POST", PIPE, {"destination": {}})
    assert status == 400
    _assert_golden("route_400_bad_request", data)
    status, data = server.request("GET", f"{PIPE}/no-such-id/status")
    assert status == 404
    _assert_golden("route_404_instance", data)
    status, data = server.request(
        "POST", PIPE, {**_body(tmp_path / "o.jsonl"), "priority": "turbo"})
    assert status == 400
    _assert_golden("route_400_bad_priority", data)
    status, data = server.request("POST", PIPE, raw=b"{not json")
    assert (status, data) == (400, {"error": "request body must be JSON"})
    status, data = server.request("POST", PIPE, raw=b"[1]")
    assert (status, data) == (400, {"error": "request body must be a JSON object"})
    status, data = server.request("POST", "/pipelines/object_detection/nope",
                                  _body(tmp_path / "o.jsonl"))
    assert status == 404
    assert not (tmp_path / "o.jsonl").exists()


@pytest.mark.parametrize("frame", [{"type": "webrtc"},
                                   {"type": "webrtc", "peer-id": "cam0"}],
                         ids=["bare", "peer-id"])
def test_webrtc_destination_without_enable_webrtc_serves(server, tmp_path,
                                                         frame):
    """As in the reference (``evam_tpu/server/registry.py:334-336``): a
    ``webrtc`` frame destination while ENABLE_WEBRTC is off (no
    signalling server either) is ignored; the stream serves and
    publishes its metadata."""
    out = tmp_path / "o.jsonl"
    body = _body(out)
    body["destination"]["frame"] = frame
    status, iid = server.request("POST", PIPE, body)
    assert status == 200, iid
    assert server.wait(iid)["state"] == "COMPLETED"
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 6
    assert all("objects" in m for m in lines)


def test_webrtc_destination_registers_with_the_signaling_server(tmp_path):
    """With ENABLE_WEBRTC and a signalling server on 127.0.0.1, a start
    with ``frame: {type: webrtc, peer-id: cam0}`` registers its stream
    as ``cam0`` while it runs; its end stops the signaler, which leaves
    the server."""
    from evam_tpu_torch.publish.rtc.signaling import SignalingServer

    relay_srv = SignalingServer("127.0.0.1", 0).start()
    registry = _port_registry()
    registry.settings.enable_webrtc = True
    registry.settings.webrtc_signaling_server = \
        f"ws://127.0.0.1:{relay_srv.port}"
    srv = PortServer(registry)
    try:
        out = tmp_path / "o.jsonl"
        body = _body(out, "synthetic://96x96@30?count=100000")
        body["destination"]["frame"] = {"type": "webrtc", "peer-id": "cam0"}
        status, iid = srv.request("POST", PIPE, body)
        assert status == 200, iid
        deadline = time.time() + 30
        while "cam0" not in relay_srv.services and time.time() < deadline:
            time.sleep(0.02)
        assert list(relay_srv.services) == ["cam0"]
        srv.request("DELETE", f"{PIPE}/{iid}")
        assert srv.wait(iid)["state"] == "ABORTED"
        deadline = time.time() + 30
        while relay_srv.services and time.time() < deadline:
            time.sleep(0.02)
        assert relay_srv.services == {}
    finally:
        srv.close()
        relay_srv.stop()


@pytest.mark.parametrize("ring", ["empty", "served", "off"])
def test_traces_route_holds_its_golden(server, tmp_path, ring, monkeypatch):
    """GET /traces answers 200 in the shape of route_traces.json: the
    empty ring exactly (as the reference's golden test reads it), a
    ring after a served stream with the same keys and types, its frames
    carrying stage, queue-wait and dispatch spans and its batches the
    eight stages, and with EVAM_TRACE=0 the disabled payload."""
    from evam_tpu_torch.config.settings import reset_settings
    from evam_tpu_torch.obs import trace

    if ring == "off":
        monkeypatch.setenv("EVAM_TRACE", "0")
    reset_settings()
    trace.reset_cache()
    try:
        if ring == "served":
            # keep every frame: the stream is short
            trace.active().sample_n = 1
            status, iid = server.request(
                "POST", PIPE, _body(tmp_path / "o.jsonl",
                                    "synthetic://96x96@30?count=4"))
            assert status == 200
            assert server.wait(iid)["state"] == "COMPLETED"
        deadline = time.time() + 10
        while True:
            # the completer retires a batch's record just after it
            # resolves the batch's futures
            status, data = server.request("GET", "/traces")
            if not data["pending"] or time.time() > deadline:
                break
            time.sleep(0.05)
        assert status == 200
        assert data["enabled"] is (ring != "off")
        if ring != "served":
            _assert_golden("route_traces", data)
            return
        golden = _golden("route_traces")
        assert canonical({**data, "traceEvents": []}) == golden
        assert data["pending"] == 0 and data["batches"] >= 1
        frames = [e for e in data["traceEvents"]
                  if e["cat"] == "frame" and e["tid"] == iid]
        assert len({e["args"]["trace_id"] for e in frames}) == 4
        names = {e["name"] for e in frames}
        assert {"sched.queue_wait", "engine.dispatch"} <= names
        assert any(n.startswith("stage.") and n.endswith(".complete")
                   for n in names), names
        batches = [e for e in data["traceEvents"] if e["cat"] == "batch"]
        for ev in batches:
            assert set(ev["args"]["stages"]) == set(STAGES)
            assert ev["args"]["device"] == "cpu"
            assert ev["args"]["last_stage"] == "resolve"
    finally:
        monkeypatch.delenv("EVAM_TRACE", raising=False)
        reset_settings()
        trace.reset_cache()


APP_DST = "/pipelines/video_decode/app_dst"


def _reference_requests(requests: list) -> list:
    """(status, body) of each ``(method, path, body)`` in turn through
    the reference's server (aiohttp TestClient); a ``path`` may name
    ``{id}``, the id the first request answered. A pipeline without a
    model builds no engine, so nothing compiles."""
    jreg = JaxRegistry(input_overrides=SMALL, width_overrides=NARROW)
    registry = JaxPipelineRegistry(
        ref_settings.Settings(pipelines_dir=str(REPO / "pipelines")),
        hub=JaxHub(jreg, plan=build_mesh(), max_batch=4, deadline_ms=4.0))

    async def go():
        out, iid = [], None
        async with TestClient(TestServer(build_app(registry))) as client:
            for method, path, body in requests:
                resp = await client.request(
                    method, path.format(id=iid), json=body)
                out.append((resp.status, await resp.json()))
                if iid is None and resp.status == 200:
                    iid = out[-1][1]
                    while registry.get_instance(iid).status()["state"] \
                            == "QUEUED":
                        await asyncio.sleep(0.05)
        return out

    try:
        return asyncio.run(go())
    finally:
        registry.stop_all()


def _port_requests(server, requests: list) -> list:
    out, iid = [], None
    for method, path, body in requests:
        out.append(server.request(method, path.format(id=iid), body))
        if iid is None and out[-1][0] == 200:
            iid = out[-1][1]
    return out


def _zmq_body(endpoint: str) -> dict:
    return {"source": {"uri": "synthetic://32x32@30", "type": "uri"},
            "destination": {"metadata": {"type": "zmq",
                                         "endpoint": endpoint}}}


@pytest.mark.parametrize("kind", ["application-source", "zmq-destination"])
def test_application_source_and_zmq_destination_serve_as_the_references(
        server, kind):
    """Slice 8 brought the application source and the zmq destination:
    the same requests get the same answers from both servers. An
    application source runs (nothing feeds it) until DELETE aborts it; a
    zmq destination binds its endpoint, a second stream on the same
    endpoint answers 400, and DELETE aborts the first."""
    def requests():
        if kind == "application-source":
            return [("POST", APP_DST, {"source": {"type": "application"}}),
                    ("GET", APP_DST + "/{id}/status", None),
                    ("DELETE", APP_DST + "/{id}", None)]
        # an endpoint of its own for each server: libzmq releases a
        # closed socket's port in the background
        endpoint = f"tcp://127.0.0.1:{_free_port()}"
        return [("POST", APP_DST, _zmq_body(endpoint)),
                ("POST", APP_DST, _zmq_body(endpoint)),
                ("DELETE", APP_DST + "/{id}", None)]

    ref = _reference_requests(requests())
    got = _port_requests(server, requests())
    assert [s for s, _ in got] == [s for s, _ in ref]
    assert canonical([b for _, b in got]) == canonical([b for _, b in ref])
    if kind == "application-source":
        assert [s for s, _ in got] == [200, 200, 200]
        assert got[1][1]["state"] == ref[1][1]["state"] == "RUNNING"
    else:
        assert [s for s, _ in got] == [200, 400, 200]
        assert "zmq destination endpoint" in got[1][1]["error"]
    assert server.wait(got[0][1], path=APP_DST)["state"] == "ABORTED"


def test_zmq_destination_publishes_to_pyzmq(server):
    """The detect pipeline into a zmq destination: a pyzmq subscriber
    reads [topic, metadata] in the shape of the EVA metadata golden."""
    import zmq

    endpoint = f"tcp://127.0.0.1:{_free_port()}"
    sub = zmq.Context.instance().socket(zmq.SUB)
    sub.setsockopt(zmq.LINGER, 0)
    sub.setsockopt(zmq.RCVTIMEO, 100)
    sub.setsockopt(zmq.SUBSCRIBE, b"evam_tpu")
    body = {"source": {"uri": "synthetic://96x96@30", "type": "uri"},
            "destination": {"metadata": {"type": "zmq",
                                         "endpoint": endpoint}}}
    status, iid = server.request("POST", PIPE, body)
    assert status == 200, iid
    try:
        sub.connect(endpoint)
        deadline = time.time() + 60
        while True:
            try:
                topic, meta = sub.recv_multipart()
                break
            except zmq.Again:
                assert time.time() < deadline, "nothing reached pyzmq"
        meta = json.loads(meta)
        assert topic == b"evam_tpu"
        golden = _golden("message_eva_metadata")
        assert set(canonical(meta)) == set(golden)
        assert meta["resolution"] == {"height": 96, "width": 96}
    finally:
        sub.close()
        server.request("DELETE", f"{PIPE}/{iid}")
    assert server.wait(iid)["state"] == "ABORTED"


def test_scheduler_route_holds_its_golden(server):
    """``GET /scheduler`` answers the reference's payload: the admission
    snapshot, per-class queues and sheds, the queue summary, the fleet
    block (off) and the control plane's block (off here)."""
    status, data = server.request("GET", "/scheduler")
    assert status == 200
    _assert_golden("route_scheduler", data)
    assert data["fleet"]["mode"] == "off"
    assert data["tuning"]["enabled"] is False
    assert data["enabled"] is False


def test_over_capacity_start_holds_the_503_golden(tmp_path):
    """A declared capacity of 10 fps: every 30 fps start projects a
    utilization of 3.0, past every class ceiling — 503 with Retry-After,
    nothing built or opened, the rejection counted on /scheduler and
    /healthz."""
    srv = PortServer(_port_registry(sched=SchedConfig(capacity_fps=10.0)))
    try:
        body = {**_body(tmp_path / "o.jsonl"), "priority": "batch"}
        req = urllib.request.Request(srv.base + PIPE,
                                     data=json.dumps(body).encode(),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as info:
            urllib.request.urlopen(req, timeout=60)
        assert info.value.code == 503
        assert int(info.value.headers["Retry-After"]) >= 1
        data = json.loads(info.value.read())
        _assert_golden("route_503_admission", data)
        assert data["retry_after_s"] == int(info.value.headers["Retry-After"])
        assert not (tmp_path / "o.jsonl").exists()
        assert srv.registry.hub.stats() == {}
        status, sched = srv.request("GET", "/scheduler")
        assert status == 200 and sched["enabled"] is True
        _assert_golden("route_scheduler", sched)
        assert sched["rejected"] == {"realtime": 0, "standard": 0, "batch": 1}
        assert sched["streams"] == {"realtime": 0, "standard": 0, "batch": 0}
        _, health = srv.request("GET", "/healthz")
        assert health["scheduler"]["rejected"]["batch"] == 1
    finally:
        srv.close()


@pytest.mark.parametrize("path,body_extra", [
    ("/pipelines/object_classification/vehicle_attributes",
     {"parameters": {"inference-interval": "adaptive"}}),
    ("/pipelines/object_tracking/person_vehicle_bike", {}),
    ("/pipelines/object_detection/object_zone_count", {}),
    (PIPE, {"parameters": {"inference-interval": "adaptive"}}),
])
def test_slice_4_requests_serve(server, tmp_path, path, body_extra):
    """The requests that answered 501 before slice 4 complete; a gated
    stage reports its gate on the instance status."""
    status, iid = server.request("POST", path,
                                 {**_body(tmp_path / "o.jsonl"), **body_extra})
    assert status == 200, iid
    st = server.wait(iid, path=path)
    assert st["state"] == "COMPLETED"
    assert len((tmp_path / "o.jsonl").read_text().splitlines()) == 6
    gated = "inference-interval" in json.dumps(body_extra)
    assert ("gate" in st) == gated
    if gated:
        (gate,) = st["gate"].values()
        assert gate["enabled"] and gate["ran"] + gate["skipped"] == 6


#: pipelines the port serves: every one of pipelines/ and
#: eii/pipelines/ (a pipeline left out would have to answer 501)
_SERVED = {"pipelines": {("action_recognition", "general"),
                         ("audio_detection", "environment"),
                         ("object_classification", "vehicle_attributes"),
                         ("object_detection", "app_src_dst"),
                         ("object_detection", "object_zone_count"),
                         ("object_detection", "person"),
                         ("object_detection", "person_vehicle_bike"),
                         ("object_detection", "vehicle"),
                         ("object_tracking", "object_line_crossing"),
                         ("object_tracking", "person_vehicle_bike"),
                         ("video_decode", "app_dst")},
           "eii/pipelines": {("object_detection", "person_detection"),
                             ("object_detection", "person_vehicle_bike")}}
_ALL = [(d, n, v) for d in _SERVED
        for n, v in PipelineLoader(REPO / d).names()]


@pytest.mark.parametrize("d,name,version", _ALL,
                         ids=[f"{d}:{n}/{v}" for d, n, v in _ALL])
def test_every_pipeline_serves_or_names_its_slice(d, name, version, tmp_path):
    """Each pipeline either completes a stream (publishing one line per
    frame where it has a publish stage) or answers 501."""
    keys = ("object_detection/person", "object_detection/vehicle", KEY,
            "action_recognition/encoder")
    registry = ModelRegistry(
        dtype="float32", device="cpu", allow_random_weights=True,
        input_overrides={**{k: (64, 64) for k in keys},
                         "audio_detection/environment": (1, 1600)},
        width_overrides={k: 8 for k in keys + (
            "object_classification/vehicle_attributes",
            "action_recognition/decoder", "audio_detection/environment")})
    srv = PortServer(PipelineRegistry(
        Settings(pipelines_dir=str(REPO / d), device="cpu"),
        hub=EngineHub(registry, device="cpu", max_batch=4, deadline_ms=4.0)))
    try:
        status, data = srv.request("POST", f"/pipelines/{name}/{version}",
                                   _body(tmp_path / "o.jsonl"))
        if (name, version) not in _SERVED[d]:
            assert status == 501 and "port slice" in data["error"], data
            return
        assert status == 200, data
        _, st = srv.request("GET", f"/pipelines/{name}/{version}/{data}/status")
        while st["state"] == "RUNNING":
            time.sleep(0.05)
            _, st = srv.request(
                "GET", f"/pipelines/{name}/{version}/{data}/status")
        assert st["state"] == "COMPLETED"
        spec = srv.registry.loader.get(name, version)
        publishes = any(s.kind.value == "publish" for s in spec.stages)
        lines = ((tmp_path / "o.jsonl").read_text().splitlines()
                 if publishes else [])
        assert len(lines) == (6 if publishes else 0)
    finally:
        srv.close()


def test_failing_source_retries_then_errors(tmp_path):
    """A source that cannot open is retried with backoff, then the
    instance ends in ERROR with the cause (on a machine without cv2 the
    message names it)."""
    inst = StreamInstance("object_detection", "person_vehicle_bike", [],
                          {"source": {"uri": str(tmp_path / "none.mp4")}},
                          max_retries=2, retry_backoff_s=0.01)
    inst.start()
    inst.wait(30)
    st = inst.status()
    assert st["state"] == "ERROR"
    assert "cv2" in st["message"] or "cannot open" in st["message"]


def test_retry_delay_is_the_references():
    for attempts in range(8):
        assert _retry_delay(attempts, 1.0, 30.0, random.Random(attempts)) == \
            ref_retry_delay(attempts, 1.0, 30.0, random.Random(attempts))
    assert _retry_delay(20, 1.0, 30.0, random.Random(0)) <= 30.0 * 1.25


def test_gate_on_raises_in_detect_stage(monkeypatch):
    """Slice 4 serves the gate: ``EVAM_GATE=on`` builds one in the detect
    stage, ``EVAM_GATE=off`` beats ``adaptive``, as in the reference."""
    registry = _port_registry()
    monkeypatch.setenv("EVAM_GATE", "on")
    stage = DetectStage("detection", KEY, {}, registry.hub)
    assert stage.gate is not None and stage.gate.cfg.enabled
    assert stage.gate.engine_name == stage.engine.name
    monkeypatch.setenv("EVAM_GATE", "off")
    stage = DetectStage("detection", KEY, {"inference-interval": "adaptive"},
                        registry.hub)
    assert stage.gate is None and stage.interval == 1
    registry.stop_all()


# --------------------------------------------- parity with the reference


def _reference_run(jreg, path: str, body: dict,
                   pipelines: str = "pipelines") -> dict:
    """The request through the reference's server (aiohttp TestClient,
    as ``tests/test_golden.py`` drives it); returns its engine rows."""
    # one batch of the stream's 4 frames: one compile of the step
    hub = JaxHub(jreg, plan=build_mesh(), max_batch=4, deadline_ms=500.0)
    registry = JaxPipelineRegistry(
        ref_settings.Settings(pipelines_dir=str(REPO / pipelines)), hub=hub)

    async def go():
        async with TestClient(TestServer(build_app(registry))) as client:
            resp = await client.post(path, json=body)
            return resp.status, await resp.json()

    try:
        status, iid = asyncio.run(go())
        assert status == 200, iid
        deadline = time.time() + 120
        while registry.get_instance(iid).status()["state"] not in (
                "COMPLETED", "ERROR", "ABORTED"):
            assert time.time() < deadline
            time.sleep(0.05)
        assert registry.get_instance(iid).status()["state"] == "COMPLETED"
        return hub.stats()
    finally:
        registry.stop_all()


def _port_run(models_dir, dtype, path: str, key: str, body: dict,
              pipelines: str = "pipelines") -> dict:
    """The same request through the port's server; returns its engine
    rows."""
    srv = PortServer(_port_registry(models_dir, dtype, pipelines))
    try:
        status, iid = srv.request("POST", path, body)
        assert status == 200, iid
        st = srv.wait(iid, timeout=120, path=path)
        assert st["state"] == "COMPLETED"
        model_weights = st["weights"]["detection"]["weights"][key]
        assert model_weights == "msgpack"
        return srv.registry.hub.stats()
    finally:
        srv.close()


def _saved_reference_registry(models: Path, dtype: str, key: str):
    jreg = JaxRegistry(models_dir=models, dtype=dtype, input_overrides=SMALL,
                       width_overrides=NARROW, allow_random_weights=True)
    jreg.get(key)
    jreg.save_weights(key)
    return jreg


_PARAMS = {"detection-properties": {"threshold": 0.0}}


def _both(tmp_path, dtype, key=KEY, uri="synthetic://96x96@30?count=4"):
    models = tmp_path / "models"
    jreg = _saved_reference_registry(models, dtype, key)
    path = "/pipelines/" + key
    _reference_run(jreg, path, _body(tmp_path / "ref.jsonl", uri,
                                     parameters=_PARAMS))
    _port_run(models, dtype, path, key, _body(tmp_path / "port.jsonl", uri,
                                              parameters=_PARAMS))
    ref, got = ([json.loads(x) for x in (tmp_path / f).read_text().splitlines()]
                for f in ("ref.jsonl", "port.jsonl"))
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g["timestamp"] == r["timestamp"]
        assert g["resolution"] == r["resolution"]
        assert set(g) == set(r)
    return ref, got


@pytest.fixture
def native_reference(monkeypatch):
    """The reference's host resize + wire encode on its native path (its
    default on a host of 4 or more cores), whose arithmetic the port's
    detect stage copies; its cv2 fallback rounds differently."""
    if not native.available():
        assert native.build(quiet=True), "native build failed"
    monkeypatch.setenv("EVAM_NATIVE", "1")


def _box(obj) -> np.ndarray:
    bb = obj["detection"]["bounding_box"]
    return np.asarray([bb["x_min"], bb["y_min"], bb["x_max"], bb["y_max"]])


def _assert_float32_agrees(ref, got) -> None:
    """Equal labels, boxes and confidences within 1e-4."""
    for g, r in zip(got, ref):
        assert [o["detection"]["label"] for o in g["objects"]] == \
            [o["detection"]["label"] for o in r["objects"]]
        for go, ro in zip(g["objects"], r["objects"]):
            np.testing.assert_allclose(_box(go), _box(ro), rtol=0, atol=1e-4)
            assert abs(go["detection"]["confidence"]
                       - ro["detection"]["confidence"]) <= 1e-4
            assert (go["roi_type"], go["detection"]["label_id"]) == (
                ro["roi_type"], ro["detection"]["label_id"])


def _assert_int8_matches(ref, got) -> None:
    """At least 95 % of the reference's objects matched by a port object
    of the same label at IoU ≥ 0.9."""
    matched = total = 0
    for g, r in zip(got, ref):
        for ro in r["objects"]:
            total += 1
            same = [go for go in g["objects"]
                    if go["detection"]["label"] == ro["detection"]["label"]]
            if not same:
                continue
            a, b = _box(ro), np.stack([_box(go) for go in same])
            lt, rb = np.maximum(a[:2], b[:, :2]), np.minimum(a[2:], b[:, 2:])
            inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
            area = lambda x: np.prod(np.clip(x[..., 2:] - x[..., :2], 0, None), -1)
            iou = inter / np.maximum(area(a) + area(b) - inter, 1e-9)
            matched += bool((iou >= 0.9).any())
    assert total > 0
    assert matched / total >= 0.95, (matched, total)


@pytest.mark.usefixtures("native_reference")
def test_float32_metadata_matches_the_reference(tmp_path):
    ref, got = _both(tmp_path, "float32")
    with_objects = [m for m in got if m["objects"]]
    assert with_objects, "threshold 0 must yield detections"
    _assert_golden("message_eva_metadata", with_objects[0])
    _assert_float32_agrees(ref, got)


@pytest.mark.usefixtures("native_reference")
def test_int8_pallas_metadata_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    ref, got = _both(tmp_path, "int8")
    _assert_int8_matches(ref, got)


#: the other SSD pipelines, each on a frame whose aspect differs from
#: its model's input
_OTHER_SSD = [("object_detection/person", "synthetic://128x80@30?count=4"),
              ("object_detection/vehicle", "synthetic://96x128@30?count=4")]


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("key,uri", _OTHER_SSD, ids=[k for k, _ in _OTHER_SSD])
def test_float32_metadata_matches_the_reference_on_each_ssd(tmp_path, key, uri):
    ref, got = _both(tmp_path, "float32", key, uri)
    assert any(m["objects"] for m in got), "threshold 0 must yield detections"
    assert {o["detection"]["label"] for m in got for o in m["objects"]} <= \
        {"person", "vehicle"}
    _assert_float32_agrees(ref, got)


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("key,uri", _OTHER_SSD, ids=[k for k, _ in _OTHER_SSD])
def test_int8_pallas_metadata_matches_the_reference_on_each_ssd(
        tmp_path, monkeypatch, key, uri):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    ref, got = _both(tmp_path, "int8", key, uri)
    _assert_int8_matches(ref, got)


@pytest.mark.usefixtures("native_reference")
def test_eii_person_detection_serves_as_the_reference(tmp_path):
    """The EII pipeline (detect → sink) in EVA mode: both servers run
    every frame through one person engine and publish nothing."""
    key = "object_detection/person"
    path = "/pipelines/object_detection/person_detection"
    models = tmp_path / "models"
    jreg = _saved_reference_registry(models, "float32", key)
    uri = "synthetic://128x80@30?count=4"
    ref = _reference_run(jreg, path, _body(tmp_path / "ref.jsonl", uri,
                                           parameters=_PARAMS),
                         pipelines="eii/pipelines")
    got = _port_run(models, "float32", path, key,
                    _body(tmp_path / "port.jsonl", uri, parameters=_PARAMS),
                    pipelines="eii/pipelines")
    assert list(got) == list(ref) == [f"detect:{key}"]
    assert got[f"detect:{key}"]["items"] == ref[f"detect:{key}"]["items"] == 4
    assert not (tmp_path / "ref.jsonl").exists()
    assert not (tmp_path / "port.jsonl").exists()


# ------------------------------------------------------------------ CLI


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _port_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("EVAM_PLATFORM", "EVAM_CONFIG_FILE")}
    env.update(extra)
    return env


def test_cli_list_prints_the_reference_json(capsys, monkeypatch):
    monkeypatch.delenv("EVAM_CONFIG_FILE", raising=False)
    ref_settings.reset_settings()
    try:
        assert ref_cli.cmd_list(None) == 0
    finally:
        ref_settings.reset_settings()
    want = json.loads(capsys.readouterr().out)
    res = subprocess.run(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "list"],
        cwd=REPO, env=_port_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == want


def test_cli_serve_answers_on_the_cpu_and_stops_on_sigterm():
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"], cwd=REPO,
        env=_port_env(EVAM_PLATFORM="cpu", REST_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/pipelines", timeout=5) as r:
                    names = {(p["name"], p["version"]) for p in json.loads(r.read())}
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
                assert time.time() < deadline
                time.sleep(0.2)
        assert ("object_detection", "person_vehicle_bike") in names
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_settle_heap_freezes_what_is_alive_and_collects_what_comes_after():
    """``settle_heap`` moves every object alive now out of the
    collector's scans: a cycle that was alive then and dropped later
    stays until ``gc.unfreeze``; a cycle made afterwards is collected."""
    import gc
    import weakref

    class Node:
        pass

    old = Node()
    old.self = old
    kept = weakref.ref(old)
    try:
        frozen = settle_heap()
        assert frozen == gc.get_freeze_count() > 0
        del old
        new = Node()
        new.self = new
        gone = weakref.ref(new)
        del new
        gc.collect()
        assert gone() is None
        assert kept() is not None
    finally:
        gc.unfreeze()
    gc.collect()
    assert kept() is None


def test_run_server_settles_the_heap_before_the_port_opens(monkeypatch):
    calls = []

    class Opened(Exception):
        pass

    def opened(app, port):
        calls.append("open")
        raise Opened

    monkeypatch.setattr(app_module, "settle_heap",
                        lambda: calls.append("settle") or 0)
    monkeypatch.setattr(app_module, "make_server", opened)
    with pytest.raises(Opened):
        app_module.run_server(Settings(device="cpu"))
    assert calls == ["settle", "open"]


def test_cli_serve_without_a_card_refuses_to_start():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: serve would start on it")
    res = subprocess.run(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"], cwd=REPO,
        env=_port_env(REST_PORT=str(_free_port())), capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr


def test_cli_eii_mode_without_a_card_refuses_to_start(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: serve would start on it")
    res = subprocess.run(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve", "--mode",
         "EII"], cwd=REPO, env=_port_env(
             EVAM_EII_CONFIG=str(tmp_path / "none.json"),
             RUN_MODE="EII"), capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr


def test_cli_serve_runs_packed_sched_tune_and_refuses_the_fleet():
    """``serve`` on the CPU with EVAM_RAGGED=packed, EVAM_SCHED=1 and
    EVAM_TUNE=1: /scheduler reports the scheduler and the controller on,
    the controller ticks, SIGTERM ends it with 0. EVAM_FLEET=sharded on
    one device refuses to shard: it degrades to off and says so in the
    log, as the reference does."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"], cwd=REPO,
        env=_port_env(EVAM_PLATFORM="cpu", REST_PORT=str(port),
                      EVAM_RAGGED="packed", EVAM_SCHED="1", EVAM_TUNE="1",
                      EVAM_TUNE_INTERVAL_S="0.1", EVAM_FLEET="sharded"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/scheduler", timeout=5) as r:
                    sched = json.loads(r.read())
                if sched["tuning"]["ticks"] >= 2:
                    break
            except OSError:
                assert proc.poll() is None, proc.stdout.read()
            assert time.time() < deadline
            time.sleep(0.2)
        assert sched["enabled"] is True and sched["tuning"]["enabled"] is True
        # an idle hub reads utilization 0: the deadline law shrinks
        # deadlines, so the action log (empty in the golden) has entries
        actions = sched["tuning"]["actions"]
        assert all(set(a) == {"tick", "knob", "from", "to", "reason"}
                   for a in actions)
        assert canonical({**sched, "tuning": {**sched["tuning"],
                                              "actions": []}}) == \
            _golden("route_scheduler")
        assert sched["fleet"]["mode"] == "off"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "EVAM_FLEET=sharded needs more than one device" in \
            proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_eii_mode_and_fetch_models_name_their_slices(tmp_path):
    """``serve --mode EII`` on the CPU runs the EII service: a pyzmq
    subscriber reads a message of the pipeline the config file names,
    and SIGTERM ends it with 0; fetch-models, ported with real model
    import, runs: it synthesizes an attributes IR the port's registry
    lists, and refuses two modes at once with exit 2."""
    import zmq

    port = _free_port()
    config = tmp_path / "eii.json"
    config.write_text(json.dumps({
        "config": {"source": "gstreamer", "pipeline": "video_decode/app_dst",
                   "source_parameters": {"type": "uri",
                                         "uri": "synthetic://48x32@30"},
                   "publish_frame": True},
        "interfaces": {"Publishers": [{
            "Name": "default", "Type": "zmq_tcp",
            "EndPoint": f"127.0.0.1:{port}", "Topics": ["cli_results"],
            "AllowedClients": ["*"]}]}}))
    sub = zmq.Context.instance().socket(zmq.SUB)
    sub.setsockopt(zmq.LINGER, 0)
    sub.setsockopt(zmq.RCVTIMEO, 100)
    sub.setsockopt(zmq.SUBSCRIBE, b"cli_results")
    sub.connect(f"tcp://127.0.0.1:{port}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve", "--mode",
         "EII"], cwd=REPO, env=_port_env(EVAM_PLATFORM="cpu",
                                         EVAM_EII_CONFIG=str(config)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while True:
            try:
                topic, meta, blob = sub.recv_multipart()
                break
            except zmq.Again:
                assert proc.poll() is None, proc.stdout.read()
                assert time.time() < deadline, "no EII message"
        meta = json.loads(meta)
        assert topic == b"cli_results"
        assert (meta["width"], meta["height"], meta["gva_meta"]) == (48, 32, [])
        assert len(blob) == 48 * 32 * 3
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        sub.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = tmp_path / "models"
    res = subprocess.run(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "fetch-models",
         "--synthesize-omz", "cls_ir", "--topology", "attributes",
         "--size", "24", "--output", str(out)], cwd=REPO,
        env=_port_env(EVAM_PLATFORM="cpu"), capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert (out / "cls_ir" / "1" / "FP32" / "model.xml").exists()
    assert "cls_ir/1" in ModelRegistry(models_dir=out, device="cpu").keys()
    res = subprocess.run(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "fetch-models",
         "--synthesize-omz", "x", "--from-ir", str(out)], cwd=REPO,
        env=_port_env(EVAM_PLATFORM="cpu"), capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 2
    assert "mutually exclusive" in res.stderr
