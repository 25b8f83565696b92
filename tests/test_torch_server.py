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
* DELETE reaches ABORTED; a pipeline of a later slice answers 501;
  ``EVAM_GATE=on`` raises in ``DetectStage``; ``python -m
  evam_tpu_torch.cli.main list`` prints the reference's JSON, and
  ``serve`` answers on the CPU with ``EVAM_PLATFORM=cpu`` (and refuses
  to start without a card otherwise).
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
from evam_tpu_torch.graph import PipelineLoader
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops import qgemm as tqg
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.server.app import App, make_server
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
                   pipelines="pipelines") -> PipelineRegistry:
    registry = ModelRegistry(models_dir=models_dir, dtype=dtype, device="cpu",
                             input_overrides=SMALL, width_overrides=NARROW,
                             allow_random_weights=True)
    hub = EngineHub(registry, device="cpu", max_batch=16, deadline_ms=4.0)
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
    assert health["host_stages_ms"]["seal"] == 0.0
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


@pytest.mark.parametrize("path,body_extra,needle", [
    ("/pipelines/object_classification/vehicle_attributes",
     {"parameters": {"inference-interval": "adaptive"}}, "slice 4"),
    ("/pipelines/object_tracking/person_vehicle_bike", {}, "slice 4"),
    ("/pipelines/object_detection/object_zone_count", {}, "slice 4"),
    ("/pipelines/action_recognition/general", {}, "slice 4"),
    (PIPE, {"parameters": {"inference-interval": "adaptive"}}, "slice 4"),
    (PIPE, {"source": {"type": "webcam", "device": 0}}, "slice 11"),
    (PIPE, {"destination": {"metadata": {"type": "zmq"}}}, "slice 11"),
    (PIPE, {"destination": {"metadata": {"type": "null"},
                            "frame": {"type": "rtsp"}}}, "slice 11"),
    ("/scheduler", None, "slice 7"),
    ("/traces", None, "slice 10"),
])
def test_later_slices_answer_501(server, tmp_path, path, body_extra, needle):
    if body_extra is None:
        status, data = server.request("GET", path)
    else:
        status, data = server.request(
            "POST", path, {**_body(tmp_path / "o.jsonl"), **body_extra})
    assert status == 501, data
    assert needle in data["error"]
    assert not (tmp_path / "o.jsonl").exists()
    assert server.registry.hub.stats() == {}


#: pipelines the port serves in this slice; every other one of
#: pipelines/ and eii/pipelines/ answers 501
_SERVED = {"pipelines": {("object_classification", "vehicle_attributes"),
                         ("object_detection", "app_src_dst"),
                         ("object_detection", "person"),
                         ("object_detection", "person_vehicle_bike"),
                         ("object_detection", "vehicle"),
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
    keys = ("object_detection/person", "object_detection/vehicle", KEY)
    registry = ModelRegistry(
        dtype="float32", device="cpu", allow_random_weights=True,
        input_overrides={k: (64, 64) for k in keys},
        width_overrides={k: 8 for k in keys + (
            "object_classification/vehicle_attributes",)})
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
    registry = _port_registry()
    monkeypatch.setenv("EVAM_GATE", "on")
    with pytest.raises(NotImplementedError, match="slice 4"):
        DetectStage("detection", KEY, {}, registry.hub)
    monkeypatch.setenv("EVAM_GATE", "off")  # beats adaptive, as in the reference
    stage = DetectStage("detection", KEY, {"inference-interval": "adaptive"},
                        registry.hub)
    assert stage.interval == 1
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


def test_cli_serve_without_a_card_refuses_to_start():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: serve would start on it")
    res = subprocess.run(
        [sys.executable, "-m", "evam_tpu_torch.cli.main", "serve"], cwd=REPO,
        env=_port_env(REST_PORT=str(_free_port())), capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr


def test_cli_eii_mode_and_fetch_models_name_their_slices():
    for args, needle in ((["serve", "--mode", "EII"], "slice 8"),
                         (["fetch-models"], "slice 6")):
        res = subprocess.run(
            [sys.executable, "-m", "evam_tpu_torch.cli.main", *args], cwd=REPO,
            env=_port_env(EVAM_PLATFORM="cpu"), capture_output=True,
            text=True, timeout=120)
        assert res.returncode != 0
        assert needle in res.stderr
