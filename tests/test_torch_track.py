"""Slice 4 tracking of the port against the reference, on the CPU.

* ``IouTracker`` (through ``TrackStage``, for every ``tracking-type``):
  the same ``Region`` lists, made with seeded numpy, go to the
  reference's tracker and the port's; every region gets the same
  ``object_id`` on every frame and the trackers' ``state_dict`` are
  equal after every frame — exactly, with no tolerance (float32 numpy
  in the same order on both sides). The sequences include boxes of
  equal IoU against two tracks (ties), pairs that overlap across
  classes, dropped and new objects. ``state_dict`` / ``load_state``
  round trips, and ``RegionCoaster.state_dict`` / ``load_state`` equal
  the reference's.
* ``object_tracking/person_vehicle_bike`` through both REST servers
  (the reference's registry saves both models' parameters into a
  models dir that both registries read): detect+classify fused into
  one engine, then track. Float32: the same objects frame by frame
  (labels, ids and attribute labels equal; boxes, detection and
  attribute confidences within 1e-4). INT8 with ``EVAM_QGEMM=pallas``:
  the same objects, labels, ids and attribute labels frame by frame,
  boxes within 1e-3 and confidences within 2e-2.

``serve_both`` is the REST harness of ``tests/test_torch_udf.py`` and
``tests/test_torch_gate.py`` too.
"""

from __future__ import annotations

import asyncio
import json
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from evam_tpu.config import settings as ref_settings
from evam_tpu.engine import EngineHub as JaxHub
from evam_tpu.models import ModelRegistry as JaxRegistry
from evam_tpu.ops import qlinear as jql
from evam_tpu.parallel import build_mesh
from evam_tpu.server.app import build_app
from evam_tpu.server.registry import PipelineRegistry as JaxPipelineRegistry
from evam_tpu.stages import track as jtrack
from evam_tpu.stages.context import FrameContext as JContext
from evam_tpu.stages.context import Region as JRegion
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.server.registry import PipelineRegistry
from evam_tpu_torch.stages import track as ttrack
from evam_tpu_torch.stages.context import FrameContext, Region
from test_torch_server import (  # the reference-parity harness
    REPO,
    PortServer,
    _body,
    _box,
    native_reference,  # noqa: F401 — fixture
)

torch.set_num_threads(1)
DET = "object_detection/person_vehicle_bike"
CLS = "object_classification/vehicle_attributes"
SMALL = dict(input_overrides={DET: (64, 64)}, width_overrides={DET: 8, CLS: 8})
TYPES = sorted(ttrack.TrackStage._TYPES)

# ------------------------------------------------------------- tracker


def _sequence(seed: int, frames: int = 24, objects: int = 6):
    """Per frame, a list of (box, label_id) rows: objects that drift,
    drop out for a few frames and come back, new objects, exact copies
    of another object's box (equal IoU against both tracks) and boxes
    of another class on top of an object."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.05, 0.6, (objects, 2)).astype(np.float32)
    size = rng.uniform(0.08, 0.3, (objects, 2)).astype(np.float32)
    vel = rng.uniform(-0.02, 0.02, (objects, 2)).astype(np.float32)
    labels = rng.integers(0, 3, objects)
    out = []
    for t in range(frames):
        rows = []
        for i in range(objects):
            if rng.random() < 0.15:
                continue  # missed this frame
            p = np.clip(pos[i] + vel[i] * t
                        + rng.normal(0, 0.004, 2).astype(np.float32), 0, 0.65)
            box = np.concatenate([p, p + size[i]]).astype(np.float32)
            rows.append((box, int(labels[i])))
            if rng.random() < 0.1:
                rows.append((box.copy(), int(labels[i])))  # a tie
            if rng.random() < 0.1:
                rows.append((box + np.float32(0.01), int((labels[i] + 1) % 3)))
        if rng.random() < 0.2:
            p = rng.uniform(0, 0.7, 2).astype(np.float32)
            rows.append((np.concatenate([p, p + 0.2]).astype(np.float32),
                         int(rng.integers(0, 3))))
        order = rng.permutation(len(rows))
        out.append([rows[k] for k in order])
    return out


def _regions(rows, region_cls):
    return [region_cls(x0=float(b[0]), y0=float(b[1]), x1=float(b[2]),
                       y1=float(b[3]), confidence=0.9, label_id=lid,
                       label=str(lid)) for b, lid in rows]


def _track_both(props: dict, seq) -> tuple[list, list]:
    ref = jtrack.TrackStage("t", dict(props))
    got = ttrack.TrackStage("t", dict(props))
    ref_ids, got_ids = [], []
    for t, rows in enumerate(seq):
        rr, gr = _regions(rows, JRegion), _regions(rows, Region)
        ref.process(JContext(frame=None, pts_ns=t, seq=t, stream_id="s",
                             regions=rr))
        got.process(FrameContext(frame=None, pts_ns=t, seq=t, stream_id="s",
                                 regions=gr))
        ref_ids.append([r.object_id for r in rr])
        got_ids.append([r.object_id for r in gr])
        assert got.tracker.state_dict() == ref.tracker.state_dict()
    return ref_ids, got_ids


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("ttype", TYPES)
def test_tracker_ids_equal_the_references(ttype, seed):
    ref_ids, got_ids = _track_both({"tracking-type": ttype}, _sequence(seed))
    assert got_ids == ref_ids
    # the sequence exercises the matching: ids persist across frames
    assert len({i for ids in got_ids for i in ids}) < sum(map(len, got_ids))


@pytest.mark.parametrize("props", [
    {"max-age": 2, "iou-threshold": 0.5},
    {"tracking-type": "short-term", "max-age": 3, "iou-threshold": 0.1},
    {"tracking-type": "zero-term", "max-age": 30},
], ids=["iou-age2", "short-term-age3", "zero-term-ignores-max-age"])
def test_tracker_properties_equal_the_references(props):
    ref_ids, got_ids = _track_both(props, _sequence(7, frames=30))
    assert got_ids == ref_ids


def test_equal_iou_ties_resolve_as_in_the_reference():
    """Two tracks on one box, then a detection on it and one beside it:
    argsort order decides which track keeps which id; and a box of
    another class never continues a track."""
    box = np.asarray([0.2, 0.2, 0.4, 0.4], np.float32)
    beside = box + np.float32(0.05)
    seq = [[(box, 1), (box.copy(), 1)],
           [(box.copy(), 1), (beside, 1), (box.copy(), 2)],
           [(beside, 1), (box, 1)],
           [(box, 2), (box, 2), (box, 1)]]
    for ttype in TYPES:
        ref_ids, got_ids = _track_both({"tracking-type": ttype}, seq)
        assert got_ids == ref_ids, ttype
    assert got_ids[1][2] not in got_ids[0]  # class 2 starts a new track


def test_unknown_tracking_type_raises():
    with pytest.raises(ValueError, match="unsupported tracking-type"):
        jtrack.TrackStage("t", {"tracking-type": "long-term"})
    with pytest.raises(ValueError, match="unsupported tracking-type 'long-term'"):
        ttrack.TrackStage("t", {"tracking-type": "long-term"})


@pytest.mark.parametrize("ttype", ["iou", "short-term"])
def test_tracker_state_round_trips(ttype):
    """A tracker restored from the reference's state_dict (and the port's
    own) continues with the reference's ids."""
    seq = _sequence(3, frames=20)
    ref = jtrack.TrackStage("t", {"tracking-type": ttype}).tracker
    for rows in seq[:10]:
        ref.update(_regions(rows, JRegion))
    state = json.loads(json.dumps(ref.state_dict()))
    restored = ttrack.TrackStage("t", {"tracking-type": ttype}).tracker
    restored.load_state(state)
    assert restored.state_dict() == state
    again = ttrack.TrackStage("t", {"tracking-type": ttype}).tracker
    again.load_state(restored.state_dict())
    for rows in seq[10:]:
        rr = _regions(rows, JRegion)
        ref.update(rr)
        for trk in (restored, again):
            gr = _regions(rows, Region)
            trk.update(gr)
            assert [r.object_id for r in gr] == [r.object_id for r in rr]
    # a malformed row is dropped; the id counter never moves back
    fresh = ttrack.IouTracker()
    fresh._next_id = 50
    fresh.load_state({"next_id": 3, "tracks": [{"box": [0, 0, 1, 1]}]})
    assert fresh.tracks == [] and fresh._next_id == 50


def test_region_coaster_state_equals_the_references():
    seq = _sequence(5, frames=6)
    ref, got = jtrack.RegionCoaster(), ttrack.RegionCoaster()
    for rows in seq:
        ref.observe(_regions(rows, JRegion))
        got.observe(_regions(rows, Region))
    state = ref.state_dict()
    assert got.state_dict() == state
    restored_ref, restored = jtrack.RegionCoaster(), ttrack.RegionCoaster()
    restored_ref.load_state(state)
    restored.load_state(json.loads(json.dumps(state)))
    for steps in (0, 1, 3):
        assert [r.box.tolist() for r in restored.coast(steps)] == \
            [r.box.tolist() for r in restored_ref.coast(steps)]


# ------------------------------------------------- both REST servers


def _reference_serve(jreg, path: str, body: dict,
                     **hub_kw) -> tuple[dict, dict]:
    """The request through the reference's server (aiohttp TestClient);
    returns its engine rows and the instance's final status.
    ``hub_kw``: more arguments of its EngineHub."""
    hub = JaxHub(jreg, plan=build_mesh(), max_batch=4, deadline_ms=500.0,
                 **hub_kw)
    registry = JaxPipelineRegistry(
        ref_settings.Settings(pipelines_dir=str(REPO / "pipelines")), hub=hub)

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
        st = registry.get_instance(iid).status()
        assert st["state"] == "COMPLETED"
        return hub.stats(), st
    finally:
        registry.stop_all()


def _port_serve(models, dtype: str, path: str, body: dict,
                **hub_kw) -> tuple[dict, dict]:
    """The same request through the port's server (``hub_kw`` as for
    :func:`_reference_serve`)."""
    registry = ModelRegistry(models_dir=models, dtype=dtype, device="cpu",
                             allow_random_weights=True, **SMALL)
    srv = PortServer(PipelineRegistry(
        Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu",
                 drain_timeout_s=10.0),
        hub=EngineHub(registry, device="cpu", max_batch=16,
                      deadline_ms=100.0, **hub_kw)))
    try:
        status, iid = srv.request("POST", path, body)
        assert status == 200, iid
        st = srv.wait(iid, timeout=120, path=path)
        assert st["state"] == "COMPLETED"
        weights = {v for row in st["weights"].values()
                   for v in row["weights"].values()}
        assert weights == {"msgpack"}
        return srv.registry.hub.stats(), st
    finally:
        srv.close()


def serve_both(tmp_path, dtype: str, path: str, params: dict, uri: str,
               count: int):
    """One request with the same weights through the reference's server
    and the port's. Returns (reference lines, port lines, reference
    engines, port engines, reference status, port status); the two
    servers published ``count`` lines with equal timestamps and
    resolutions, from engines of the same names and item counts."""
    models = tmp_path / "models"
    jreg = JaxRegistry(models_dir=models, dtype=dtype, allow_random_weights=True,
                       **SMALL)
    for key in (DET, CLS):
        jreg.get(key)
        jreg.save_weights(key)
    ref_engines, ref_st = _reference_serve(
        jreg, path, _body(tmp_path / "ref.jsonl", uri, parameters=params))
    got_engines, got_st = _port_serve(
        models, dtype, path, _body(tmp_path / "port.jsonl", uri,
                                   parameters=params))
    assert sorted(got_engines) == sorted(ref_engines)
    for name, row in got_engines.items():
        assert row["items"] == ref_engines[name]["items"], name
    ref, got = ([json.loads(x) for x in (tmp_path / f).read_text().splitlines()]
                for f in ("ref.jsonl", "port.jsonl"))
    assert len(got) == len(ref) == count
    for g, r in zip(got, ref):
        assert (g["timestamp"], g["resolution"]) == (r["timestamp"],
                                                     r["resolution"])
    return ref, got, ref_engines, got_engines, ref_st, got_st


#: attributes a classified object carries
ATTRS = ("color", "type")
#: tolerances on (boxes, confidences) by precision
TOL = {"float32": (1e-4, 1e-4), "int8": (1e-3, 2e-2)}


def assert_objects_equal(ref, got, dtype: str) -> None:
    """The same objects frame by frame: equal keys, labels, ids and
    attribute labels; boxes and confidences within TOL[dtype]."""
    box_tol, conf_tol = TOL[dtype]
    for n, (g, r) in enumerate(zip(got, ref)):
        assert len(g["objects"]) == len(r["objects"]), n
        for go, ro in zip(g["objects"], r["objects"]):
            assert set(go) == set(ro), n
            assert (go["detection"]["label"], go.get("id")) == (
                ro["detection"]["label"], ro.get("id")), n
            np.testing.assert_allclose(_box(go), _box(ro), rtol=0,
                                       atol=box_tol)
            assert abs(go["detection"]["confidence"]
                       - ro["detection"]["confidence"]) <= conf_tol
            for a in ATTRS:
                if a in ro:
                    assert go[a]["label"] == ro[a]["label"], (n, a)
                    assert abs(go[a]["confidence"]
                               - ro[a]["confidence"]) <= conf_tol


TRACK_PATH = "/pipelines/object_tracking/person_vehicle_bike"


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tracking_pipeline_matches_the_reference(tmp_path, monkeypatch, dtype):
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    ref, got, _, engines, _, _ = serve_both(
        tmp_path, dtype, TRACK_PATH, {"detection-threshold": 0.0},
        "synthetic://96x96@30?count=8", 8)
    assert [name.split(":")[0] for name in engines] == ["detect_classify"]
    assert_objects_equal(ref, got, dtype)
    objects = [o for m in got for o in m["objects"]]
    assert objects and all("id" in o for o in objects)
    assert any(a in o for o in objects for a in ATTRS), "nothing classified"
    # ids persist across frames
    assert len({o["id"] for o in objects}) < len(objects)
