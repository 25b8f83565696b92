"""``object_classification/vehicle_attributes`` through both REST servers.

The same request, with the same weights (the reference's registry
saves both models' parameters into a models dir that both registries
read), goes through the reference's server and the port's; the
published JSON lines and the engines that served them agree:

* **fused** (the default): one ``detect_classify`` engine;
* **unfused** (``reclassify-interval`` 3): a detect and a classify
  engine;
* **intervals** (``inference-interval`` 3, ``reclassify-interval`` 2):
  a frame skipped by the detect stage gets copies of the last regions,
  so the attributes the classify stage appends on every other frame
  land on that frame's objects only — each frame's objects and
  attributes equal the reference's frame by frame.

Tolerances: float32 — equal labels, attribute labels and object
counts; boxes, detection and attribute confidences within 1e-4.
INT8 with ``EVAM_QGEMM=pallas`` — at least 95 % of the reference's
objects matched by a port object of the same label at IoU ≥ 0.9 (the
detector's tolerance, ``tests/test_torch_server.py``), matched objects
carry the same attributes, and at least 90 % of those attributes have
the same label with a confidence within 2e-2 (a crop from a box that
moved by a bf16 rounding can take a neighbouring pixel, and random
heads give near-tied probabilities).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from evam_tpu.models import ModelRegistry as JaxRegistry
from evam_tpu.ops import qlinear as jql
from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.server.registry import PipelineRegistry
from test_torch_server import (  # the reference-parity harness
    REPO,
    PortServer,
    _body,
    _box,
    _reference_run,
    native_reference,  # noqa: F401 — fixture
)

torch.set_num_threads(1)
DET = "object_detection/person_vehicle_bike"
CLS = "object_classification/vehicle_attributes"
PATH = "/pipelines/" + CLS
SMALL = dict(input_overrides={DET: (64, 64)}, width_overrides={DET: 8, CLS: 8})
ATTRS = ("color", "type")
URI = "synthetic://96x96@30?count=6"

#: the three ways the pipeline is served, by request parameters; every
#: run detects at threshold 0 and classifies vehicles (the default
#: object-class)
_RUNS = {
    "fused": {},
    "unfused": {"reclassify-interval": 3},
    "intervals": {"inference-interval": 3, "reclassify-interval": 2},
}


def _port_run(models, dtype: str, body: dict) -> dict:
    """The request through the port's server. Its engines wait 100 ms
    for a batch (the reference's run waits 500 ms): frames skipped by
    the detect stage then take their copies of the last regions before
    the classify stage's result for the inferred frame lands, in both
    servers, whatever the host's load."""
    registry = ModelRegistry(models_dir=models, dtype=dtype, device="cpu",
                             allow_random_weights=True, **SMALL)
    srv = PortServer(PipelineRegistry(
        Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu",
                 drain_timeout_s=10.0),
        hub=EngineHub(registry, device="cpu", max_batch=16,
                      deadline_ms=100.0)))
    try:
        status, iid = srv.request("POST", PATH, body)
        assert status == 200, iid
        st = srv.wait(iid, timeout=120, path=PATH)
        assert st["state"] == "COMPLETED"
        weights = {k: v for row in st["weights"].values()
                   for k, v in row["weights"].items()}
        assert weights == {DET: "msgpack", CLS: "msgpack"}
        return srv.registry.hub.stats()
    finally:
        srv.close()


def _both(tmp_path, dtype: str, run: str):
    models = tmp_path / "models"
    jreg = JaxRegistry(models_dir=models, dtype=dtype, allow_random_weights=True,
                       **SMALL)
    for key in (DET, CLS):
        jreg.get(key)
        jreg.save_weights(key)
    params = {"detection-properties": {"threshold": 0.0}, **_RUNS[run]}
    ref_engines = _reference_run(
        jreg, PATH, _body(tmp_path / "ref.jsonl", URI, parameters=params))
    got_engines = _port_run(
        models, dtype, _body(tmp_path / "port.jsonl", URI, parameters=params))
    assert sorted(got_engines) == sorted(ref_engines)
    for name, row in got_engines.items():
        assert row["items"] == ref_engines[name]["items"], name
    ref, got = ([json.loads(x) for x in (tmp_path / f).read_text().splitlines()]
                for f in ("ref.jsonl", "port.jsonl"))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert (g["timestamp"], g["resolution"]) == (r["timestamp"],
                                                     r["resolution"])
    assert any(a in o for m in ref for o in m["objects"] for a in ATTRS), \
        "no object was classified"
    return ref, got, got_engines


def _attrs(obj) -> dict:
    return {a: obj[a] for a in ATTRS if a in obj}


def _assert_float32_agrees(ref, got) -> None:
    for g, r in zip(got, ref):
        assert len(g["objects"]) == len(r["objects"])
        for go, ro in zip(g["objects"], r["objects"]):
            assert set(go) == set(ro)
            assert go["detection"]["label"] == ro["detection"]["label"]
            np.testing.assert_allclose(_box(go), _box(ro), rtol=0, atol=1e-4)
            assert abs(go["detection"]["confidence"]
                       - ro["detection"]["confidence"]) <= 1e-4
            for a, ra in _attrs(ro).items():
                assert go[a]["label"] == ra["label"]
                assert go[a]["label_id"] == ra["label_id"]
                assert abs(go[a]["confidence"] - ra["confidence"]) <= 1e-4


def _iou(a, b) -> np.ndarray:
    lt, rb = np.maximum(a[:2], b[:, :2]), np.minimum(a[2:], b[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    area = lambda x: np.prod(np.clip(x[..., 2:] - x[..., :2], 0, None), -1)
    return inter / np.maximum(area(a) + area(b) - inter, 1e-9)


def _assert_int8_matches(ref, got) -> None:
    matched = total = same_attr = attrs = 0
    for g, r in zip(got, ref):
        for ro in r["objects"]:
            total += 1
            same = [go for go in g["objects"]
                    if go["detection"]["label"] == ro["detection"]["label"]]
            if not same:
                continue
            iou = _iou(_box(ro), np.stack([_box(go) for go in same]))
            if iou.max() < 0.9:
                continue
            matched += 1
            go = same[int(iou.argmax())]
            assert set(_attrs(go)) == set(_attrs(ro))
            for a, ra in _attrs(ro).items():
                attrs += 1
                same_attr += (go[a]["label"] == ra["label"] and abs(
                    go[a]["confidence"] - ra["confidence"]) <= 2e-2)
    assert total > 0 and attrs > 0
    assert matched / total >= 0.95, (matched, total)
    assert same_attr / attrs >= 0.9, (same_attr, attrs)


def _assert_served(run: str, engines: dict) -> None:
    kinds = sorted(name.split(":")[0] for name in engines)
    assert kinds == (["detect_classify"] if run == "fused"
                     else ["classify", "detect"])


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("run", sorted(_RUNS))
def test_float32_vehicle_attributes_match_the_reference(tmp_path, run):
    ref, got, engines = _both(tmp_path, "float32", run)
    _assert_served(run, engines)
    _assert_float32_agrees(ref, got)
    if run == "intervals":
        # frames 0 and 3 run the detector; the classify stage runs on
        # frames 0, 2 and 4: frame 1 (a copy of frame 0's regions)
        # carries no attributes, frame 2 (another copy) its own
        classified = [any(a in o for o in m["objects"] for a in ATTRS)
                      for m in got]
        assert classified == [True, False, True, False, True, False]


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("run", sorted(_RUNS))
def test_int8_pallas_vehicle_attributes_match_the_reference(
        tmp_path, monkeypatch, run):
    monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
    monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    ref, got, engines = _both(tmp_path, "int8", run)
    _assert_served(run, engines)
    _assert_int8_matches(ref, got)
