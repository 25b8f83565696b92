"""Slice 4 UDF stages and extensions of the port against the reference,
on the CPU.

* ``ObjectZoneCount``, ``ObjectLineCrossing`` and ``event_convert``:
  the same contexts (regions made with seeded numpy) through the
  reference's extension and the port's copy give equal ``messages``
  (and equal ``metadata`` for event convert), frame by frame, exactly;
  line crossing over tracked objects that cross two lines both ways,
  with the idle-history pruning (``MAX_IDLE_FRAMES``) reached.
* ``UdfStage``: the shared pipeline files' ``evam_tpu.extensions.<x>``
  and the reference container's ``/home/pipeline-server/extensions/``
  paths resolve to the port's extensions; any other ``evam_tpu``
  module raises naming it; a user's ``.py`` path and module import as
  they are; a UDF that raises keeps the frame, one that returns False
  drops it; a module that cannot be imported fails the POST (500) and
  serves no frame.
* In a subprocess where ``evam_tpu``, jax, flax and the packages the
  card's machine lacks are blocked, the stage chain of every pipeline
  the port serves builds (the UDF pipelines' files name
  ``evam_tpu.extensions.*``), every other pipeline raises naming its
  slice, and the reference container's extension path resolves.
* ``object_detection/object_zone_count`` (a whole-frame zone) and
  ``object_tracking/object_line_crossing`` (two lines) through both
  REST servers (``tests/test_torch_track.py`` ``serve_both``), float32
  and INT8/pallas: the same objects (ids included) and equal ``events``
  frame by frame.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from evam_tpu.extensions import event_convert as jevent
from evam_tpu.extensions import object_line_crossing as jline
from evam_tpu.extensions import object_zone_count as jzone
from evam_tpu.ops import qlinear as jql
from evam_tpu.stages.context import FrameContext as JContext
from evam_tpu.stages.context import Region as JRegion
from evam_tpu_torch.extensions import event_convert as tevent
from evam_tpu_torch.extensions import object_line_crossing as tline
from evam_tpu_torch.extensions import object_zone_count as tzone
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.stages.context import FrameContext, Region
from evam_tpu_torch.stages.udf import UdfStage, resolve_module
from test_torch_server import (  # the reference-parity harness
    REPO,
    _body,
    _port_registry,
    PortServer,
    native_reference,  # noqa: F401 — fixture
)
from test_torch_imports import ABSENT, BLOCKED
from test_torch_server import _SERVED
from test_torch_track import assert_objects_equal, serve_both

torch.set_num_threads(1)

ZONES = [{"name": "whole", "polygon": [[0, 0], [1, 0], [1, 1], [0, 1]]},
         {"name": "left", "polygon": [[0, 0], [0.5, 0], [0.5, 1], [0, 1]]},
         {"name": "wedge", "polygon": [[0.2, 0.1], [0.9, 0.3], [0.4, 0.95]]}]
LINES = [{"name": "vertical", "line": [[0.5, 0.0], [0.5, 1.0]]},
         {"name": "diagonal", "line": [[0.0, 0.2], [1.0, 0.8]]}]
#: the REST runs' lines: across the rows of the small random SSD's
#: boxes, whose bottom edges move between frames by 0.01-0.05
REST_LINES = [{"name": "upper", "line": [[0.0, 0.125], [1.0, 0.125]]},
              {"name": "lower", "line": [[0.0, 0.25], [1.0, 0.25]]}]


def _tracks(seed: int, frames: int, objects: int = 8):
    """Per frame, rows (box, label, object id): objects that move across
    the frame both ways, some of them leaving for good."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0.0, 0.8, (objects, 2))
    vel = rng.uniform(-0.06, 0.06, (objects, 2))
    size = rng.uniform(0.05, 0.2, (objects, 2))
    last = rng.integers(frames // 3, frames + 1, objects)
    out = []
    for t in range(frames):
        rows = []
        for i in range(objects):
            if t >= last[i] or rng.random() < 0.1:
                continue
            p = np.mod(start[i] + vel[i] * t, 0.8)
            rows.append(((*p, *(p + size[i])), int(i % 3), i + 1))
        out.append(rows)
    return out


def _contexts(rows, seq: int):
    ctxs = []
    for ctx_cls, region_cls in ((JContext, JRegion), (FrameContext, Region)):
        regions = [region_cls(x0=float(b[0]), y0=float(b[1]), x1=float(b[2]),
                              y1=float(b[3]), confidence=0.8, label_id=lid,
                              label=["person", "vehicle", "bike"][lid],
                              object_id=oid) for b, lid, oid in rows]
        ctxs.append(ctx_cls(frame=None, pts_ns=seq, seq=seq, stream_id="s",
                            regions=regions))
    return ctxs


@pytest.mark.parametrize("seed", range(3))
def test_zone_count_equals_the_references(seed):
    ref, got = jzone.ObjectZoneCount(zones=ZONES), tzone.ObjectZoneCount(zones=ZONES)
    events = 0
    for t, rows in enumerate(_tracks(seed, 20)):
        rc, gc = _contexts(rows, t)
        assert got.process_frame(gc) is ref.process_frame(rc) is True
        assert gc.messages == rc.messages
        events += len(gc.messages)
    assert events


@pytest.mark.parametrize("seed", range(3))
def test_line_crossing_equals_the_references(seed, monkeypatch):
    # prune idle ids after 5 frames, so the test reaches the pruning
    monkeypatch.setattr(jline.ObjectLineCrossing, "MAX_IDLE_FRAMES", 5)
    monkeypatch.setattr(tline.ObjectLineCrossing, "MAX_IDLE_FRAMES", 5)
    ref = jline.ObjectLineCrossing(lines=LINES)
    got = tline.ObjectLineCrossing(lines=LINES)
    crossings = 0
    for t, rows in enumerate(_tracks(seed, 40)):
        rc, gc = _contexts(rows, t)
        assert got.process_frame(gc) is ref.process_frame(rc) is True
        assert gc.messages == rc.messages
        assert sorted(got._history) == sorted(ref._history)
        crossings += sum(len(m["events"]) for m in gc.messages)
    assert crossings
    assert len(got._history) < 8  # objects that left were pruned


def test_event_convert_equals_the_references():
    meta = {"objects": [], "events": [
        {"event-type": "zone-count", "zone-name": "a"},
        {"line-name": "l"}, {}]}
    rc, gc = _contexts([], 0)
    rc.metadata, gc.metadata = copy.deepcopy(meta), copy.deepcopy(meta)
    assert tevent.process_frame(gc) is jevent.process_frame(rc) is True
    assert gc.metadata == rc.metadata
    assert [e["event-type"] for e in gc.metadata["events"]] == \
        ["zone-count", "unknown", "unknown"]
    for metadata in (None, {"objects": []}):
        rc, gc = _contexts([], 1)
        rc.metadata, gc.metadata = copy.deepcopy(metadata), copy.deepcopy(metadata)
        assert tevent.process_frame(gc) is jevent.process_frame(rc) is True
        assert gc.metadata == rc.metadata


# ---------------------------------------------------------- UdfStage


@pytest.mark.parametrize("name,want", [
    ("evam_tpu.extensions.object_zone_count", tzone),
    ("evam_tpu.extensions.object_line_crossing", tline),
    ("evam_tpu.extensions.event_convert", tevent),
    ("/home/pipeline-server/extensions/object_zone_count.py", tzone),
    ("/home/pipeline-server/extensions/spatial_analytics/object_line_crossing.py",
     tline),
    ("/home/pipeline-server/extensions/gva_event_convert.py", tevent),
    ("evam_tpu_torch.extensions.object_zone_count", tzone),
])
def test_module_names_resolve_to_the_ports_extensions(name, want):
    assert resolve_module(name) is want


@pytest.mark.parametrize("name,needle", [
    ("evam_tpu.ops.nms", "reference package"),
    ("evam_tpu", "reference package"),
    ("evam_tpu.extensions", "reference package"),
    ("evam_tpu.extensions.no_such_udf", "evam_tpu_torch.extensions.no_such_udf"),
    ("/home/pipeline-server/extensions/no_such_udf.py",
     "evam_tpu_torch.extensions.no_such_udf"),
])
def test_other_reference_modules_raise_naming_them(name, needle):
    with pytest.raises(ImportError, match=needle) as info:
        resolve_module(name)
    assert name in str(info.value)


def test_user_udfs_load_and_keep_or_drop_frames(tmp_path):
    path = tmp_path / "my_udf.py"
    path.write_text(
        "class Keep:\n"
        "    def __init__(self, tag='x'):\n"
        "        self.tag = tag\n"
        "    def process_frame(self, ctx):\n"
        "        ctx.messages.append({'tag': self.tag})\n"
        "        return ctx.seq % 2 == 0\n"
        "def process_frame(ctx):\n"
        "    raise RuntimeError('broken udf')\n")
    stage = UdfStage("u", {"module": str(path), "class": "Keep",
                           "kwarg": {"tag": "y"}})
    even, odd = (FrameContext(frame=None, pts_ns=i, seq=i, stream_id="s")
                 for i in (0, 1))
    assert stage.process(even) == [even] and even.messages == [{"tag": "y"}]
    assert stage.process(odd) == []  # False drops the frame
    # a UDF that raises keeps the frame (the reference's contract)
    broken = UdfStage("b", {"module": str(path)})
    assert broken.process(even) == [even]
    # a module name imports as it is
    assert UdfStage("e", {"module": "evam_tpu_torch.extensions.event_convert"}
                    )._fn is tevent.process_frame
    with pytest.raises(ValueError, match="needs a 'module'"):
        UdfStage("n", {})


def test_a_udf_that_cannot_import_fails_the_post(tmp_path):
    """The POST answers with the error and starts no stream; the
    destination file is not left behind."""
    srv = PortServer(_port_registry())
    try:
        params = {"object-zone-count-config": {"zones": ZONES}}
        bad = dict(_body(tmp_path / "o.jsonl", parameters=params))
        status, data = srv.request(
            "POST", "/pipelines/object_detection/object_zone_count", bad)
        assert status == 200  # the shipped pipeline serves
        srv.wait(data, path="/pipelines/object_detection/object_zone_count")
        spec = srv.registry.loader.get("object_detection", "object_zone_count")
        udf = next(s for s in spec.stages if s.kind.value == "udf")
        udf.properties["module"] = "evam_tpu.stages.gate"
        status, data = srv.request(
            "POST", "/pipelines/object_detection/object_zone_count",
            _body(tmp_path / "bad.jsonl", parameters=params))
        assert status == 500, data
        assert "evam_tpu.stages.gate" in data["error"]
        assert len(srv.registry.instances) == 1
    finally:
        srv.close()


def test_every_served_pipeline_builds_with_the_reference_blocked():
    # one torch thread, as every test process of the suite runs (its
    # xdist workers share the cores): left at the core count, the
    # child's model builds oversubscribe them and slow down manyfold
    code = "\n".join([
        "import json, sys",
        *[f"sys.modules[{b!r}] = None" for b in BLOCKED + ABSENT],
        "import torch",
        "torch.set_num_threads(1)",
        "from evam_tpu_torch.engine.hub import EngineHub",
        "from evam_tpu_torch.graph import PipelineLoader, resolve_parameters",
        "from evam_tpu_torch.models.registry import ModelRegistry",
        "from evam_tpu_torch.stages.build import build_stages",
        "from evam_tpu_torch.stages.udf import resolve_module",
        "keys = ('object_detection/person', 'object_detection/vehicle',",
        "        'object_detection/person_vehicle_bike')",
        "hub = EngineHub(ModelRegistry(device='cpu', allow_random_weights=True,",
        "    input_overrides={k: (64, 64) for k in keys},",
        "    width_overrides={k: 8 for k in keys + (",
        "        'object_classification/vehicle_attributes',)}), device='cpu')",
        "built, later = {}, {}",
        f"for d in {sorted(_SERVED)!r}:",
        "    loader = PipelineLoader(d)",
        "    for name, version in loader.names():",
        "        specs, _ = resolve_parameters(loader.get(name, version), {})",
        "        try:",
        "            stages = build_stages(specs, hub)",
        "        except NotImplementedError as exc:",
        "            later[f'{d}:{name}/{version}'] = str(exc)",
        "            continue",
        "        built[f'{d}:{name}/{version}'] = [type(s).__name__ for s in stages]",
        "hub.stop()",
        "ext = resolve_module('/home/pipeline-server/extensions/object_zone_count.py')",
        "assert ext.__name__ == 'evam_tpu_torch.extensions.object_zone_count'",
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED + ABSENT!r} and sys.modules[m] is not None)",
        "assert not bad, bad",
        "print(json.dumps({'built': built, 'later': later}))",
    ])
    # the child's environment is the suite's, less what would change what
    # it builds: the knobs an earlier test of this worker may have left
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("EVAM_") or k == "EVAM_ALLOW_RANDOM_WEIGHTS"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    # whatever fails below, the child's own account goes with it
    child = (f"exit {res.returncode}\nstderr:\n{res.stderr[-3000:]}\n"
             f"stdout:\n{res.stdout[-1000:]}")
    assert res.returncode == 0, child
    out = json.loads(res.stdout.strip().splitlines()[-1])
    want = {f"{d}:{n}/{v}" for d, pipes in _SERVED.items() for n, v in pipes}
    assert set(out["built"]) == want, child
    assert all("port slice" in msg for msg in out["later"].values()), child
    pipes = "pipelines:object_"
    assert out["built"][pipes + "tracking/person_vehicle_bike"] == [
        "FusedDetectClassifyStage", "TrackStage", "MetaconvertStage",
        "PublishStage", "SinkStage"]
    assert out["built"][pipes + "tracking/object_line_crossing"] == [
        "DetectStage", "TrackStage", "UdfStage", "MetaconvertStage",
        "UdfStage", "PublishStage", "SinkStage"]
    assert out["built"][pipes + "detection/object_zone_count"] == [
        "DetectStage", "UdfStage", "MetaconvertStage", "UdfStage",
        "PublishStage", "SinkStage"]


# ------------------------------------------------- both REST servers

ZONE_PATH = "/pipelines/object_detection/object_zone_count"
LINE_PATH = "/pipelines/object_tracking/object_line_crossing"


def _events(lines) -> list:
    return [m.get("events") for m in lines]


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_zone_count_pipeline_matches_the_reference(tmp_path, monkeypatch, dtype):
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    params = {"threshold": 0.0,
              "object-zone-count-config": {"zones": ZONES[:1]}}
    ref, got, *_ = serve_both(tmp_path, dtype, ZONE_PATH, params,
                              "synthetic://96x96@30?count=6", 6)
    assert_objects_equal(ref, got, dtype)
    assert _events(got) == _events(ref)
    for m in got:  # the whole-frame zone holds every object
        (event,) = m["events"]
        assert event["event-type"] == "zone-count"
        assert event["zone-count"] == len(m["objects"]) > 0


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_line_crossing_pipeline_matches_the_reference(tmp_path, monkeypatch,
                                                      dtype):
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    params = {"threshold": 0.0,
              "object-line-crossing-config": {"lines": REST_LINES}}
    ref, got, *_ = serve_both(tmp_path, dtype, LINE_PATH, params,
                              "synthetic://96x96@30?count=8", 8)
    assert_objects_equal(ref, got, dtype)
    assert _events(got) == _events(ref)
    assert all("id" in o for m in got for o in m["objects"])
    crossed = {e["line-name"] for m in got for e in m.get("events", [])}
    assert crossed and crossed <= {"upper", "lower"}
