"""The port's stream checkpoints (``evam_tpu_torch/state/``) and stream
state against the reference's (``evam_tpu/state/``), on the CPU.

* The schema: the same version and pinned field tuple, the dataclass's
  fields equal to it.
* ``encode`` of equal checkpoints gives equal dicts and CRCs; each
  package decodes the other's blob to the same checkpoint.
* The degradation ladder ends on the same rung in both stores for a
  fresh checkpoint (full restore), a tampered payload (crc), version
  skew (version), a stale checkpoint (stale_refresh), a slow restore
  (EVAM_FAULT_INJECT ``restore_ms`` past the budget: timeout), an
  injected ``ckpt_corrupt`` (crc) and an injected ``double_fault``
  (capture lost, the migration counted).
* Stage state across packages: ``object_tracking/person_vehicle_bike``
  (detect+classify fused, the adaptive motion gate, the IoU tracker)
  runs in both packages with the same weights and EVAM_CKPT on; after
  8 frames the reference chain's snapshot is restored into a fresh port
  chain and the port chain's into a fresh reference chain; on the next
  frames each restored chain publishes what the other package's
  continuing chain publishes: the same ids, labels and gate decisions,
  boxes and confidences within 1e-4.
* Resume: a ``streams.json`` the reference's registry wrote at its
  drain (a running tracking stream, EVAM_CKPT on) is resumed by the
  port's registry: the stream restarts from the ``drain`` checkpoint,
  its live tracks keep their ids, and every new id is above every id
  the reference issued. The port's own drain and resume do the same,
  and a DELETE leaves nothing to resume.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu import state as ref_state
from evam_tpu.config import settings as ref_settings
from evam_tpu.engine import EngineHub as JaxHub
from evam_tpu.graph import PipelineLoader as JaxLoader
from evam_tpu.graph import resolve_parameters as jax_resolve
from evam_tpu.media.source import SyntheticSource as JaxSource
from evam_tpu.models import ModelRegistry as JaxRegistry
from evam_tpu.obs import faults as ref_faults
from evam_tpu.parallel import build_mesh
from evam_tpu.server.registry import PipelineRegistry as JaxPipelineRegistry
from evam_tpu.stages.build import build_stages as jax_build_stages
from evam_tpu.stages.runner import StreamRunner as JaxRunner
from evam_tpu_torch import state as port_state
from evam_tpu_torch.config import settings as port_settings
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
from evam_tpu_torch.media.source import SyntheticSource
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.obs import faults as port_faults
from evam_tpu_torch.server.registry import PipelineRegistry
from evam_tpu_torch.stages.build import build_stages
from evam_tpu_torch.stages.runner import StreamRunner
from test_torch_server import native_reference  # noqa: F401 — fixture

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
DET = "object_detection/person_vehicle_bike"
CLS = "object_classification/vehicle_attributes"
SMALL = dict(input_overrides={DET: (64, 64)}, width_overrides={DET: 8, CLS: 8})
TRACK = ("object_tracking", "person_vehicle_bike")
PARAMS = {"detection-threshold": 0.2, "inference-interval": "adaptive"}


def _reset_all() -> None:
    for mod in (ref_state, port_state, ref_faults, port_faults):
        mod.reset_cache()
    ref_settings.reset_settings()
    port_settings.reset_settings()


@pytest.fixture
def ckpt_on(monkeypatch):
    monkeypatch.setenv("EVAM_CKPT", "1")
    _reset_all()
    yield
    monkeypatch.delenv("EVAM_CKPT")
    monkeypatch.delenv("EVAM_FAULT_INJECT", raising=False)
    _reset_all()


def _checkpoint(mod, **kw):
    base = dict(stream_id="s-1", sched_class="realtime",
                trace_marker="abc-12", frame_seq=48,
                captured_at=1.7e9 + 0.25, barrier="drain", max_skip=8,
                skips_at_capture=2, fps=29.97,
                stages={"tracking": {"next_id": 17, "tracker": {
                    "next_id": 17, "tracks": [{"track_id": 3,
                                               "box": [0.1, 0.2, 0.3, 0.4],
                                               "label_id": 1, "age": 0,
                                               "hits": 4,
                                               "vel": [0.0, 0.5, -1e-3, 2.0]}]}},
                        "detection": {"count": 48, "coaster": {
                            "regions": [], "vels": []}}})
    base.update(kw)
    return mod.StreamCheckpoint(**base)


def test_schema_equals_the_references():
    assert port_state.SCHEMA_VERSION == ref_state.SCHEMA_VERSION
    assert port_state.SCHEMA_V1_FIELDS == ref_state.checkpoint.SCHEMA_V1_FIELDS
    assert tuple(f.name for f in dataclasses.fields(
        port_state.StreamCheckpoint)) == port_state.SCHEMA_V1_FIELDS


@pytest.mark.parametrize("kw", [
    {}, {"stages": {}}, {"max_skip": 0, "fps": 0.0, "trace_marker": ""},
    {"stages": {"x": {"f": 1 / 3, "n": None, "s": "é", "l": [1, 2.5]}}},
], ids=["full", "no-stages", "no-gate", "odd-values"])
def test_encode_equals_the_references(kw):
    want = ref_state.encode(_checkpoint(ref_state, **kw))
    got = port_state.encode(_checkpoint(port_state, **kw))
    assert got == want
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("direction", ["reference-to-port", "port-to-reference"])
def test_each_package_decodes_the_others_blob(direction):
    src, dst = ((ref_state, port_state) if direction == "reference-to-port"
                else (port_state, ref_state))
    blob = json.loads(json.dumps(src.encode(_checkpoint(src))))
    assert dst.is_checkpoint_blob(blob)
    got = dst.decode(blob)
    assert dataclasses.asdict(got) == dataclasses.asdict(_checkpoint(src))


class _Instance:
    """The two sides of the checkpoint contract, recorded."""

    def __init__(self, payload=None):
        self.payload = payload or {
            "sched_class": "standard", "trace_marker": "t-1",
            "frame_seq": 8, "max_skip": 4, "skips_at_capture": 1,
            "fps": 30.0, "stages": {"tracking": {"next_id": 9}}}
        self.restored = None

    def checkpoint_payload(self):
        return self.payload

    def restore_checkpoint(self, ck, stale=False):
        self.restored = (ck.stream_id, ck.barrier, stale,
                         ck.stages.get("tracking"))


def _ladder(mod, rung: str, monkeypatch):
    """Capture and restore one stream on ``rung``; returns the restore's
    answer, what the instance got and the store's counters."""
    spec = {"timeout": "restore_ms=60", "ckpt_corrupt": "ckpt_corrupt=1",
            "double_fault": "double_fault=1"}.get(rung, "")
    monkeypatch.setenv("EVAM_FAULT_INJECT", spec)
    monkeypatch.setenv("EVAM_FAULT_SEED", "5")
    mod.reset_cache()
    (ref_faults if mod is ref_state else port_faults).reset_cache()
    store = mod.CheckpointStore(interval=4, restore_timeout_s=0.02)
    src = _Instance()
    store.register("s-1", src)
    blob = store.capture("s-1", barrier="pre_rebuild",
                         reason="rebuild" if rung == "double_fault" else None)
    if rung == "double_fault":
        assert blob is None
        return None, None, store.summary()
    if rung == "tampered":
        blob = json.loads(json.dumps(blob))
        blob["payload"]["frame_seq"] += 1
    elif rung == "version":
        blob = dict(blob, v=blob["v"] + 1)
    elif rung == "stale":
        ck = mod.decode(blob)
        blob = mod.encode(dataclasses.replace(ck, captured_at=ck.captured_at
                                              - 60.0))
    dst = _Instance()
    ok = store.restore_into(blob, dst)
    summary = store.summary()
    summary.pop("last_restore_ms")
    return ok, dst.restored, summary


@pytest.mark.parametrize("rung", ["fresh", "tampered", "version", "stale",
                                  "timeout", "ckpt_corrupt", "double_fault"])
def test_degradation_ladder_ends_on_the_references_rung(rung, monkeypatch):
    want = _ladder(ref_state, rung, monkeypatch)
    got = _ladder(port_state, rung, monkeypatch)
    assert got == want
    ok, restored, summary = got
    expect_ok = rung in ("fresh", "stale")
    assert bool(ok) == expect_ok
    if rung == "stale":
        assert restored[2] is True
        assert summary["migrations"] == {"stale_refresh": 1}
    elif rung == "double_fault":
        assert summary["restore_failures"] == {"double_fault": 1}
        assert summary["migrations"] == {"rebuild": 1}
    elif not expect_ok:
        reason = {"tampered": "crc", "ckpt_corrupt": "crc",
                  "version": "version", "timeout": "timeout"}[rung]
        assert summary["restore_failures"] == {reason: 1}
    ref_faults.reset_cache()
    port_faults.reset_cache()


# --------------------------------------------- stage state, both packages


def _models(tmp_path) -> Path:
    models = tmp_path / "models"
    jreg = JaxRegistry(models_dir=models, dtype="float32",
                       allow_random_weights=True, **SMALL)
    for key in (DET, CLS):
        jreg.get(key)
        jreg.save_weights(key)
    return models


def _ref_chain(hub, published):
    spec = JaxLoader(REPO / "pipelines").get(*TRACK)
    stage_specs, _ = jax_resolve(spec, PARAMS)
    return jax_build_stages(stage_specs, hub, source_uri="s",
                            publish_fn=lambda ctx: published.append(
                                json.loads(json.dumps(ctx.metadata))))


def _port_chain(hub, published):
    spec = PipelineLoader(REPO / "pipelines").get(*TRACK)
    stage_specs, _ = resolve_parameters(spec, PARAMS)
    return build_stages(stage_specs, hub, source_uri="s",
                        publish_fn=lambda ctx: published.append(
                            json.loads(json.dumps(ctx.metadata))))


def _feed(runner_cls, stages, events) -> None:
    runner = runner_cls("s", stages, "s")
    for ev in events:
        runner.feed(ev)
    runner.drain()


def _snapshot(stages) -> dict:
    return json.loads(json.dumps(
        {st.name: st.snapshot() for st in stages
         if st.snapshot() is not None}))


def _restore(stages, state: dict) -> None:
    for st in stages:
        if st.name in state:
            st.restore(state[st.name])


def _gate(stages):
    (gate,) = [st.gate for st in stages if getattr(st, "gate", None)]
    return gate


def _objects_agree(a: list, b: list) -> None:
    """The same objects frame by frame: ids, labels and attribute labels
    equal; boxes and confidences within 1e-4."""
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert len(fa["objects"]) == len(fb["objects"])
        for oa, ob in zip(fa["objects"], fb["objects"]):
            assert oa.get("id") == ob.get("id")
            assert oa["detection"]["label"] == ob["detection"]["label"]
            for k in ("x_min", "y_min", "x_max", "y_max"):
                assert abs(oa["detection"]["bounding_box"][k]
                           - ob["detection"]["bounding_box"][k]) <= 1e-4
            assert abs(oa["detection"]["confidence"]
                       - ob["detection"]["confidence"]) <= 1e-4
            for attr in ("color", "type"):
                assert (oa.get(attr) or {}).get("label") == \
                    (ob.get(attr) or {}).get("label")


@pytest.mark.usefixtures("native_reference", "ckpt_on")
def test_stage_state_restores_across_packages(tmp_path):
    models = _models(tmp_path)
    jhub = JaxHub(JaxRegistry(models_dir=models, dtype="float32", **SMALL),
                  plan=build_mesh(), max_batch=4, deadline_ms=1.0)
    hub = EngineHub(ModelRegistry(models_dir=models, dtype="float32",
                                  device="cpu", **SMALL),
                    device="cpu", max_batch=4, deadline_ms=1.0)
    uri = "synthetic://64x64@30?count=16&seed=3"
    ref_events = list(JaxSource.from_uri(uri).frames())
    port_events = list(SyntheticSource.from_uri(uri).frames())
    try:
        out = {k: [] for k in ("ref", "port", "ref_from_port",
                               "port_from_ref")}
        ref_a = _ref_chain(jhub, out["ref"])
        port_b = _port_chain(hub, out["port"])
        _feed(JaxRunner, ref_a, ref_events[:8])
        _feed(StreamRunner, port_b, port_events[:8])
        snap_ref, snap_port = _snapshot(ref_a), _snapshot(port_b)
        assert set(snap_ref) == set(snap_port)
        assert snap_ref["tracking"]["next_id"] == \
            snap_port["tracking"]["next_id"] > 1
        (det,) = [k for k, v in snap_port.items() if "coaster" in v]
        assert "gate" in snap_ref[det] and snap_ref[det]["count"] == 8
        del out["ref"][:], out["port"][:]
        ref_c = _ref_chain(jhub, out["ref_from_port"])
        port_d = _port_chain(hub, out["port_from_ref"])
        _restore(ref_c, snap_port)
        _restore(port_d, snap_ref)
        gates_before = [(_gate(c).ran, _gate(c).skipped)
                        for c in (ref_a, port_b, ref_c, port_d)]
        _feed(JaxRunner, ref_a, ref_events[8:])
        _feed(StreamRunner, port_b, port_events[8:])
        _feed(JaxRunner, ref_c, ref_events[8:])
        _feed(StreamRunner, port_d, port_events[8:])
        ran = [(_gate(c).ran - r0, _gate(c).skipped - s0)
               for c, (r0, s0) in zip((ref_a, port_b, ref_c, port_d),
                                      gates_before)]
        assert ran[3] == ran[0] and ran[2] == ran[1]
        assert len(out["port_from_ref"]) == 8
        _objects_agree(out["port_from_ref"], out["ref"])
        _objects_agree(out["ref_from_port"], out["port"])
        ids = [o["id"] for f in out["port_from_ref"] for o in f["objects"]]
        assert ids and min(ids) < snap_ref["tracking"]["next_id"]  # kept
    finally:
        hub.stop()
        jhub.stop()


# ------------------------------------------------------------- resume


def _wait_lines(path: Path, n: int, timeout: float = 120.0) -> list:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if path.exists():
            lines = path.read_text().splitlines()
            if len(lines) >= n:
                return [json.loads(x) for x in lines]
        time.sleep(0.05)
    raise AssertionError(f"{path} did not reach {n} lines")


def _request(out: Path) -> dict:
    return {"source": {"uri": "synthetic://64x64@30?seed=4", "type": "uri",
                       "realtime": True},
            "destination": {"metadata": {"type": "file", "path": str(out)}},
            "parameters": {"detection-threshold": 0.2}}


def _ids(lines: list) -> list[int]:
    return [o["id"] for line in lines for o in line["objects"] if "id" in o]


def _port_registry(models, state_dir) -> PipelineRegistry:
    hub = EngineHub(ModelRegistry(models_dir=models, dtype="float32",
                                  device="cpu", **SMALL),
                    device="cpu", max_batch=4, deadline_ms=1.0)
    return PipelineRegistry(port_settings.Settings(
        pipelines_dir=str(REPO / "pipelines"), device="cpu",
        state_dir=str(state_dir), drain_timeout_s=10.0), hub=hub)


def _resume_and_check(models, state_dir, before: list, out: Path) -> dict:
    """Resume ``state_dir``'s stream on the port: every id it issues
    that was not live before the restart is above every id in
    ``before`` (tracks that were live keep theirs). Returns the resumed
    status."""
    out.unlink(missing_ok=True)
    registry = _port_registry(models, state_dir)
    try:
        assert registry.resume() == 1
        (inst,) = registry.instances.values()
        st = inst.status()
        lines = _wait_lines(out, 12)
        new = set(_ids(lines)) - set(before)
        assert new and min(new) > max(before)
        return st
    finally:
        registry.stop_all()


@pytest.mark.usefixtures("native_reference", "ckpt_on")
def test_port_resumes_the_references_streams_json(tmp_path):
    models = _models(tmp_path)
    state_dir, out = tmp_path / "state", tmp_path / "o.jsonl"
    jhub = JaxHub(JaxRegistry(models_dir=models, dtype="float32", **SMALL),
                  plan=build_mesh(), max_batch=4, deadline_ms=1.0)
    ref_reg = JaxPipelineRegistry(ref_settings.Settings(
        pipelines_dir=str(REPO / "pipelines"), state_dir=str(state_dir),
        drain_timeout_s=10.0), hub=jhub)
    try:
        ref_reg.start_instance(*TRACK, _request(out))
        _wait_lines(out, 12)
    finally:
        ref_reg.stop_all()
    before = _ids([json.loads(x) for x in out.read_text().splitlines()])
    (entry,) = json.loads((state_dir / "streams.json").read_text())
    assert port_state.is_checkpoint_blob(entry["state"])
    assert port_state.decode(entry["state"]).barrier == "drain"
    st = _resume_and_check(models, state_dir, before, out)
    assert st["checkpoint"]["restored_from"]["barrier"] == "drain"
    assert st["checkpoint"]["restored_from"]["stale"] is False


@pytest.mark.usefixtures("ckpt_on")
def test_port_drain_and_resume_keep_ids_increasing(tmp_path):
    models = tmp_path / "models"
    reg = ModelRegistry(models_dir=models, dtype="float32", device="cpu",
                        allow_random_weights=True, **SMALL)
    for key in (DET, CLS):
        reg.get(key)
        reg.save_weights(key)
    state_dir, out = tmp_path / "state", tmp_path / "o.jsonl"
    registry = _port_registry(models, state_dir)
    try:
        inst = registry.start_instance(*TRACK, _request(out))
        _wait_lines(out, 12)
        assert json.loads((state_dir / "streams.json").read_text())[0][
            "request"] == inst.request
    finally:
        registry.stop_all()
    before = _ids([json.loads(x) for x in out.read_text().splitlines()])
    st = _resume_and_check(models, state_dir, before, out)
    assert st["checkpoint"]["restored_from"]["barrier"] == "drain"
    # a DELETE leaves nothing to resume
    registry = _port_registry(models, state_dir)
    try:
        assert registry.resume() == 1
        (inst,) = registry.instances.values()
        registry.stop_instance(inst.id)
        assert json.loads((state_dir / "streams.json").read_text()) == []
    finally:
        registry.stop_all()
    assert json.loads((state_dir / "streams.json").read_text()) == []
