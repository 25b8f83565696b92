"""The port's fleet (``evam_tpu_torch/fleet/``, ``EVAM_FLEET=sharded``)
against the reference's (``evam_tpu/fleet/``), on the CPU.

* ``ConsistentHashPlacer``: over the same labels and 10,000 keys, the
  reference's placements; downing a shard moves only its keys; growing
  the ring equals a fresh ring.
* ``FleetEngine`` over CPU shards (``EngineHub(devices=["cpu"] * 2)``)
  held against the reference's FleetEngine over 2 of the 8 host devices
  (``tests/conftest.py``), built as ``tests/test_fleet.py`` builds it,
  with the same float32 weights (64×64, width 8) and the same wire
  frames: per-stream outputs within 1e-4 (the port's float32
  tolerance), equal placements, the batch class on the mesh twin, the
  same rebalances after a retire, ``scale_up`` warming its shard before
  it joins and ``scale_down`` — the same pins after each — and the
  aggregates in the reference's shapes.
* The eighth law: the same proposals on the same fleet signals, and
  live on a port hub — the controller's target grows a fleet of CPU
  shards by one warm shard.
* The REST surface with the fleet on: ``/healthz`` holds its golden,
  ``/engines`` has a row per shard (and the twin) with the reference's
  shard, device and group, ``/scheduler`` reports the fleet.
* With one device ``sharded`` degrades to off, as the reference's does.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu.control import controller as ref_controller
from evam_tpu.control import state as ref_state
from evam_tpu.config import settings as ref_settings
from evam_tpu.engine.hub import EngineHub as RefHub
from evam_tpu.fleet import ConsistentHashPlacer as RefPlacer
from evam_tpu.models import ModelRegistry as RefRegistry
from evam_tpu.parallel.mesh import build_mesh
from evam_tpu_torch.config import settings as port_settings
from evam_tpu_torch.control import controller, state
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.fleet import ConsistentHashPlacer, FleetEngine, MeshStep
from evam_tpu_torch.media.source import SyntheticSource
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.stages import gate as port_gate
from evam_tpu_torch.stages.infer import _wire_frame

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KEY = "object_detection/person_vehicle_bike"
SMALL = dict(input_overrides={KEY: (64, 64)}, width_overrides={KEY: 8})
#: the port's float32 tolerance against the reference (boxes, scores)
TOL = 1e-4
STREAMS = [f"cam{i}" for i in range(8)]


# ------------------------------------------------------------ placer

def test_placer_places_10000_keys_as_the_reference():
    labels = [f"s{i}" for i in range(8)]
    keys = [f"stream-{i}" for i in range(10_000)]
    got, want = ConsistentHashPlacer(labels), RefPlacer(labels)
    assert [got.place(k) for k in keys] == [want.place(k) for k in keys]
    before = {k: got.place(k) for k in keys}
    victim = "s3"
    got.mark_down(victim)
    want.mark_down(victim)
    after = {k: got.place(k) for k in keys}
    assert after == {k: want.place(k) for k in keys}
    for k in keys:  # only the downed shard's keys move
        if before[k] == victim:
            assert after[k] != victim
        else:
            assert after[k] == before[k]
    assert sum(before[k] == victim for k in keys) > 0
    got.add("s8")
    want.add("s8")
    fresh = ConsistentHashPlacer(labels + ["s8"])
    fresh.mark_down(victim)
    assert [got.place(k) for k in keys] == [want.place(k) for k in keys] \
        == [fresh.place(k) for k in keys]
    assert got.live() == want.live()


# -------------------------------------------------- fleets side by side

@pytest.fixture(scope="module")
def fleets(tmp_path_factory, eight_devices):
    """(reference hub, port hub): the fleet over two devices, the same
    float32 weights (saved by the reference, loaded by the port)."""
    models = tmp_path_factory.mktemp("fleet") / "models"
    jreg = RefRegistry(models_dir=models, dtype="float32",
                       allow_random_weights=True, **SMALL)
    jreg.get(KEY)
    jreg.save_weights(KEY)
    ref = RefHub(jreg, plan=build_mesh(devices=eight_devices[:2]),
                 max_batch=8, deadline_ms=2.0, supervise=False,
                 stall_timeout_s=0, fleet="sharded")
    port = EngineHub(ModelRegistry(models_dir=models, dtype="float32",
                                   device="cpu", **SMALL),
                     device="cpu", devices=["cpu"] * 2, max_batch=8,
                     deadline_ms=2.0, supervise=False, stall_timeout_s=0,
                     fleet="sharded")
    yield ref, port
    ref.stop()
    port.stop()


def _wires(n: int, seed: int) -> list[np.ndarray]:
    return [_wire_frame(ev.frame, (64, 64), "i420")
            for ev in SyntheticSource(96, 96, count=n, seed=seed).frames()]


def _pins(fleet) -> dict[str, str]:
    with fleet._lock:
        return dict(fleet._pins)


def _serve_streams(eng, frames: dict[str, list]) -> dict[str, list]:
    """Each stream's frames one at a time (every batch one frame)."""
    return {s: [eng.submit(stream=s, frames=f).result(timeout=60)
                for f in fs] for s, fs in frames.items()}


def test_streams_are_placed_and_served_as_in_the_reference(fleets):
    ref_hub, port_hub = fleets
    ref = ref_hub.engine("detect", KEY, score_threshold=0.1)
    got = port_hub.engine("detect", KEY, score_threshold=0.1)
    assert isinstance(got, FleetEngine)
    assert sorted(got.shards) == sorted(ref.shards) == ["s0", "s1"]
    assert got.buckets == ref.buckets == [1, 2, 4]
    frames = {s: _wires(3, i) for i, s in enumerate(STREAMS)}
    want = _serve_streams(ref, frames)
    have = _serve_streams(got, frames)
    assert _pins(got) == _pins(ref)
    assert set(_pins(got).values()) == {"s0", "s1"}
    for s in STREAMS:
        for w, h in zip(want[s], have[s]):
            assert h.shape == w.shape
            np.testing.assert_allclose(h, w, rtol=0, atol=TOL)
    # each stream's traffic landed on its pinned shard only
    rows = port_hub.stats()
    per_shard = {r["shard"]: r["items"] for k, r in rows.items()
                 if r["group"] == f"detect:{KEY}" and r["shard"] != "mesh"}
    counts = got.placement_counts()
    assert per_shard == {label: 3 * n for label, n in counts.items()}
    assert got.placement_counts() == ref.placement_counts()


def test_the_batch_class_rides_the_mesh_twin(fleets):
    """Batch-class frames go to the twin, whose step splits a bucket of
    2 or more rows over the two devices and gathers it back, and runs a
    bucket of one on the first device (the ``fleet_local`` rung): the
    reference's outputs either way."""
    ref_hub, port_hub = fleets
    ref = ref_hub.engine("detect", KEY, score_threshold=0.1)
    got = port_hub.engine("detect", KEY, score_threshold=0.1)
    wires = _wires(8, 42)
    want = [f.result(60) for f in [ref.submit(priority="batch", stream="b",
                                              frames=w) for w in wires]]
    have = [f.result(60) for f in [got.submit(priority="batch", stream="b",
                                              frames=w) for w in wires]]
    for w, h in zip(want, have):
        np.testing.assert_allclose(h, w, rtol=0, atol=TOL)
    twin = got._mesh_eng
    assert twin is not None and isinstance(twin.step_fn, MeshStep)
    assert twin.buckets == ref._mesh_eng.buckets == [1, 2, 4, 8]
    assert twin.stats.items == 8
    assert "b" not in _pins(got)  # the twin places nothing
    rows = port_hub.stats()
    assert rows[f"detect:{KEY}@mesh"]["items"] == 8
    assert rows[f"detect:{KEY}@mesh"]["device"] == "mesh"


def test_a_warming_hub_warms_the_twin_it_builds_later():
    """With warmup on, the twin built by the first batch-class frame is
    warmed too: every one of its buckets runs its warm step, the fleet
    ends ``warmed`` and /healthz counts nothing as warming."""
    hub = EngineHub(ModelRegistry(device="cpu", allow_random_weights=True,
                                  **SMALL),
                    device="cpu", devices=["cpu"] * 2, max_batch=4,
                    deadline_ms=1.0, supervise=False, stall_timeout_s=0,
                    fleet="sharded", warmup=True)
    try:
        fleet = hub.engine("detect", KEY, score_threshold=0.1)
        wires = _wires(4, 3)
        fleet.warm_async(frames=np.zeros_like(wires[0]))
        for f in [fleet.submit(priority="batch", stream="b", frames=w)
                  for w in wires]:
            f.result(timeout=60)
        twin = fleet._mesh_eng
        assert twin is not None
        deadline = time.monotonic() + 60
        while not fleet.warmed.is_set() and time.monotonic() < deadline:
            time.sleep(0.05)
        assert twin.warmed.is_set() and fleet.warmed.is_set()
        assert twin.stats.warm_forwards == len(twin.buckets)
        assert hub.readiness()["warming"] == 0
    finally:
        hub.stop()


def test_retire_scale_down_and_scale_up_move_the_same_streams(
        fleets, monkeypatch):
    """A retired shard's streams re-place onto the survivor, counted;
    scale_up brings a warm shard back into its slot (checked at the
    moment it joins the ring); scale_down drains it again — the same
    pins and counts as the reference's after each step."""
    ref_hub, port_hub = fleets
    ref = ref_hub.engine("detect", KEY, score_threshold=0.1)
    got = port_hub.engine("detect", KEY, score_threshold=0.1)
    frames = {s: _wires(1, 7) for s in STREAMS}
    _serve_streams(ref, frames)
    _serve_streams(got, frames)
    base = got.rebalances
    assert base == ref.rebalances
    example = {"frames": np.zeros_like(frames[STREAMS[0]][0])}
    ref.set_example(**example)
    got.set_example(**example)

    # a planned scale-down: s1's streams move to s0
    assert got.scale_down() == ref.scale_down() == "s1"
    _serve_streams(ref, frames)
    _serve_streams(got, frames)
    assert _pins(got) == _pins(ref) == {s: "s0" for s in STREAMS}
    assert got.rebalances == ref.rebalances > base
    got.drain_wait()
    ref.drain_wait()

    # scale_up: the shard is warm when it joins the ring
    joined = []
    add = got._placer.add

    def checked_add(label):
        joined.append((label, got.shards[label].warmed.is_set()))
        add(label)

    monkeypatch.setattr(got._placer, "add", checked_add)
    assert got.scale_up() == ref.scale_up() == "s1"
    assert joined == [("s1", True)]
    assert got.shards["s1"].stats.warm_forwards == len(got.buckets)
    assert _pins(got) == _pins(ref)
    assert got.rebalances == ref.rebalances
    summary, ref_summary = got.fleet_summary(), ref.fleet_summary()
    assert summary == ref_summary
    assert (summary["scale_ups"], summary["scale_downs"]) == (1, 1)

    # a degraded shard's retirement (the supervisor's terminal state)
    got._retire("s0")
    ref._retire("s0")
    _serve_streams(ref, frames)
    _serve_streams(got, frames)
    got.drain_wait()
    ref.drain_wait()
    assert _pins(got) == _pins(ref) == {s: "s1" for s in STREAMS}
    assert got.rebalances == ref.rebalances
    assert got.fleet_summary() == ref.fleet_summary()
    assert got.fleet_summary()["degraded_shards"] == 1
    # a dead slot is never reused
    assert got.scale_up() is ref.scale_up() is None
    # the fleet's counters stay monotonic across the retirements
    assert got.stats.items >= 3 * len(STREAMS)


def test_aggregates_keep_the_references_shapes(fleets):
    ref_hub, port_hub = fleets
    port_hub.engine("detect", KEY, score_threshold=0.1)
    ref_hub.engine("detect", KEY, score_threshold=0.1)
    for name in ("readiness", "stage_summary", "queue_summary",
                 "class_queue_depths", "shed_totals", "fleet_summary"):
        got, want = getattr(port_hub, name)(), getattr(ref_hub, name)()
        assert set(got) == set(want), name
    assert port_hub.fleet_summary()["mode"] == "sharded"
    got_rows, want_rows = port_hub.stats(), ref_hub.stats()
    assert set(got_rows) == set(want_rows)
    for key, row in got_rows.items():
        want = want_rows[key]
        assert (row["shard"], row["group"]) == (want["shard"], want["group"])
        assert row["device"] == ("mesh" if row["shard"] == "mesh" else "cpu")
    fleet = port_hub.engine("detect", KEY, score_threshold=0.1)
    row = fleet.stats_row()
    assert row["items"] == sum(r["items"] for r in got_rows.values()) + \
        (fleet._stats_carry.items if fleet._stats_carry else 0)
    assert fleet.state == ref_hub.engine(
        "detect", KEY, score_threshold=0.1).state == "running"


def test_one_device_degrades_to_off_as_the_reference(caplog, eight_devices):
    reg = ModelRegistry(device="cpu", allow_random_weights=True, **SMALL)
    with caplog.at_level("WARNING"):
        hub = EngineHub(reg, device="cpu", fleet="sharded")
    ref = RefHub(RefRegistry(dtype="float32", allow_random_weights=True,
                             **SMALL),
                 plan=build_mesh(devices=eight_devices[:1]), fleet="sharded")
    try:
        assert hub.fleet_active is ref.fleet_active is False
        assert "EVAM_FLEET=sharded needs more than one device" in caplog.text
        assert not isinstance(hub.engine("detect", KEY), FleetEngine)
        assert hub.fleet_summary() == ref.fleet_summary()
    finally:
        hub.stop()
        ref.stop()


# ----------------------------------------------------------- the eighth law

@pytest.fixture
def _fresh_tune(monkeypatch):
    monkeypatch.delenv("EVAM_TUNE", raising=False)
    monkeypatch.setattr(port_gate.registry, "skipped_fps", lambda: 0.0)
    for reset in (ref_settings.reset_settings, port_settings.reset_settings,
                  ref_state.reset_cache, state.reset_cache):
        reset()
    yield
    for reset in (ref_settings.reset_settings, port_settings.reset_settings,
                  ref_state.reset_cache, state.reset_cache):
        reset()


class _Hub:
    max_batch = 128

    def stats(self):
        return {}

    def shed_totals(self):
        return {}

    def retune(self, op):
        pass


def _knobs(proposals) -> list[tuple]:
    return [(knob, value) for knob, value, _ in proposals]


@pytest.mark.usefixtures("_fresh_tune")
def test_the_eighth_law_proposes_as_the_reference():
    kw = dict(enabled=True)
    pt = controller.TuneController(
        _Hub(), state.TuneState(port_settings.TuneSettings(**kw)))
    rf = ref_controller.TuneController(
        _Hub(), ref_state.TuneState(ref_settings.TuneSettings(**kw)))
    rng = np.random.default_rng(9)
    moved = set()
    for _ in range(400):
        sig = dict(state.ZERO_SIGNALS)
        sig.update(utilization=float(rng.choice([0.1, 0.3, 0.6, 0.9, 1.2])),
                   fleet_shards=float(rng.integers(0, 5)),
                   fleet_max_shards=float(rng.choice([0, 2, 4])))
        target = int(rng.integers(0, 5))
        got = pt._propose(sig, state.OperatingPoint(fleet_shards=target))
        want = rf._propose(sig, ref_state.OperatingPoint(
            fleet_shards=target))
        # the eighth law's reasons say what the port does (no AOT
        # cache, no migration checkpoint); its knobs and targets are
        # the reference's
        assert _knobs(got) == _knobs(want)
        assert [p for p in got if p[0] != "fleet_shards"] \
            == [p for p in want if p[0] != "fleet_shards"]
        assert not any("AOT" in p[2] or "checkpointed" in p[2]
                       for p in got)
        moved |= {p[1] for p in got if p[0] == "fleet_shards"}
    assert len(moved) > 2  # grows, drains and rests all happened


class _Admission:
    """Admission stub: a saturated fleet."""

    def utilization(self):
        return 0.95

    def capacity_fps(self, live=False):
        return 100.0

    def effective_demand_fps(self):
        return 95.0


@pytest.mark.usefixtures("_fresh_tune")
def test_the_eighth_law_grows_a_live_fleet():
    """EVAM_FLEET_MAX_SHARDS 3 over three CPU devices, booted at one
    shard: a saturated tick targets two shards, and the hub's retune
    grows the fleet by one warm shard."""
    hub = EngineHub(ModelRegistry(device="cpu", allow_random_weights=True,
                                  **SMALL),
                    device="cpu", devices=["cpu"] * 3, max_batch=4,
                    deadline_ms=1.0, supervise=False, stall_timeout_s=0,
                    fleet="sharded", fleet_max_shards=3,
                    fleet_initial_shards=1)
    try:
        fleet = hub.engine("detect", KEY, score_threshold=0.1)
        fleet.set_example(frames=np.zeros((96, 64), np.uint8))
        assert len(fleet.shards) == 1
        assert hub.fleet_summary()["max_shards"] == 3
        ctl = controller.TuneController(
            hub, state.TuneState(port_settings.TuneSettings(
                enabled=True, damping=1, cooldown=0)),
            admission=_Admission())
        sig = ctl.tick()
        assert (sig["fleet_shards"], sig["fleet_max_shards"]) == (1.0, 3.0)
        assert ctl.state.op.fleet_shards == 2
        deadline = time.monotonic() + 60
        while len(fleet.shards) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sorted(fleet.shards) == ["s0", "s1"]
        assert fleet.shards["s1"].warmed.is_set()
        actions = ctl.state.snapshot()["actions"]
        assert any(a["knob"] == "fleet_shards" and a["to"] == 2
                   for a in actions)
    finally:
        hub.stop()


# --------------------------------------------------------- REST surface

def test_rest_surface_with_the_fleet_on(tmp_path):
    from evam_tpu_torch.config.settings import Settings
    from evam_tpu_torch.server.registry import PipelineRegistry
    from test_torch_server import PortServer, _assert_golden, _body

    hub = EngineHub(ModelRegistry(device="cpu", allow_random_weights=True,
                                  **SMALL),
                    device="cpu", devices=["cpu"] * 2, max_batch=4,
                    deadline_ms=5.0, fleet="sharded")
    srv = PortServer(PipelineRegistry(
        Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu",
                 drain_timeout_s=10.0), hub=hub))
    path = f"/pipelines/{KEY}"
    try:
        status, iid = srv.request("POST", path, _body(tmp_path / "o.jsonl"))
        assert status == 200, iid
        assert srv.wait(iid, path=path)["state"] == "COMPLETED"
        status, health = srv.request("GET", "/healthz")
        assert status == 200
        _assert_golden("route_healthz", health)
        status, engines = srv.request("GET", "/engines")
        key = f"detect:{KEY}"
        assert sorted(engines) == [f"{key}@s0", f"{key}@s1"]
        assert {r["shard"] for r in engines.values()} == {"s0", "s1"}
        assert all(r["group"] == key and r["device"] == "cpu"
                   for r in engines.values())
        assert sum(r["items"] for r in engines.values()) == \
            len((tmp_path / "o.jsonl").read_text().splitlines())
        status, sched = srv.request("GET", "/scheduler")
        fleet = sched["fleet"]
        assert fleet["mode"] == "sharded" and fleet["shards"] == 2
        assert sum(fleet["streams"].values()) == 1
        assert json.dumps(fleet)  # plain JSON
    finally:
        srv.close()
