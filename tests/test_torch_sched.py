"""The port's QoS layer (``evam_tpu_torch/sched/``) against the
reference's (``evam_tpu/sched/``), on the CPU, and the scheduler's path
through the port's engine, runner and registry.

Exact equality throughout: the three modules are copies. For seeded
random sequences:

* ``ClassQueues``: the same picks (starvation guard included), the same
  batches collected, the same expired heads popped;
* ``Shedder.sweep``/``shed`` under an injected clock: the same items
  shed, per class, with the same errors;
* ``AdmissionController.admit`` over a stub hub's stats rows: the same
  admissions, rejections, ``retry_after_s`` and snapshots.

Then the engine's sched path: every class resolves to the step's value;
a flood sheds batch frames, never realtime ones, and the shed counts
agree with the futures; the runner counts a shed as one frame error and
carries on; the registry stamps the request's priority on every frame
and releases the stream's ticket when the instance ends.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu.control import state as ref_control_state
from evam_tpu.sched import admission as ref_admission
from evam_tpu.sched import classes as ref_classes
from evam_tpu.sched import shedder as ref_shedder
from evam_tpu.stages import gate as ref_gate
from evam_tpu_torch.config.settings import Settings, SchedSettings
from evam_tpu_torch.control import state as control_state
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.supervisor import SupervisedEngine
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.sched import admission, classes, shedder
from evam_tpu_torch.sched import SchedConfig, ShedError
from evam_tpu_torch.server import registry as port_registry
from evam_tpu_torch.stages import gate as port_gate
from evam_tpu_torch.stages.base import AsyncStage
from evam_tpu_torch.stages.runner import StreamRunner

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _tune_off(monkeypatch):
    """Both control planes off (their setpoints would scale budgets and
    ceilings), and no gate credit from an earlier test's gates."""
    monkeypatch.delenv("EVAM_TUNE", raising=False)
    control_state.reset_cache()
    ref_control_state.reset_cache()
    monkeypatch.setattr(port_gate.registry, "skipped_fps", lambda: 0.0)
    monkeypatch.setattr(ref_gate.registry, "skipped_fps", lambda: 0.0)
    yield
    control_state.reset_cache()
    ref_control_state.reset_cache()


class _It:
    """A queued item: submit time, future, and an id to compare by."""

    def __init__(self, i: int, t: float):
        self.i = i
        self.t_submit = t
        self.future = Future()


def test_constants_and_validation_are_the_references():
    assert classes.PRIORITIES == ref_classes.PRIORITIES
    assert classes.DEFAULT_PRIORITY == ref_classes.DEFAULT_PRIORITY
    assert classes.STARVATION_LIMITS == ref_classes.STARVATION_LIMITS
    assert admission.CLASS_HEADROOM == ref_admission.CLASS_HEADROOM
    assert admission._SERVICE_STAGES == ref_admission._SERVICE_STAGES
    for value in ("realtime", " Batch ", "STANDARD", "turbo", 3, None, ""):
        for fn in ("validate_priority", "coerce_priority"):
            try:
                want = getattr(ref_classes, fn)(value)
            except ValueError as exc:
                with pytest.raises(ValueError) as got:
                    getattr(classes, fn)(value)
                assert str(got.value) == str(exc)
            else:
                assert getattr(classes, fn)(value) == want
    # one copy in the port: the registry validates with the sched module's
    assert port_registry.validate_priority is classes.validate_priority
    assert not hasattr(port_registry, "PRIORITIES")


def test_sched_config_from_settings_is_the_references():
    from evam_tpu.config.settings import SchedSettings as RefSched

    for set_std in (False, True):
        kw = dict(enabled=True, admit_util=0.7, capacity_fps=50.0,
                  deadline_ms_realtime=3.0, deadline_ms_batch=30.0,
                  staleness_ms_batch=900.0)
        if set_std:
            kw["deadline_ms_standard"] = 11.0
        port = SchedSettings(**kw)
        port.fields_set |= set(kw)
        ref = RefSched(**kw)
        got = SchedConfig.from_settings(port, standard_deadline_ms=12.5)
        want = ref_classes.SchedConfig.from_settings(
            ref, standard_deadline_ms=12.5)
        assert got.__dict__ == want.__dict__
        assert got.staleness_s() == want.staleness_s()
        assert [got.deadline_s(c) for c in classes.PRIORITIES] == \
            [want.deadline_s(c) for c in classes.PRIORITIES]
    assert SchedConfig.disabled().__dict__ == \
        ref_classes.SchedConfig.disabled().__dict__


@pytest.mark.parametrize("seed", range(4))
def test_class_queues_pick_and_collect_as_the_reference(seed):
    """Seeded puts, picks, collects and expiry pops, timeouts 0: the
    same classes picked and the same items out, in order."""
    rng = np.random.default_rng(seed)
    port, ref = classes.ClassQueues(), ref_classes.ClassQueues()
    now = time.perf_counter()
    n = 0
    for step in range(400):
        op = rng.choice(["put", "put", "pick", "collect", "expire"])
        if op == "put":
            cls = classes.PRIORITIES[rng.integers(0, 3)]
            t = now - float(rng.uniform(0, 2))
            port.put(cls, _It(n, t))
            ref.put(cls, _It(n, t))
            n += 1
        elif op == "pick":
            assert port.pick(0.0) == ref.pick(0.0), step
        elif op == "collect":
            cls = classes.PRIORITIES[rng.integers(0, 3)]
            max_n = int(rng.integers(1, 6))
            got = port.collect(cls, max_n, 0.0)
            want = ref.collect(cls, max_n, 0.0)
            assert [x.i for x in got] == [x.i for x in want], step
        else:
            cls = classes.PRIORITIES[rng.integers(0, 3)]
            cut = now - float(rng.uniform(0, 2))
            assert [x.i for x in port.pop_expired(cls, cut)] == \
                [x.i for x in ref.pop_expired(cls, cut)]
        assert port.depth_by_class() == ref.depth_by_class()
        assert port.oldest_age_s(now) == ref.oldest_age_s(now)
    port.close()
    ref.close()
    assert port.pick(0.0) == ref.pick(0.0)
    assert [x.i for x in port.drain()] == [x.i for x in ref.drain()]
    with pytest.raises(RuntimeError):
        port.put("batch", _It(0, now))


@pytest.mark.parametrize("seed", range(4))
def test_shedder_sheds_as_the_reference(seed):
    """An injected clock: per-class budgets (one class never sheds),
    sweeps of waiting items and sheds of formed batches drop the same
    items with the same errors and the same counts."""
    rng = np.random.default_rng(seed)
    budgets = {"realtime": 0.2, "standard": 0.0, "batch": 1.0}
    port = shedder.Shedder("e", budgets)
    ref = ref_shedder.Shedder("e", budgets)
    qp, qr = classes.ClassQueues(), ref_classes.ClassQueues()
    now = 100.0
    items: dict[int, tuple[_It, _It]] = {}
    for step in range(200):
        now += float(rng.uniform(0, 0.2))
        op = rng.choice(["put", "put", "sweep", "shed"])
        if op == "put":
            cls = classes.PRIORITIES[rng.integers(0, 3)]
            t = now - float(rng.uniform(0, 1.5))
            pair = (_It(step, t), _It(step, t))
            items[step] = pair
            qp.put(cls, pair[0])
            qr.put(cls, pair[1])
        elif op == "sweep":
            assert port.sweep(qp, now=now) == ref.sweep(qr, now=now)
        else:
            cls = classes.PRIORITIES[rng.integers(0, 3)]
            got = port.shed(cls, qp.collect(cls, 4, 0.0), now=now)
            want = ref.shed(cls, qr.collect(cls, 4, 0.0), now=now)
            assert [x.i for x in got] == [x.i for x in want]
        assert port.counts == ref.counts
    assert sum(port.counts.values()) > 0 and port.counts["standard"] == 0
    for p, r in items.values():
        assert p.future.done() == r.future.done()
        if r.future.done():
            pe, re_ = p.future.exception(), r.future.exception()
            assert isinstance(pe, ShedError) and str(pe) == str(re_)
            assert (pe.priority, pe.age_s, pe.budget_s) == \
                (re_.priority, re_.age_s, re_.budget_s)


class _StubHub:
    """Stats rows of a few engines; the admission controller reads only
    these and ``max_batch``."""

    max_batch = 128

    def __init__(self, rows: dict):
        self.rows = rows

    def stats(self):
        return self.rows


def _rows(rng) -> dict:
    rows = {}
    for e in range(int(rng.integers(0, 4))):
        batches = int(rng.integers(0, 50))
        rows[f"e{e}"] = {
            "batches": batches,
            "items": int(rng.integers(0, 8 * batches + 1)),
            "mean_occupancy": float(rng.uniform(0, 1)),
            "stage_ms": {s: float(rng.uniform(0, 5)) for s in
                         ("h2d_issue", "h2d_wait", "launch", "readback",
                          "slot_write")},
        }
    return rows


@pytest.mark.parametrize("seed", range(6))
def test_admission_admits_and_rejects_as_the_reference(seed):
    """Seeded stats rows, a seeded mix of starts and releases: the same
    admissions and rejections (with the same ``retry_after_s`` and
    message), the same capacity, utilization and snapshot."""
    rng = np.random.default_rng(seed)
    hub = _StubHub(_rows(rng))
    cfg_kw = dict(admit_util=float(rng.uniform(0.3, 1.0)),
                  capacity_fps=float(rng.choice([0.0, 0.0, 200.0])))
    port = admission.AdmissionController(hub, SchedConfig(**cfg_kw))
    ref = ref_admission.AdmissionController(
        hub, ref_classes.SchedConfig(**cfg_kw))
    tickets = []
    for _ in range(60):
        if tickets and rng.random() < 0.3:
            tp, tr = tickets.pop(int(rng.integers(0, len(tickets))))
            tp.release()
            tr.release()
            continue
        prio = classes.PRIORITIES[rng.integers(0, 3)]
        fps = float(rng.choice([5.0, 15.0, 30.0, 60.0]))
        try:
            tr = ref.admit(prio, fps)
        except ref_admission.AdmissionError as exc:
            with pytest.raises(admission.AdmissionError) as got:
                port.admit(prio, fps)
            assert str(got.value) == str(exc)
            assert got.value.retry_after_s == exc.retry_after_s
        else:
            tickets.append((port.admit(prio, fps), tr))
        assert port.snapshot() == ref.snapshot()
    assert port.capacity_fps(live=True) == ref.capacity_fps(live=True)
    assert port.counts() == ref.counts()


def test_disabled_admission_admits_everything_and_counts():
    hub = _StubHub({"e": {"batches": 10, "items": 10, "stage_ms":
                          {"launch": 1000.0}}})
    ctrl = admission.AdmissionController(hub, SchedConfig.disabled())
    for _ in range(5):
        ctrl.admit("batch", 1000.0)
    assert ctrl.counts()["admitted"]["batch"] == 5
    assert ctrl.snapshot()["enabled"] is False


# ------------------------------------------------------ engine sched path


def _toy(name: str, **kw) -> BatchEngine:
    return BatchEngine(name, lambda x: x * 2.0, "cpu", max_batch=4,
                       deadline_ms=4.0, input_names=("x",),
                       stall_timeout_s=0, **kw)


def _x(v: float) -> np.ndarray:
    return np.full((2,), v, np.float32)


@pytest.mark.parametrize("assembly", ["slot", "legacy"])
def test_every_class_resolves_through_the_sched_engine(assembly):
    eng = _toy(f"sched-{assembly}", sched=SchedConfig(), assembly=assembly)
    try:
        assert eng._classq is not None and eng.class_depths() == {
            "realtime": 0, "standard": 0, "batch": 0}
        futs = [eng.submit(priority=p, x=_x(i)) for i, p in enumerate(
            ["realtime", "standard", "batch", "realtime", "batch"] * 3)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=60),
                                          np.full((2,), 2.0 * i))
        with pytest.raises(ValueError, match="priority"):
            eng.submit(priority="turbo", x=_x(0))
        assert eng.stats_row()["sched_queues"] == {
            "realtime": 0, "standard": 0, "batch": 0}
    finally:
        eng.stop()


def test_sched_off_accepts_and_ignores_priority():
    eng = _toy("sched-off")
    try:
        assert eng.sched is None and eng._classq is None
        assert eng.class_depths() == {} and eng.shed_counts() == {}
        futs = [eng.submit(priority="batch", x=_x(i)) for i in range(6)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=60),
                                          np.full((2,), 2.0 * i))
    finally:
        eng.stop()


def test_flood_sheds_batch_never_realtime():
    """The dispatcher held at its launch (inline transfer): a backlog
    builds; realtime (10 s budget) rides it out, batch (40 ms) is shed
    oldest first and counted, and the shed counts equal the futures
    that failed with ShedError. Nothing shed was ever staged."""
    cfg = SchedConfig(staleness_ms={
        "realtime": 10_000.0, "standard": 10_000.0, "batch": 40.0})
    eng = _toy("sched-flood", sched=cfg, transfer="inline")
    gate, entered = threading.Event(), threading.Event()

    def hold():
        entered.set()
        gate.wait(timeout=60)

    eng.pre_launch = hold
    shed0 = metrics.get_counter("evam_sched_shed", labels={"class": "batch"})
    try:
        first = eng.submit(priority="realtime", x=_x(1.0))
        assert entered.wait(timeout=30)
        eng.pre_launch = None
        rt = [eng.submit(priority="realtime", x=_x(2.0)) for _ in range(3)]
        bt = [eng.submit(priority="batch", x=_x(3.0)) for _ in range(8)]
        assert eng.queue_depth() >= 11
        assert eng.class_depths()["batch"] == 8
        time.sleep(0.1)
        assert eng.queue_age_s() >= 0.1
        gate.set()
        np.testing.assert_array_equal(first.result(timeout=60), _x(2.0))
        for f in rt:
            np.testing.assert_array_equal(f.result(timeout=60), _x(4.0))
        shed = 0
        for f in bt:
            try:
                f.result(timeout=60)
            except ShedError:
                shed += 1
        assert shed > 0
        assert eng.shed_counts() == {"realtime": 0, "standard": 0,
                                     "batch": shed}
        assert metrics.get_counter(
            "evam_sched_shed", labels={"class": "batch"}) == shed0 + shed
        st = eng.stats_row()
        assert st["items"] == 1 + 3 + (8 - shed)
        assert not eng.stalled.is_set()
    finally:
        gate.set()
        eng.stop()


def test_supervised_engine_passes_priority_and_keeps_shed_counts():
    cfg = SchedConfig(staleness_ms={
        "realtime": 10_000.0, "standard": 10_000.0, "batch": 1e-3})
    eng = SupervisedEngine("sup", lambda: _toy("sup", sched=cfg))
    try:
        with pytest.raises(ShedError):
            # queued 1 µs: shed at the formation filter at the latest
            eng.submit(priority="batch", x=_x(1)).result(timeout=30)
        assert eng.submit(priority="realtime", x=_x(2)).result(
            timeout=30)[0] == 4.0
        assert eng.shed_counts()["batch"] == 1
        eng._absorb_counters(eng._engine)
        assert eng.shed_counts()["batch"] == 2  # carry + live
        assert eng.class_depths() == {"realtime": 0, "standard": 0,
                                      "batch": 0}
    finally:
        eng.stop()


def test_stop_fails_every_queued_item():
    eng = _toy("sched-stop", sched=SchedConfig(), transfer="inline")
    gate, entered = threading.Event(), threading.Event()

    def hold():
        entered.set()
        gate.wait(timeout=60)

    eng.pre_launch = hold
    eng.submit(priority="realtime", x=_x(0))
    assert entered.wait(timeout=30)
    stuck = [eng.submit(priority="batch", x=_x(1)) for _ in range(3)]
    gate.set()
    eng.stop()
    for f in stuck:
        with pytest.raises((RuntimeError, ShedError)):
            f.result(timeout=10)


class _ShedEveryOther(AsyncStage):
    """An async stage whose futures fail with ShedError on odd frames
    and record the frame's priority."""

    name = "shed"

    def __init__(self):
        self.priorities = []

    def submit(self, ctx):
        self.priorities.append(ctx.priority)
        fut = Future()
        if ctx.seq % 2:
            fut.set_exception(ShedError("batch", 1.0, 0.5, "e"))
        else:
            fut.set_result(ctx.seq)
        return fut

    def complete(self, ctx, result):
        return [ctx]


def test_runner_counts_a_shed_frame_and_carries_on():
    from evam_tpu_torch.media.source import SyntheticSource

    stage = _ShedEveryOther()
    runner = StreamRunner("s", [stage], priority="batch")
    runner.run(SyntheticSource(16, 16, count=10).frames())
    assert (runner.frames_out, runner.errors, runner.shed) == (5, 5, 5)
    assert stage.priorities == ["batch"] * 10


def test_registry_stamps_priority_and_releases_the_ticket(tmp_path):
    """A start with ``priority`` realtime: every frame reaches the
    engine in that class; while it runs /scheduler counts one realtime
    stream, and its end releases the reservation."""
    from evam_tpu_torch.engine.hub import EngineHub
    from evam_tpu_torch.models.registry import ModelRegistry

    key = "object_detection/person_vehicle_bike"
    hub = EngineHub(ModelRegistry(device="cpu", dtype="float32",
                                  input_overrides={key: (64, 64)},
                                  width_overrides={key: 8},
                                  allow_random_weights=True),
                    device="cpu", max_batch=4, deadline_ms=2.0,
                    sched=SchedConfig())
    reg = port_registry.PipelineRegistry(
        Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu"),
        hub=hub)
    seen = []
    try:
        # the stage's engine, built first so its submits can be watched
        engine = hub.engine("detect", key, score_threshold=0.1)
        submit = engine._engine.submit

        def spy(priority="standard", **kw):
            seen.append(priority)
            return submit(priority=priority, **kw)

        engine._engine.submit = spy
        inst = reg.start_instance("object_detection", "person_vehicle_bike", {
            "source": {"uri": "synthetic://64x64@30?count=6", "type": "uri"},
            "destination": {"metadata": {"type": "file",
                                         "path": str(tmp_path / "o.jsonl")}},
            "priority": "realtime", "fps": 12})
        inst.wait(timeout=120)
        assert inst.status()["state"] == "COMPLETED"
        status = reg.scheduler_status()
        assert status["admitted"]["realtime"] == 1
        assert status["streams"] == {"realtime": 0, "standard": 0,
                                     "batch": 0}
        assert status["demand_fps"] == 0.0
        assert seen == ["realtime"] * 6
        assert len((tmp_path / "o.jsonl").read_text().splitlines()) == 6
    finally:
        reg.stop_all()
