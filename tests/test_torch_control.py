"""The port's control plane (``evam_tpu_torch/control/``) against the
reference's (``evam_tpu/control/``), on the CPU, and its consumers in
the port: the engine's dispatch loops and ``retune``, the motion gate,
the registry.

Exact equality throughout (the controller and the state are copies):

* ``OperatingPoint``, the signal vocabulary and the off snapshot;
* ``signals()`` over the same stub hub rows (the p95 bucket deltas
  included);
* ``_propose`` and ``tick`` fed the same seeded signal sequences
  (``signals`` stubbed): the same operating points, the same action
  logs and the same pushes to the hub, with knobs pinned through the
  environment as the reference pins them (pydantic's
  ``model_fields_set``; the port's ``fields_set``);
* the gate's decisions under a ``gate_scale`` operating point, pinned
  and not.

With EVAM_TUNE, EVAM_SCHED and EVAM_RAGGED unset, ``current_op()`` is
None, the engine keeps its single queue, dense ladder and static upload
depth, and the registry runs no controller.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu.config import settings as ref_settings
from evam_tpu.control import controller as ref_controller
from evam_tpu.control import state as ref_state
from evam_tpu.stages import gate as ref_gate
from evam_tpu_torch.config import settings as port_settings
from evam_tpu_torch.control import controller, state
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.stages import gate as port_gate

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
KEY = "object_detection/person_vehicle_bike"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Settings and both TuneState memos re-read per test; no gate
    credit from an earlier test's gates."""
    for var in ("EVAM_TUNE", "EVAM_TRANSFER_DEPTH", "EVAM_MAX_BATCH",
                "EVAM_BATCH_DEADLINE_MS", "EVAM_SCHED_ADMIT_UTIL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(port_gate.registry, "skipped_fps", lambda: 0.0)
    monkeypatch.setattr(ref_gate.registry, "skipped_fps", lambda: 0.0)

    def reset():
        ref_settings.reset_settings()
        port_settings.reset_settings()
        ref_state.reset_cache()
        state.reset_cache()

    reset()
    yield
    reset()


def test_vocabulary_and_off_snapshot_are_the_references():
    assert state.ZERO_SIGNALS == ref_state.ZERO_SIGNALS
    assert state.OperatingPoint().to_dict() == \
        ref_state.OperatingPoint().to_dict()
    assert state.disabled_snapshot() == ref_state.disabled_snapshot()
    assert controller.TuneController.KNOBS == \
        ref_controller.TuneController.KNOBS
    for name in ("DEADLINE_SCALE_MAX", "DEADLINE_SCALE_MIN",
                 "DEADLINE_STEP", "GATE_SCALE_MAX", "GATE_STEP",
                 "TRANSFER_DEPTH_MAX", "ADMIT_STEP", "ADMIT_UTIL_MIN",
                 "STALENESS_FACTOR", "STALENESS_SCALE_MIN",
                 "CAPACITY_EWMA", "H2D_DEEPEN_RATIO", "H2D_SHALLOW_RATIO"):
        assert getattr(controller, name) == getattr(ref_controller, name)


class _Hub:
    """Stats rows, shed totals and a retune recorder."""

    max_batch = 128

    def __init__(self):
        self.rows: dict = {}
        self.shed: dict = {}
        self.retuned: list[dict] = []

    def stats(self):
        return self.rows

    def shed_totals(self):
        return self.shed

    def retune(self, op):
        self.retuned.append(op.to_dict())


def _pair(**cfg):
    """A controller of each package over its own stub hub, both built
    under the current environment."""
    kw = dict(enabled=True, **cfg)
    pt = controller.TuneController(
        _Hub(), state.TuneState(port_settings.TuneSettings(**kw)))
    rf = ref_controller.TuneController(
        _Hub(), ref_state.TuneState(ref_settings.TuneSettings(**kw)))
    return pt, rf


def _signals(rng) -> dict:
    sig = dict(state.ZERO_SIGNALS)
    sig.update(
        utilization=float(rng.choice([0.1, 0.45, 0.6, 0.85, 1.4])),
        queue_depth=float(rng.choice([0, 3, 200])),
        oldest_age_s=float(rng.uniform(0, 1)),
        h2d_wait_ms=float(rng.choice([0.0, 0.01, 0.5, 3.0])),
        launch_ms=float(rng.choice([0.0, 2.0, 5.0])),
        shed_delta=float(rng.choice([0, 0, 4])),
        skip_fps=float(rng.choice([0, 20])),
        batch_p95=float(rng.choice([0, 2, 8, 64])),
        capacity_fps=float(rng.choice([0.0, 300.0, 900.0])),
        demand_fps=float(rng.uniform(0, 500)))
    return sig


@pytest.mark.parametrize("seed", range(3))
def test_propose_is_the_references(seed):
    """Every law's raw proposal, over seeded signals and operating
    points."""
    rng = np.random.default_rng(seed)
    pt, rf = _pair()
    for _ in range(300):
        sig = _signals(rng)
        fields = dict(
            deadline_scale=float(rng.choice([0.5, 0.75, 1.0, 1.25, 2.0])),
            batch_cap=int(rng.choice([0, 8, 16])),
            transfer_depth=int(rng.choice([0, 2, 3, 8])),
            gate_scale=float(rng.choice([1.0, 1.5, 3.0])),
            admit_util=float(rng.choice([0.0, 0.5, 0.7])),
            capacity_fps=float(rng.choice([0.0, 500.0])),
            staleness_scale=float(rng.choice([0.25, 0.5, 1.0])))
        assert pt._propose(sig, state.OperatingPoint(**fields)) == \
            rf._propose(sig, ref_state.OperatingPoint(**fields))


_PIN_ENVS = [
    {},
    {"EVAM_TRANSFER_DEPTH": "2"},
    {"EVAM_BATCH_DEADLINE_MS": "8", "EVAM_SCHED_ADMIT_UTIL": "0.85",
     "EVAM_MAX_BATCH": "128"},
    {"EVAM_SCHED_STALENESS_MS_BATCH": "5000",
     "EVAM_SCHED_CAPACITY_FPS": "0"},
]


@pytest.mark.parametrize("env", _PIN_ENVS, ids=["none", "transfer-depth",
                                                "deadline-admit-batch",
                                                "staleness-capacity"])
@pytest.mark.parametrize("seed", range(2))
def test_ticks_give_the_references_points_and_actions(env, seed,
                                                      monkeypatch):
    """Seeded signal sequences through ``tick``: damping, cooldown and
    the environment's pins give the same operating point after every
    tick, the same action log (ticks, knobs, values, reasons) and the
    same pushes to the hub."""
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    rng = np.random.default_rng(seed)
    pt, rf = _pair(damping=2, cooldown=1)
    assert pt.pins == rf.pins
    assert (pt.static_transfer_depth, pt.static_admit_util, pt.max_batch) \
        == (rf.static_transfer_depth, rf.static_admit_util, rf.max_batch)
    for _ in range(60):
        # runs of one regime, so damping lets actions through
        sig = _signals(rng)
        for _ in range(int(rng.integers(1, 5))):
            pt.signals = rf.signals = lambda s=sig: dict(s)
            assert pt.tick() == rf.tick()
            assert pt.state.op.to_dict() == rf.state.op.to_dict()
    got, want = pt.state.snapshot(), rf.state.snapshot()
    assert got == want and got["ticks"] > 0
    assert pt.hub.retuned == rf.hub.retuned
    actions = {a["knob"] for a in got["actions"]}
    assert actions  # the sequences move knobs
    assert not actions & {k for k, pinned in pt.pins.items() if pinned}


def test_signals_are_the_references():
    """The same stats rows (and their per-bucket dispatch counts growing
    tick by tick) read as the same signals."""
    pt, rf = _pair()
    rng = np.random.default_rng(4)
    counts = {"1": 0, "8": 0, "32": 0}
    for _ in range(6):
        for b in counts:
            counts[b] += int(rng.integers(0, 20))
        rows = {f"e{i}": {
            "batches": int(rng.integers(0, 100)),
            "stage_ms": {"h2d_wait": float(rng.uniform(0, 2)),
                         "launch": float(rng.uniform(0, 9))},
            "queue_depth": int(rng.integers(0, 9)),
            "queue_age_s": float(rng.uniform(0, 1)),
            "bucket_batches": dict(counts)} for i in range(2)}
        shed = {"batch": int(rng.integers(0, 50))}
        for c in (pt, rf):
            c.hub.rows, c.hub.shed = rows, shed
        assert pt.signals() == rf.signals()


@pytest.mark.parametrize("scale", [1.0, 2.0, 3.0])
@pytest.mark.parametrize("pinned", [False, True])
def test_gate_under_gate_scale_decides_as_the_reference(monkeypatch, scale,
                                                        pinned):
    """Both packages' live operating point set to a ``gate_scale``: the
    same score sequence gives the same run/skip decisions, and a pinned
    gate ignores the scale."""
    for mod, settings in ((state, port_settings), (ref_state, ref_settings)):
        st = mod.TuneState(settings.TuneSettings(enabled=True))
        st.op = mod.OperatingPoint(gate_scale=scale)
        monkeypatch.setattr(mod, "_resolved", (st,))
    fields = dict(enabled=True, threshold=2.0, threshold_lo=1.0,
                  max_skip=8, refresh=30, pinned=pinned)
    port = port_gate.MotionGate(port_gate.GateConfig(**fields), "e")
    ref = ref_gate.MotionGate(ref_gate.GateConfig(**fields), "e")
    rng = np.random.default_rng(int(10 * scale) + pinned)
    scores = [float("inf")] + rng.uniform(0, 7, 200).tolist()
    decisions = [port.apply(s) for s in scores]
    assert decisions == [ref.apply(s) for s in scores]
    assert 0 < sum(decisions) < len(decisions)
    if scale != 1.0 and not pinned:
        plain = port_gate.MotionGate(port_gate.GateConfig(
            **{**fields, "pinned": True}), "e")
        assert [plain.apply(s) for s in scores] != decisions


# -------------------------------------------------- consumers in the port


def _toy(**kw) -> BatchEngine:
    kw.setdefault("max_batch", 8)
    kw.setdefault("deadline_ms", 50.0)
    return BatchEngine("toy", lambda x: x + 1.0, "cpu", input_names=("x",),
                       stall_timeout_s=0, **kw)


def test_knobs_off_leave_the_engine_as_it_was():
    assert state.current_op() is None
    eng = _toy()
    try:
        assert (eng.ragged, eng.sched, eng._classq) == ("off", None, None)
        assert eng.buckets == [1, 2, 4, 8]
        assert eng._step_inputs == ("x",)
        assert eng.transfer_depth == 2 and eng._upload_q.maxsize == 2
        row = eng.stats_row()
        assert (row["ragged"], row["sched_queues"]) == ("off", {})
        out = [eng.submit(x=np.full((2,), i, np.float32)) for i in range(5)]
        for i, f in enumerate(out):
            np.testing.assert_array_equal(f.result(timeout=30), i + 1.0)
    finally:
        eng.stop()
    # ragged packing and the control plane are off by default in both
    # packages; the scheduler is on in both
    settings = port_settings.Settings.from_env(env={})
    assert (settings.engine.ragged, settings.sched.enabled,
            settings.tune.enabled) == (
        "off", ref_settings.SchedSettings().enabled, False)
    assert settings.sched.enabled is True


def test_operating_point_reaches_the_engine(monkeypatch):
    """The live point's upload depth at construction, ``retune``
    resizing the queue live, and the batch cap on the legacy loop."""
    st = state.TuneState(port_settings.TuneSettings(enabled=True))
    st.op = state.OperatingPoint(transfer_depth=5, batch_cap=2)
    monkeypatch.setattr(state, "_resolved", (st,))
    eng = _toy(assembly="legacy", transfer="inline")
    try:
        assert eng.transfer_depth == 5 and eng._upload_q.maxsize == 5
        eng.retune(state.OperatingPoint(transfer_depth=3))
        assert eng.transfer_depth == 3 and eng._upload_q.maxsize == 3
        eng.retune(state.OperatingPoint())  # 0: no change
        assert eng._upload_q.maxsize == 3
        futs = [eng.submit(x=np.full((2,), i, np.float32)) for i in range(6)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=30), i + 1.0)
        assert max(int(b) for b in eng.stats_row()["bucket_batches"]) <= 2
    finally:
        eng.stop()


def test_registry_runs_the_controller_with_tune_on(monkeypatch):
    """EVAM_TUNE on: the registry starts the controller, /scheduler's
    tuning block counts its ticks, a pinned EVAM_TRANSFER_DEPTH stays
    neutral, the hub receives every operating point, and stop_all stops
    the controller. Off: no controller."""
    from evam_tpu_torch.engine.hub import EngineHub
    from evam_tpu_torch.models.registry import ModelRegistry
    from evam_tpu_torch.server.registry import PipelineRegistry

    def build():
        hub = EngineHub(ModelRegistry(device="cpu", dtype="float32",
                                      input_overrides={KEY: (64, 64)},
                                      width_overrides={KEY: 8},
                                      allow_random_weights=True),
                        device="cpu", max_batch=4)
        return PipelineRegistry(port_settings.Settings(
            pipelines_dir=str(REPO / "pipelines"), device="cpu"), hub=hub)

    reg = build()
    assert reg.tuner is None
    assert reg.scheduler_status()["tuning"] == state.disabled_snapshot()
    reg.stop_all()

    monkeypatch.setenv("EVAM_TUNE", "1")
    monkeypatch.setenv("EVAM_TUNE_INTERVAL_S", "0.05")
    monkeypatch.setenv("EVAM_TUNE_DAMPING", "1")
    monkeypatch.setenv("EVAM_TRANSFER_DEPTH", "2")
    port_settings.reset_settings()
    state.reset_cache()
    reg = build()
    try:
        assert reg.tuner is not None and reg.tuner.pins["transfer_depth"]
        pushed = []
        reg.hub.retune = pushed.append
        deadline = time.time() + 30
        while reg.scheduler_status()["tuning"]["ticks"] < 3:
            assert time.time() < deadline
            time.sleep(0.05)
        tuning = reg.scheduler_status()["tuning"]
        assert tuning["enabled"] is True
        assert tuning["operating_point"]["transfer_depth"] == 0
        assert all(a["knob"] != "transfer_depth" for a in tuning["actions"])
        assert all(a["reason"] for a in tuning["actions"])
        assert pushed and pushed[-1] is state.current_op()
    finally:
        reg.stop_all()
    assert reg.tuner._thread is None
