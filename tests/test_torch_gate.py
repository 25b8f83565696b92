"""Slice 4 motion gate of the port against the reference, on the CPU.

* ``luma_grid``: exactly equal to ``evam_tpu.native.luma_grid`` (its
  native kernel and its numpy path) at frame sizes 1×1, 97×131,
  512×512 and 1080×1920 and grids 16×16 and 5×7, on seeded random
  frames.
* ``MotionGate.apply``: the same run/skip sequence, ``snapshot()`` and
  ``state_dict()`` as the reference's over the same score sequences
  (static, moving, slow drift, the refresh and max-skip bounds,
  hysteresis, seeded random); ``decide`` the same over the same frame
  sequences (static, moving, slow drift). Exact: no tolerance.
* ``GateConfig.from_properties``: the reference's fields under the env
  and property combinations of ``tests/test_gate.py::TestGateConfig``.
* ``DetectStage`` with a gate, on duck-typed engines that answer at
  once: the same submits, run/skip decisions and coasted boxes as the
  reference's stage, with every frame completed at once and with
  several frames in flight (the coast of a skipped frame is counted at
  its submit).
* ``person_vehicle_bike`` with ``inference-interval: "adaptive"``
  through both REST servers (``tests/test_torch_track.py``
  ``serve_both``) on the moving synthetic source, float32 and
  INT8/pallas: equal run/skip counts (the instance's ``gate`` block),
  engine items, and the same objects frame by frame, coasted boxes
  included (tolerances of ``assert_objects_equal``).
"""

from __future__ import annotations

import itertools
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from evam_tpu import native
from evam_tpu.ops import qlinear as jql
from evam_tpu.stages import gate as jgate
from evam_tpu.stages.context import FrameContext as JContext
from evam_tpu.stages.infer import DetectStage as JDetectStage
from evam_tpu_torch.media.luma import luma_grid
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.stages import gate as tgate
from evam_tpu_torch.stages.context import FrameContext
from evam_tpu_torch.stages.infer import DetectStage
from test_torch_server import native_reference  # noqa: F401 — fixture
from test_torch_track import assert_objects_equal, serve_both

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_registries():
    jgate.registry.reset()
    tgate.registry.reset()
    yield
    jgate.registry.reset()
    tgate.registry.reset()


# ---------------------------------------------------------- luma grid


@pytest.mark.parametrize("grid", [(16, 16), (5, 7)], ids=["16x16", "5x7"])
@pytest.mark.parametrize("hw", [(1, 1), (97, 131), (512, 512), (1080, 1920)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_luma_grid_equals_the_references(native_reference, monkeypatch,
                                         path, hw, grid):
    if path == "numpy":
        monkeypatch.setattr(native, "_use_native", lambda: False)
    else:
        assert native._use_native()
    rng = np.random.default_rng(hw[0] * 7 + grid[1])
    frame = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = native.luma_grid(frame, *grid)
    got = luma_grid(frame, *grid)
    assert got.dtype == np.uint8 and got.shape == grid
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- controller


def _scores(kind: str) -> list[float]:
    rng = np.random.default_rng(0)
    return {
        "static": [float("inf")] + [0.0] * 40,
        "moving": [float("inf")] + [3.0 + (i % 3) for i in range(40)],
        "drift": [float("inf")] + [0.1 * i for i in range(40)],
        "hysteresis": [float("inf"), 0.0, 3.0, 1.5, 0.5, 1.5, 2.0, 1.0,
                       1.01, 2.5, 0.99, 1.99],
        "random": [float("inf")] + rng.gamma(1.0, 1.5, 60).tolist(),
    }[kind]


#: GateConfig fields of each controller case (refresh and max-skip bounds)
_CONFIGS = {
    "default": {},
    "max_skip_4": {"max_skip": 4, "refresh": 0},
    "refresh_10": {"max_skip": 1000, "refresh": 10},
    "narrow_band": {"threshold": 1.0, "threshold_lo": 0.9, "max_skip": 3,
                    "refresh": 7},
}


def _gates(**fields):
    return (jgate.MotionGate(jgate.GateConfig(enabled=True, **fields), "e"),
            tgate.MotionGate(tgate.GateConfig(enabled=True, **fields), "e"))


@pytest.mark.parametrize("config", sorted(_CONFIGS))
@pytest.mark.parametrize("kind", ["static", "moving", "drift", "hysteresis",
                                  "random"])
def test_apply_equals_the_references(kind, config):
    ref, got = _gates(**_CONFIGS[config])
    for s in _scores(kind):
        assert got.apply(s) is ref.apply(s)
        assert got.snapshot() == ref.snapshot()
        assert got.state_dict() == ref.state_dict()
    assert got.max_consecutive_skips == ref.max_consecutive_skips


def _frames(kind: str, n: int = 40, h: int = 96, w: int = 96):
    rng = np.random.default_rng(1)
    base = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
    out = []
    for i in range(n):
        f = base.copy()
        if kind == "drift":
            f = np.clip(base.astype(np.int16) + i, 0, 255).astype(np.uint8)
        x, y = ((10, 10) if kind == "static" else
                ((i * 17) % 70, (i * 11) % 70) if kind == "moving" else
                (i % 70, 20))
        f[y:y + 24, x:x + 24] = (64, 160, 240)
        out.append(f)
    return out


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("kind", ["static", "moving", "drift"])
def test_decide_equals_the_references(kind):
    ref, got = _gates(max_skip=8, refresh=30)
    decisions = []
    for frame in _frames(kind):
        run = got.decide(frame)
        assert run is ref.decide(frame)
        assert got.last_score == ref.last_score
        decisions.append(run)
    assert got.snapshot() == ref.snapshot()
    assert got.state_dict() == ref.state_dict()
    if kind == "static":
        assert decisions.count(False) >= 30
    if kind == "moving":
        assert all(decisions)


def test_state_round_trips_and_force_refresh():
    ref, got = _gates()
    for s in _scores("random")[:20]:
        ref.apply(s)
        got.apply(s)
    ref._ref_grid = got._ref_grid = np.arange(256, dtype=np.uint8).reshape(16, 16)
    state = ref.state_dict()
    restored = tgate.MotionGate(tgate.GateConfig(enabled=True), "e")
    restored.load_state(state)
    assert restored.state_dict() == state
    for s in _scores("random")[20:]:
        assert restored.apply(s) is ref.apply(s)
    restored.load_state({"ref_grid": [[1, 2]], "moving": False})
    assert restored.state_dict()["ref_grid"] == state["ref_grid"]
    restored.force_refresh()
    assert restored.state_dict()["ref_grid"] is None
    assert restored.decide(_frames("static")[0]) is True


def test_counters_registry_and_skip_rate():
    g = tgate.maybe_gate({"inference-interval": "adaptive"}, "gate-probe")
    ran0 = metrics.get_counter("evam_gate_ran", {"engine": "gate-probe"})
    skipped0 = metrics.get_counter("evam_gate_skipped", {"engine": "gate-probe"})
    for s in _scores("static")[:10]:  # the 10th runs: max_skip 8
        g.apply(s)
    snap = g.snapshot()
    assert (snap["ran"], snap["skipped"]) == (2, 8)
    assert metrics.get_counter("evam_gate_ran", {"engine": "gate-probe"}) \
        - ran0 == 2
    assert metrics.get_counter("evam_gate_skipped", {"engine": "gate-probe"}) \
        - skipped0 == 8
    summary = tgate.registry.summary()
    assert summary == {"streams": 1, "ran": 2, "skipped": 8,
                       "skip_rate": 0.8, "skipped_fps": 1.6}
    assert g.skipped_fps(now=g._clock() + 10.0) == 0.0
    assert "evam_gate_skipped_total" in metrics.render()
    tgate.registry.reset()
    assert tgate.registry.summary()["ran"] == 0


# ------------------------------------------------------------- config

#: (env, properties) of tests/test_gate.py::TestGateConfig and around it
_CONFIG_CASES = [
    ({}, {}),
    ({}, {"inference-interval": "adaptive"}),
    ({}, {"inference-interval": " Adaptive "}),
    ({}, {"inference-interval": 3}),
    ({"EVAM_GATE": "on"}, {}),
    ({"EVAM_GATE": "1"}, {"inference-interval": 2}),
    ({"EVAM_GATE": "off"}, {"inference-interval": "adaptive"}),
    ({"EVAM_GATE": "false"}, {"inference-interval": "adaptive"}),
    ({"EVAM_GATE_MAX_SKIP": "3", "EVAM_GATE_THRESHOLD": "5.0"},
     {"inference-interval": "adaptive", "gate-max-skip": 7}),
    ({"EVAM_GATE_THRESHOLD_LO": "4.0"},
     {"inference-interval": "adaptive", "gate-threshold": 3.0}),
    ({}, {"inference-interval": "adaptive", "gate-threshold-lo": 0.5,
          "gate-max-skip": 0, "gate-refresh": -4}),
    ({"EVAM_GATE_MAX_SKIP": "x", "EVAM_GATE_REFRESH": "12"},
     {"inference-interval": "adaptive"}),
]


@pytest.mark.parametrize("env,props", _CONFIG_CASES,
                         ids=[str(i) for i in range(len(_CONFIG_CASES))])
def test_gate_config_equals_the_references(monkeypatch, env, props):
    for key in ("EVAM_GATE", "EVAM_GATE_THRESHOLD", "EVAM_GATE_THRESHOLD_LO",
                "EVAM_GATE_MAX_SKIP", "EVAM_GATE_REFRESH"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    ref = jgate.GateConfig.from_properties(dict(props))
    got = tgate.GateConfig.from_properties(dict(props))
    for field in ("enabled", "threshold", "threshold_lo", "max_skip",
                  "refresh", "pinned"):
        assert getattr(got, field) == getattr(ref, field), field
    assert (tgate.maybe_gate(dict(props)) is None) == \
        (jgate.maybe_gate(dict(props)) is None)


# ---------------------------------------------- detect stage (fakes)


class _Pre:
    height = 64
    width = 64


class _Model:
    preprocess = _Pre()
    labels = ["person", "vehicle", "bike"]


class _Engine:
    """Duck-typed BatchEngine answering every submit at once with the
    next scripted rows."""

    name = "detect:fake"

    def __init__(self, rows):
        self._rows = rows
        self.submits = 0

    def submit(self, priority="standard", **inputs) -> Future:
        self.submits += 1
        fut: Future = Future()
        fut.set_result(next(self._rows))
        return fut

    def set_example(self, **kw):
        pass


class _Hub:
    device_synth = False
    wire_format = "bgr"
    warmup = False

    def __init__(self, engine):
        self._engine = engine

    def model(self, key):
        return _Model()

    def engine(self, kind, key, instance_id=None, **kw):
        return self._engine


def _rows_moving():
    """Packed results whose one person row moves +0.05 a call in x,
    with a second one that appears and goes."""
    for k in itertools.count():
        rows = np.zeros((8, 7), np.float32)
        x0 = 0.1 + 0.05 * (k % 8)
        rows[0] = [x0, 0.1, x0 + 0.2, 0.3, 0.9, 0, 1.0]
        if k % 3:
            rows[1] = [0.5, 0.5, 0.7, 0.8, 0.6, 1, 1.0]
        yield rows


def _run(stage, ctx_cls, frames, in_flight: int):
    """Submit frames ``in_flight`` at a time, then complete them in
    order; returns each frame's boxes and whether it was skipped."""
    out, pending = [], []
    for i, f in enumerate(frames):
        ctx = ctx_cls(frame=f, pts_ns=i, seq=i, stream_id="t")
        pending.append((ctx, stage.submit(ctx)))
        if len(pending) >= in_flight or i == len(frames) - 1:
            for c, fut in pending:
                stage.complete(c, fut.result() if fut is not None else None)
                out.append(([(r.x0, r.y0, r.x1, r.y1, r.confidence,
                              r.label_id) for r in c.regions], fut is None))
            pending = []
    return out


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("in_flight", [1, 4])
@pytest.mark.parametrize("props", [
    {"inference-interval": "adaptive"},
    {"inference-interval": "adaptive", "gate-threshold": 1.0},
    {"inference-interval": "adaptive", "gate-max-skip": 2, "gate-refresh": 5},
], ids=["default", "threshold-1", "bounds"])
def test_gated_detect_stage_equals_the_references(props, in_flight):
    frames = (_frames("moving", 6) + _frames("static", 14)
              + _frames("drift", 12))
    ref_engine, got_engine = _Engine(_rows_moving()), _Engine(_rows_moving())
    ref = JDetectStage("det", "m", dict(props), _Hub(ref_engine))
    got = DetectStage("det", "m", dict(props), _Hub(got_engine))
    assert got.gate is not None
    want = _run(ref, JContext, frames, in_flight)
    have = _run(got, FrameContext, frames, in_flight)
    assert have == want
    assert got_engine.submits == ref_engine.submits == got.gate.ran
    assert got.gate.snapshot() == ref.gate.snapshot()
    assert got.gate.skipped > 0
    # skipped frames coasted: some box moved without an engine result
    assert any(skipped and boxes != have[i - 1][0]
               for i, (boxes, skipped) in enumerate(have))


@pytest.mark.usefixtures("native_reference")
def test_gate_off_serves_every_frame_as_ungated(monkeypatch):
    frames = _frames("static", 10)
    monkeypatch.setenv("EVAM_GATE", "off")
    engine = _Engine(_rows_moving())
    stage = DetectStage("det", "m", {"inference-interval": "adaptive",
                                     "gate-threshold": 0.5}, _Hub(engine))
    assert stage.gate is None and stage.interval == 1
    monkeypatch.delenv("EVAM_GATE")
    plain_engine = _Engine(_rows_moving())
    plain = DetectStage("det", "m", {}, _Hub(plain_engine))
    assert _run(stage, FrameContext, frames, 1) == \
        _run(plain, FrameContext, frames, 1)
    assert engine.submits == plain_engine.submits == 10


# ------------------------------------------------- both REST servers


@pytest.mark.usefixtures("native_reference")
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_adaptive_person_vehicle_bike_matches_the_reference(
        tmp_path, monkeypatch, dtype):
    """The moving square at 96² with gate-threshold 6: the gate runs a
    few frames and coasts the rest, up to its max-skip bound."""
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    params = {"inference-interval": "adaptive", "gate-threshold": 6.0,
              "detection-properties": {"threshold": 0.0}}
    ref, got, ref_engines, got_engines, ref_st, got_st = serve_both(
        tmp_path, dtype, "/pipelines/object_detection/person_vehicle_bike",
        params, "synthetic://96x96@30?count=12", 12)
    assert got_st["gate"] == ref_st["gate"]
    gate = got_st["gate"]["detection"]
    assert gate["ran"] + gate["skipped"] == 12
    assert gate["skipped"] > 0 and gate["max_consecutive_skips"] > 1
    (engine,) = got_engines.values()
    assert engine["items"] == gate["ran"]
    assert_objects_equal(ref, got, dtype)
    assert any(m["objects"] for m in got)
