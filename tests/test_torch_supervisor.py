"""Engine supervision in the port (``evam_tpu_torch/engine/supervisor.py``):
the scenarios of the reference's ``tests/test_supervisor.py`` without
its fleet and checkpoint cases — wedge → quarantine → rebuild →
re-admission; an exhausted restart budget is the terminal ``degraded``
state; cumulative counters survive a rebuild; a dead dispatcher
triggers a rebuild; and /healthz walks the 503 ladder through the
port's REST server and back to 200.

The wedge is a stub: a launch that blocks on a host ``threading.Event``
(the engine's ``pre_launch`` seam, or a step that waits), as on the
card — nothing is broken inside device code."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.engine.supervisor import SupervisedEngine
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.server.app import App, make_server
from evam_tpu_torch.server.registry import PipelineRegistry

REPO = Path(__file__).resolve().parent.parent


class _Wedge:
    """Blocks every launch of the engines it is armed on until released."""

    def __init__(self):
        self.release = threading.Event()

    def __call__(self):
        self.release.wait(timeout=60)

    def arm(self, eng) -> None:
        eng.pre_launch = self


def _toy_factory(name: str, wedge: _Wedge | None = None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("deadline_ms", 1.0)
    kw.setdefault("stall_timeout_s", 0.5)

    def factory() -> BatchEngine:
        eng = BatchEngine(name, lambda x: x.float(), "cpu",
                          input_names=("x",), **kw)
        if wedge is not None:
            wedge.arm(eng)
        return eng

    return factory


def _wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def test_wedge_quarantine_rebuild_readmission():
    sup = SupervisedEngine("sup-rebuild", _toy_factory("sup-rebuild"),
                           max_restarts=3, restart_window_s=60.0,
                           backoff_s=0.05)
    wedge = _Wedge()
    try:
        first = sup._engine
        # a completed batch first: the wedge meets the plain budget
        sup.submit(x=np.zeros((3,), np.float32)).result(timeout=30)
        wedge.arm(first)
        fut = sup.submit(x=np.full((3,), 7.0, np.float32))
        with pytest.raises(TimeoutError):
            fut.result(timeout=15)
        _wait_for(lambda: sup.state == "running" and sup.restarts == 1,
                  msg="rebuild + re-admission")
        assert sup._engine is not first
        assert sup.last_stall_ts is not None
        assert first._stop.is_set()
        out = sup.submit(x=np.full((3,), 5.0, np.float32)).result(timeout=30)
        np.testing.assert_allclose(out, 5.0)
        assert metrics.get_counter("evam_engine_restarts",
                                   labels={"engine": "sup-rebuild"}) == 1
        assert metrics.get_gauge("evam_engine_state",
                                 labels={"engine": "sup-rebuild"}) == 0.0
    finally:
        wedge.release.set()
        sup.stop()


def test_rebuild_rewarms_from_the_example():
    sup = SupervisedEngine("sup-warm", _toy_factory("sup-warm"),
                           max_restarts=3, restart_window_s=60.0,
                           backoff_s=0.05)
    wedge = _Wedge()
    try:
        sup.warm_async(x=np.zeros((3,), np.float32))
        assert sup.warmed.wait(timeout=30)
        first = sup._engine
        wedge.arm(first)
        with pytest.raises(TimeoutError):
            sup.submit(x=np.zeros((3,), np.float32)).result(timeout=15)
        _wait_for(lambda: sup.state == "running" and sup.restarts == 1,
                  msg="rebuild")
        new = sup._engine
        assert new is not first and new.warmed.is_set()
        assert new.stats.warm_forwards == len(new.buckets)
        # the carry keeps the first engine's warm runs too
        assert sup.stats.warm_forwards == 2 * len(new.buckets)
    finally:
        wedge.release.set()
        sup.stop()


def test_budget_exhaustion_is_terminal_degraded():
    wedge = _Wedge()
    sup = SupervisedEngine("sup-budget", _toy_factory("sup-budget"),
                           max_restarts=2, restart_window_s=60.0,
                           backoff_s=0.05)
    try:
        sup.submit(x=np.zeros((3,), np.float32)).result(timeout=30)
        # every generation wedges from here on
        wedge.arm(sup._engine)
        sup._factory = _toy_factory("sup-budget", wedge)
        deadline = time.time() + 60
        while sup.state != "degraded" and time.time() < deadline:
            try:
                sup.submit(x=np.zeros((3,), np.float32))
            except (TimeoutError, RuntimeError):
                pass
            time.sleep(0.05)
        assert sup.state == "degraded"
        assert sup.restarts == 2
        assert metrics.get_counter("evam_engine_restarts",
                                   labels={"engine": "sup-budget"}) == 2
        assert metrics.get_gauge("evam_engine_state",
                                 labels={"engine": "sup-budget"}) == 2.0
        with pytest.raises(RuntimeError, match="degraded"):
            sup.submit(x=np.zeros((3,), np.float32))
    finally:
        wedge.release.set()
        sup.stop()


def test_cumulative_counters_survive_rebuild():
    sup = SupervisedEngine("sup-carry", _toy_factory("sup-carry"),
                           max_restarts=3, restart_window_s=60.0,
                           backoff_s=0.05)
    wedge = _Wedge()
    try:
        for v in range(3):
            sup.submit(x=np.full((2,), float(v), np.float32)).result(timeout=30)
        pre = sup.stats
        pre_batches, pre_items = pre.batches, pre.items
        pre_launch = pre.stage_seconds.get("launch", 0.0)
        assert pre_batches >= 1 and pre_items == 3
        wedge.arm(sup._engine)
        with pytest.raises(TimeoutError):
            sup.submit(x=np.zeros((2,), np.float32)).result(timeout=15)
        _wait_for(lambda: sup.state == "running" and sup.restarts == 1,
                  msg="rebuild")
        assert sup._engine.stats.items == 0
        assert sup.stats.batches >= pre_batches
        assert sup.stats.items >= pre_items
        assert sup.stats.stage_seconds.get("launch", 0.0) >= pre_launch
        sup.submit(x=np.zeros((2,), np.float32)).result(timeout=30)
        row = sup.stats_row()
        assert row["items"] == sup.stats.items == pre_items + 1
        assert row["restarts"] == 1 and row["state"] == "running"
    finally:
        wedge.release.set()
        sup.stop()


def test_dispatcher_death_triggers_rebuild():
    sup = SupervisedEngine("sup-dispdeath", _toy_factory("sup-dispdeath"),
                           max_restarts=3, restart_window_s=60.0,
                           backoff_s=0.05)
    try:
        eng = sup._engine

        def boom(*a, **k):
            raise RuntimeError("injected dispatcher death")

        # patched while the dispatcher waits inside the original
        # next_batch: the first submit is served, the next call dies
        eng._ring.next_batch = boom
        out = sup.submit(x=np.full((2,), 3.0, np.float32)).result(timeout=30)
        np.testing.assert_allclose(out, 3.0)
        _wait_for(lambda: not eng._dispatcher.is_alive(),
                  msg="dispatcher death")
        _wait_for(lambda: sup.state == "running" and sup.restarts == 1,
                  msg="rebuild after dispatcher death")
        out = sup.submit(x=np.full((2,), 9.0, np.float32)).result(timeout=30)
        np.testing.assert_allclose(out, 9.0)
    finally:
        sup.stop()


def _get(base: str, path: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(base + path, timeout=10) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def test_healthz_walks_the_ladder_through_the_rest_server():
    """stalled (supervision off) → 503 "stalled"; supervised: 503
    "restarting" while the rebuild runs, then 200 "ok"; an exhausted
    budget: 503 "degraded"."""
    hub = EngineHub(ModelRegistry(device="cpu"), device="cpu", max_batch=4,
                    deadline_ms=1.0, stall_timeout_s=0.5, max_restarts=1,
                    restart_window_s=60.0, restart_backoff_s=0.3)
    registry = PipelineRegistry(
        Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu"),
        hub=hub)
    server = make_server(App(registry), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    wedge = _Wedge()
    try:
        status, body = _get(base, "/healthz")
        assert (status, body["status"]) == (200, "ok")
        eng = hub._build("toy", lambda x: x.float(), ("x",))
        hub._engines["toy"] = eng
        eng.submit(x=np.zeros((2,), np.float32)).result(timeout=30)
        wedge.arm(eng._engine)
        with pytest.raises(TimeoutError):
            eng.submit(x=np.zeros((2,), np.float32)).result(timeout=15)
        seen: list[tuple[int, str]] = []
        deadline = time.time() + 25
        while time.time() < deadline:
            status, body = _get(base, "/healthz")
            seen.append((status, body["status"]))
            if (503, "restarting") in seen and status == 200:
                break
            time.sleep(0.03)
        assert (503, "restarting") in seen, seen[-5:]
        assert seen[-1] == (200, "ok"), seen[-5:]
        assert body["restarts"] == 1
        assert set(body["host_stages_ms"]) == {
            "submit_wait", "slot_write", "seal", "h2d_issue", "h2d_wait",
            "launch", "readback", "resolve"}
        row = json.loads(urllib.request.urlopen(base + "/engines").read())["toy"]
        assert (row["state"], row["restarts"]) == ("running", 1)

        # the budget (1) is spent: the next wedge is terminal
        wedge.arm(eng._engine)
        with pytest.raises(TimeoutError):
            eng.submit(x=np.zeros((2,), np.float32)).result(timeout=15)
        _wait_for(lambda: eng.state == "degraded", msg="degraded")
        status, body = _get(base, "/healthz")
        assert (status, body["status"], body["degraded"]) == (
            503, "degraded", 1)

        # supervision off: a wedge is a plain 503 "stalled"
        bare = BatchEngine("bare", lambda x: x.float(), "cpu",
                           input_names=("x",), stall_timeout_s=0.3,
                           first_batch_grace=1.0)
        hub._engines["bare"] = bare
        wedge.arm(bare)
        hub._engines.pop("toy")
        with pytest.raises(TimeoutError):
            bare.submit(x=np.zeros((2,), np.float32)).result(timeout=15)
        status, body = _get(base, "/healthz")
        assert (status, body["status"], body["stalled"]) == (
            503, "stalled", 1)
        eng.stop()
    finally:
        wedge.release.set()
        server.shutdown()
        server.server_close()
        registry.stop_all()


def test_healthz_reports_warming_while_buckets_warm():
    gate = threading.Event()
    hub = EngineHub(ModelRegistry(device="cpu"), device="cpu", max_batch=2,
                    warmup=True)
    registry = PipelineRegistry(
        Settings(pipelines_dir=str(REPO / "pipelines"), device="cpu"),
        hub=hub)
    app = App(registry)
    try:
        eng = hub._build("slow", lambda x: (gate.wait(30), x.float())[1],
                         ("x",))
        hub._engines["slow"] = eng
        eng.warm_async(x=np.zeros((2,), np.float32))
        resp = app.handle("GET", "/healthz", b"")
        assert (resp.status, json.loads(resp.body)["status"]) == (
            200, "warming")
        gate.set()
        assert eng.warmed.wait(timeout=30)
        resp = app.handle("GET", "/healthz", b"")
        assert json.loads(resp.body)["status"] == "ok"
    finally:
        gate.set()
        registry.stop_all()
