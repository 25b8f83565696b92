"""The port's default engine (``evam_tpu_torch/engine/batcher.py``) on the
CPU: the scenarios of the reference's ``tests/test_transfer.py`` and
``tests/test_engine.py`` that its structure shares — the pipelined
transfer is the default and has a launcher thread, EVAM_TRANSFER picks
inline and an argument beats it, a bad value is refused; the slot and
legacy assemblies and both transfers give bit-identical rows; the stage
clock carries all eight stages; EVAM_SERIALIZE_COMPILE degrades
pipelined to inline under one lock; the watchdog fails stranded futures
with TimeoutError and flags ``stalled``; warmup runs each bucket once
and sets ``warmed``; a resolved row never changes when later batches
reuse the slot; and a hub built from ``Settings`` defaults serves
through a supervised slot/pipelined engine. The threads and the ring
run on the CPU exactly as on the card; the graphs do not (no card)."""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch

from evam_tpu_torch.config.settings import Settings
from evam_tpu_torch.engine import devlock
from evam_tpu_torch.engine.batcher import STAGES, BatchEngine
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.engine.supervisor import SupervisedEngine
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.ops import qgemm


def _engine(name: str, **kw) -> BatchEngine:
    kwargs = dict(
        # uint8 wrap arithmetic: elementwise and exact, so a row cannot
        # depend on the batch it rode in
        step_fn=lambda x: x * 3 + 1,
        device="cpu",
        max_batch=8,
        deadline_ms=2.0,
        input_names=("x",),
        stall_timeout_s=0,
    )
    kwargs.update(kw)
    return BatchEngine(name, **kwargs)


def _rows(n: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (6, 4), np.uint8) for _ in range(n)]


def _serve(eng, rows, timeout=30):
    futs = [eng.submit(x=r) for r in rows]
    return [f.result(timeout=timeout) for f in futs]


class TestTransferModes:
    def test_pipelined_slot_is_the_default_with_a_launcher(self):
        eng = _engine("xfer-default")
        try:
            assert (eng.transfer, eng.assembly) == ("pipelined", "slot")
            assert eng._pipelined and eng._ring is not None
            assert eng._launcher is not None and eng._launcher.is_alive()
            out = eng.submit(x=np.full((4,), 7, np.uint8)).result(timeout=30)
            np.testing.assert_array_equal(out, np.full((4,), 22))
        finally:
            eng.stop()

    def test_env_selects_inline_and_an_argument_beats_it(self, monkeypatch):
        monkeypatch.setenv("EVAM_TRANSFER", "inline")
        eng = _engine("xfer-inline-env")
        try:
            assert eng.transfer == "inline"
            assert not eng._pipelined and eng._launcher is None
            out = eng.submit(x=np.full((4,), 1, np.uint8)).result(timeout=30)
            np.testing.assert_array_equal(out, np.full((4,), 4))
        finally:
            eng.stop()
        eng = _engine("xfer-arg", transfer="pipelined")
        try:
            assert eng.transfer == "pipelined" and eng._pipelined
        finally:
            eng.stop()

    @pytest.mark.parametrize("kw,knob", [({"transfer": "sideways"},
                                          "EVAM_TRANSFER"),
                                         ({"assembly": "heap"},
                                          "EVAM_BATCH_ASSEMBLY")])
    def test_invalid_value_refused(self, kw, knob):
        with pytest.raises(ValueError, match=knob):
            _engine("xfer-bad", **kw)

    def test_slot_legacy_pipelined_inline_rows_bit_identical(self):
        rows = _rows(40, seed=3)
        results = {}
        for assembly, transfer in (("slot", "pipelined"), ("slot", "inline"),
                                   ("legacy", "inline"),
                                   ("legacy", "pipelined")):
            eng = _engine(f"xfer-ab-{assembly}-{transfer}",
                          assembly=assembly, transfer=transfer)
            try:
                results[assembly, transfer] = _serve(eng, rows)
            finally:
                eng.stop()
        want = results["legacy", "inline"]
        for key, got in results.items():
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape, key
                assert a.tobytes() == b.tobytes(), key

    def test_stage_clock_has_all_eight_stages(self):
        for transfer in ("pipelined", "inline"):
            eng = _engine(f"xfer-clock-{transfer}", transfer=transfer)
            try:
                _serve(eng, _rows(20, seed=4))
                st = eng.stats
                assert set(st.stage_seconds) == set(STAGES), transfer
                assert st.stage_seconds["h2d_issue"] >= 0.0
                if transfer == "inline":
                    assert st.stage_seconds["h2d_wait"] == 0.0
                assert set(st.stage_ms_per_batch()) == set(STAGES)
                assert set(eng.stats_row()["stage_ms"]) == set(STAGES)
            finally:
                eng.stop()

    def test_devlock_degrades_pipelined_to_inline(self, monkeypatch):
        monkeypatch.setenv("EVAM_SERIALIZE_COMPILE", "1")
        devlock.reset_stats()
        engines = [_engine(f"xfer-devlock-{i}", transfer="pipelined")
                   for i in range(2)]
        try:
            for eng in engines:
                assert eng.transfer == "pipelined"  # the request...
                assert not eng._pipelined           # ...forced inline
                assert eng._launcher is None
            outs: dict[int, list] = {}

            def serve(i):
                outs[i] = _serve(engines[i], [np.full((4,), j, np.uint8)
                                              for j in range(20)])

            threads = [threading.Thread(target=serve, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            for i in range(2):
                assert [int(o[0]) for o in outs[i]] == [
                    (j * 3 + 1) % 256 for j in range(20)]
        finally:
            for eng in engines:
                eng.stop()
        assert devlock.max_concurrent() == 1


class TestWatchdog:
    def test_stranded_futures_fail_and_stalled_is_set(self):
        gate = threading.Event()

        def wedged(x):
            gate.wait(timeout=30)
            return x

        for transfer in ("pipelined", "inline"):
            eng = _engine(f"wd-{transfer}", step_fn=wedged,
                          transfer=transfer, stall_timeout_s=0.3,
                          first_batch_grace=1.0)
            gate.clear()
            try:
                fut = eng.submit(x=np.zeros((2,), np.uint8))
                with pytest.raises(TimeoutError):
                    fut.result(timeout=15)
                assert eng.stalled.is_set()
                with pytest.raises(RuntimeError, match="stalled"):
                    eng.submit(x=np.zeros((2,), np.uint8))
                assert metrics.get_counter(
                    "evam_engine_stalls", labels={"engine": eng.name}) >= 1
                # the stalled call completes: the engine recovers
                gate.set()
                deadline = time.time() + 10
                while eng.stalled.is_set() and time.time() < deadline:
                    time.sleep(0.02)
                assert not eng.stalled.is_set()
            finally:
                gate.set()
                eng.stop()

    def test_cold_bucket_gets_the_first_batch_grace(self):
        gate = threading.Event()
        eng = _engine("wd-grace", step_fn=lambda x: (gate.wait(0.8), x)[1],
                      stall_timeout_s=0.3, first_batch_grace=10.0)
        try:
            out = eng.submit(x=np.full((2,), 5, np.uint8)).result(timeout=15)
            np.testing.assert_array_equal(out, np.full((2,), 5))
            assert not eng.stalled.is_set()
        finally:
            eng.stop()

    def test_watchdog_tick_refreshes_queue_gauges(self):
        eng = _engine("gauge-wd", deadline_ms=30_000.0, stall_timeout_s=1.0)
        try:
            for i in range(2):
                eng.submit(x=np.full((4,), i, np.uint8))
            deadline = time.time() + 5
            while time.time() < deadline and metrics.get_gauge(
                    "evam_engine_queue_depth",
                    labels={"engine": "gauge-wd"}) < 2:
                time.sleep(0.05)
            assert metrics.get_gauge("evam_engine_queue_depth",
                                     labels={"engine": "gauge-wd"}) == 2.0
            assert eng.stats.batches == 0
        finally:
            eng.stop()


class TestWarmupAndRows:
    def test_warmup_runs_each_bucket_once_and_sets_warmed(self):
        seen: list[int] = []
        lock = threading.Lock()

        def step(x):
            with lock:
                seen.append(int(x.shape[0]))
            return x.float()

        eng = _engine("warm", step_fn=step, max_batch=8)
        try:
            eng.warm_async(x=np.zeros((3,), np.uint8))
            eng.warm_async(x=np.zeros((3,), np.uint8))  # idempotent
            assert eng.warmed.wait(timeout=30)
            assert sorted(seen) == eng.buckets == [1, 2, 4, 8]
            row = eng.stats_row()
            assert row["warm_forwards"] == 4 and row["warmed"]
            # no graph on the CPU: nothing captured, nothing failed
            assert (row["graphs"], row["compiled_programs"],
                    row["capture_failures"]) == (0, 0, 0)
            assert eng.stats.batches == 0
            assert eng._buckets_done == {1, 2, 4, 8}
        finally:
            eng.stop()

    def test_warmup_without_an_example_fails_loudly(self):
        eng = _engine("warm-none")
        try:
            with pytest.raises(RuntimeError, match="example"):
                eng.warmup()
        finally:
            eng.stop()

    @pytest.mark.parametrize("assembly", ["slot", "legacy"])
    def test_resolved_row_unchanged_by_later_batches(self, assembly):
        """The step returns its input: a row that aliased the staging
        block would change when a later batch reuses the slot."""
        eng = _engine(f"rows-{assembly}", step_fn=lambda x: x,
                      assembly=assembly, staging_depth=2, max_batch=2)
        try:
            first = eng.submit(x=np.full((4,), 1, np.uint8)).result(timeout=30)
            kept = first.copy()
            for i in range(2, 12):
                eng.submit(x=np.full((4,), i, np.uint8)).result(timeout=30)
            np.testing.assert_array_equal(first, kept)
        finally:
            eng.stop()

    def test_two_inputs_stack_per_bucket(self):
        eng = _engine("two", step_fn=lambda f, b: b.sum(-1) + f.float()[:, :1],
                      input_names=("frames", "boxes"), max_units=8,
                      max_batch=4, deadline_ms=50.0)
        try:
            futs = [eng.submit(units=u, frames=np.full((2,), i, np.uint8),
                               boxes=np.full((8, 4), i, np.float32))
                    for i, u in enumerate([3, None, 1])]
            for i, f in enumerate(futs):
                np.testing.assert_array_equal(f.result(timeout=10),
                                              np.full((8,), 5.0 * i))
            st = eng.stats_row()
            assert (st["items"], st["units"]) == (3, 12)
        finally:
            eng.stop()

    def test_stop_fails_pending_and_refuses_submits(self):
        gate = threading.Event()
        eng = _engine("stop", step_fn=lambda x: (gate.wait(5), x)[1])
        futs = [eng.submit(x=np.zeros((2,), np.uint8)) for _ in range(3)]
        gate.set()
        eng.stop()
        for f in futs:
            assert f.done()
        with pytest.raises(RuntimeError, match="stopped"):
            eng.submit(x=np.zeros((2,), np.uint8))


def test_hub_from_settings_defaults_serves_supervised_slot_pipelined():
    s = Settings.from_env(env={"EVAM_PLATFORM": "cpu"})
    e = s.engine
    assert (e.warmup, e.supervise, e.stall_timeout_s, e.transfer,
            e.transfer_depth, e.batch_assembly) == (
        True, True, 120.0, "pipelined", 2, "slot")
    hub = EngineHub(ModelRegistry(device="cpu"), device="cpu", max_batch=2,
                    warmup=e.warmup, supervise=e.supervise,
                    stall_timeout_s=e.stall_timeout_s, transfer=e.transfer,
                    transfer_depth=e.transfer_depth,
                    assembly=e.batch_assembly)
    try:
        eng = hub._build("toy", lambda x: x.float() * 2, ("x",))
        hub._engines["toy"] = eng
        assert isinstance(eng, SupervisedEngine)
        live = eng._engine
        assert isinstance(live, BatchEngine)
        assert (live.assembly, live._pipelined, live.transfer_depth) == (
            "slot", True, 2)
        eng.warm_async(x=np.zeros((3,), np.uint8))
        ready = hub.readiness()
        assert ready["engines"] == 1
        assert eng.warmed.wait(timeout=30)
        assert hub.readiness()["warming"] == 0
        out = eng.submit(x=np.full((3,), 4, np.uint8)).result(timeout=30)
        np.testing.assert_array_equal(out, np.full((3,), 8.0))
        row = hub.stats()["toy"]
        assert (row["assembly"], row["transfer"], row["state"]) == (
            "slot", "pipelined", "running")
        assert set(hub.stage_summary()) == set(STAGES)
    finally:
        hub.stop()


def test_cpu_engine_never_touches_cuda(monkeypatch):
    """A CPU engine builds no stream, graph or page-locked block."""
    def boom(*a, **k):
        raise AssertionError("a CPU engine asked for CUDA")

    monkeypatch.setattr(torch.cuda, "Stream", boom)
    eng = _engine("cpu-only")
    try:
        assert eng._graphs is None and eng._compute is None
        out = eng.submit(x=np.full((4,), 2, np.uint8)).result(timeout=30)
        np.testing.assert_array_equal(out, np.full((4,), 7))
    finally:
        eng.stop()


def test_replay_counts_are_not_lost_across_threads(monkeypatch):
    """Engines replay their graphs from their own launcher threads: the
    kernel's launch counts, added per replay, lose no update."""
    monkeypatch.setattr(qgemm, "launches", 0)
    monkeypatch.setattr(qgemm, "variant_launches", {"aligned": 0, "masked": 0})
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            qgemm.count_replay({"aligned": 10, "masked": 3})
            for _ in range(500)]) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert qgemm.launches == 12 * 500 * 13
    assert qgemm.variant_launches == {"aligned": 60000, "masked": 18000}


def test_recording_takes_this_threads_calls_only(monkeypatch):
    """While a capture records (``qgemm.recording``), the thread's own
    calls are recorded, not counted; other threads count as before (the
    wrapper counts after a launch on the card, where it asks whether its
    stream is being captured; no card here)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    # the process-wide counts, restored after: later tests read them
    monkeypatch.setattr(qgemm, "launches", 0)
    monkeypatch.setattr(qgemm, "variant_launches", {"aligned": 0, "masked": 0})
    with qgemm.recording() as rec:
        qgemm._count("aligned")
        qgemm._count("masked")
        before = qgemm.launches
        other = threading.Thread(target=qgemm._count, args=("aligned",))
        other.start()
        other.join(timeout=10)
        assert qgemm.launches == before + 1
    assert rec == {"aligned": 1, "masked": 1}
