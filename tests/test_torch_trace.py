"""The port's tracing layer (``evam_tpu_torch/obs/trace.py``) against the
reference's (``evam_tpu/obs/trace.py``), and its hooks in the port's
engine, on the CPU.

* ``STAGE_ORDER`` equals the port's ``ringbuf.STAGES`` and the
  reference's; ``PENDING_MAX`` is the reference's.
* Fed the same calls under a patched clock (mint, spans, finish with
  ok / error / shed / deadline_miss, slow frames; batch records begun,
  completed ok or with an error, or left pending), the reference's
  ``TraceRing`` and the port's keep the same frames and batch records
  and render the same ``chrome_trace_events``, for several sampling
  settings (trace ids mapped to their mint order: their prefix is per
  process).
* ``tools/trace_dump.py`` (the reference's tool) reads the port's
  ``/traces`` payload (``convert``) and its flight artifact
  (``events_from_flight``), and links every complete batch
  (``linked_batches``) as it does the reference's.
* ``flight_dump`` writes the reference's rows, and rotates its
  directory under the same caps.
* The port's engine on the CPU: each batch's record is completed
  exactly once on every exit — resolved (ok), a failing step (error), a
  quarantine (abandoned, the woken launcher adding nothing); with
  EVAM_FAULT_INJECT ``wedge=1,wedge_n=1`` a supervised engine's first
  batch wedges, the watchdog trips, the supervisor writes one flight
  artifact whose pending batch row stops at ``h2d_wait`` (the wedge
  sits at the launch), and the rebuilt engine serves.
* PROFILING_MODE: a ``torch.profiler`` capture of a served batch shows
  the ``evam.<stage>`` ranges of the engine's threads.
* Trace on against off: the metadata a pipeline publishes is equal.
"""

from __future__ import annotations

import importlib.util
import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from evam_tpu.obs import trace as ref_trace
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.ringbuf import STAGES
from evam_tpu_torch.engine.supervisor import SupervisedEngine
from evam_tpu_torch.obs import faults as port_faults
from evam_tpu_torch.obs import trace as port_trace

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((REPO / "tests" / "golden" / "route_traces.json")
                    .read_text())


def _trace_dump():
    spec = importlib.util.spec_from_file_location(
        "trace_dump", REPO / "tools" / "trace_dump.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Clock:
    """perf_counter and time of a module's ``time``, scripted."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self) -> float:
        return self.t

    def time(self) -> float:
        return 1.7e9 + self.t


class _Item:
    def __init__(self, trace, t_submit, priority):
        self.trace, self.t_submit, self.priority = trace, t_submit, priority


STATUS = {3: "error", 5: "shed", 6: "deadline_miss"}


def _drive(mod, ring, clock, n: int = 36) -> list:
    """The scripted calls; returns the minted frame traces in order."""
    minted = []
    for i in range(n):
        clock.t = 1000.0 + 0.5 * i
        ft = ring.mint(f"s{i % 3}", i, ("realtime", "standard", "batch")[i % 3])
        ft.add_span("decode", clock.t - 0.002, 0.002)
        ft.add_span("stage.detect", clock.t, 0.001, {"k": i})
        minted.append(ft)
    for k in range(0, n, 3):
        members = minted[k:k + 3]
        items = [_Item(ft, ft.t0 + 0.001, ft.priority) for ft in members]
        clock.t = members[0].t0 + 0.004
        clk = {"submit_wait": 0.004, "slot_write": 0.0005, "seal": 0.0002,
               "h2d_issue": 0.001}
        ring.batch_begin("detect:m", k // 3, items, 4, len(items), clk, "cpu")
        clk["h2d_wait"] = 0.0003
        if k // 3 % 4 == 3:
            continue  # left pending: its record reads the clock so far
        clk["launch"] = 0.002
        clock.t += 0.005
        ring.batch_complete("detect:m", k // 3, items,
                            status="error" if k // 3 % 4 == 2 else "ok",
                            readback_s=0.001, resolve_s=0.0002)
    for i, ft in enumerate(minted):
        clock.t = ft.t0 + (0.3 if i % 9 == 4 else 0.01)
        ring.finish(ft, STATUS.get(i % 7, "ok"))
    return minted


def _norm(obj, ids: dict):
    """``obj`` with every trace id replaced by its mint index."""
    if isinstance(obj, dict):
        return {k: _norm(v, ids) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_norm(v, ids) for v in obj]
    if isinstance(obj, str) and obj in ids:
        return f"trace-{ids[obj]}"
    return obj


def _run(mod, monkeypatch, **ring_kw):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    ring = mod.TraceRing(**ring_kw)
    minted = _drive(mod, ring, clock)
    ids = {ft.trace_id: i for i, ft in enumerate(minted)}
    frames, done, pending = ring.snapshot()
    return ring, clock, ids, frames, done, pending


def _view(ring, ids, frames, done, pending, mod) -> dict:
    return _norm({
        "frames": [ft.to_dict() for ft in frames],
        "done": [{k: v for k, v in r.items() if k != "clock"} for r in done],
        "pending": [{k: v for k, v in r.items() if k != "clock"}
                    for r in pending],
        "pending_stages": [mod._clock_stages(r["clock"]) for r in pending],
        "counts": (ring.retained_count, ring.dropped_count),
        "events": mod.chrome_trace_events(frames, done + pending),
    }, ids)


def test_stage_order_equals_the_engines_and_the_references():
    assert port_trace.STAGE_ORDER == STAGES == ref_trace.STAGE_ORDER
    assert port_trace.TraceRing.PENDING_MAX == ref_trace.TraceRing.PENDING_MAX


@pytest.mark.parametrize("ring_kw", [
    {}, {"sample_n": 1}, {"sample_n": 4, "slow_ms": 5.0},
    {"sample_n": 7, "ring": 5},
], ids=["defaults", "keep-all", "slow-5ms", "small-ring"])
def test_ring_keeps_and_renders_as_the_reference(ring_kw, monkeypatch):
    views = []
    for mod in (ref_trace, port_trace):
        ring, _, ids, frames, done, pending = _run(mod, monkeypatch,
                                                   **ring_kw)
        views.append(_view(ring, ids, frames, done, pending, mod))
    want, got = views
    assert got == want
    assert want["frames"] and want["done"] and want["pending"]
    reasons = {f["status"] for f in want["frames"]}
    assert {"error", "shed", "deadline_miss"} <= reasons


def test_traces_payload_and_trace_dump_read_the_port(monkeypatch, tmp_path):
    tool = _trace_dump()
    counts = {}
    for mod in (ref_trace, port_trace):
        ring, _, _, frames, done, pending = _run(
            mod, monkeypatch, sample_n=1, flight_dir=str(tmp_path / mod.__name__))
        monkeypatch.setattr(mod, "_resolved", (ring,))
        payload = mod.traces_payload()
        shape = {k: type(v).__name__ for k, v in payload.items()}
        golden = {k: "list" if isinstance(v, list)
                  else {"<num>": "int", "<bool>": "bool"}[v]
                  for k, v in GOLDEN.items()}
        assert shape == golden
        body = tool.convert(json.loads(json.dumps(payload)))
        assert body["traceEvents"] == payload["traceEvents"]
        path = mod.flight_dump("detect:m", "stall watchdog fired",
                               state={"outstanding": 1})
        rows = [json.loads(x) for x in Path(path).read_text().splitlines()]
        events = tool.events_from_flight(rows)
        counts[mod] = (tool.linked_batches(body["traceEvents"]),
                       tool.linked_batches(events),
                       [r.get("last_stage") for r in rows
                        if r["type"] == "batch"])
    assert counts[port_trace] == counts[ref_trace]
    linked, linked_flight, last = counts[port_trace]
    assert linked == linked_flight == 9  # every complete batch links
    assert "h2d_wait" in last  # the pending batches stop there


def test_flight_rows_and_rotation_equal_the_references(monkeypatch, tmp_path):
    out = {}
    for mod in (ref_trace, port_trace):
        d = tmp_path / mod.__name__
        ring, clock, ids, *_ = _run(mod, monkeypatch, sample_n=2,
                                    flight_dir=str(d), flight_n=5,
                                    flight_max_files=2, flight_max_bytes=0)
        monkeypatch.setattr(mod, "_resolved", (ring,))
        paths = []
        for k in range(4):
            clock.t += 1.0
            paths.append(mod.flight_dump(f"detect:m/{k}", "quarantine",
                                         state={"k": k}))
        kept = sorted(p.name for p in d.iterdir())
        rows = [_norm(json.loads(x), ids)
                for x in Path(paths[-1]).read_text().splitlines()]
        ring.flight_max_bytes = 1  # every older dump is over the cap
        last = mod.flight_dump("detect:m/last", "degraded", state={})
        out[mod] = (len(kept), Path(paths[-1]).name in kept, rows,
                    [p.name for p in d.iterdir()] == [Path(last).name])
    assert out[port_trace] == out[ref_trace]
    n_kept, newest_kept, rows, only_last = out[port_trace]
    assert n_kept == 2 and newest_kept and only_last
    assert rows[0]["type"] == "flight" and rows[0]["profiler_running"] is False
    assert sum(r["type"] == "batch" for r in rows) == 5
    assert sum(r["type"] == "frame" for r in rows) == 5


# --------------------------------------------------- the port's engine


@pytest.fixture
def ring(monkeypatch):
    """A fresh keep-everything ring as the process's ring."""
    ring = port_trace.TraceRing(sample_n=1)
    monkeypatch.setattr(port_trace, "_resolved", (ring,))
    yield ring
    port_trace.reset_cache()


def _engine(name: str, step=lambda x: x.float() * 2, **kw) -> BatchEngine:
    kw.setdefault("max_batch", 4)
    kw.setdefault("deadline_ms", 30.0)
    kw.setdefault("stall_timeout_s", 0)
    return BatchEngine(name, step, "cpu", input_names=("x",), **kw)


def _records(ring, engine: str) -> tuple[list, list]:
    _, done, pending = ring.snapshot()
    return ([r for r in done if r["engine"] == engine],
            [r for r in pending if r["engine"] == engine])


def _wait_for(cond, timeout=20.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


@pytest.mark.parametrize("transfer", ["pipelined", "inline"])
def test_every_batch_completes_once(ring, transfer):
    eng = _engine(f"trace-ok-{transfer}", transfer=transfer)
    try:
        fts = [ring.mint("s", i, "standard") for i in range(6)]
        futs = [eng.submit(trace=ft, x=np.full((3,), float(i), np.float32))
                for i, ft in enumerate(fts)]
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(timeout=20), 2.0 * i)
        _wait_for(lambda: not _records(ring, eng.name)[1], msg="retired")
        done, pending = _records(ring, eng.name)
        assert len(done) == eng.stats.batches and not pending
        assert sorted(t for r in done for t in r["frames"]) == \
            sorted(ft.trace_id for ft in fts)
        for r in done:
            assert r["status"] == "ok" and r["device"] == "cpu"
            assert set(r["stages"]) == set(STAGES)
            assert "launch" not in r  # the CPU's launch is the step itself
        for ft in fts:
            names = [s[0] for s in ft.spans]
            assert names.count("engine.dispatch") == 1
            assert names.count("sched.queue_wait") == 1
    finally:
        eng.stop()


def test_a_failing_step_completes_its_batch_as_an_error(ring):
    def boom(x):
        raise RuntimeError("step failed")

    eng = _engine("trace-err", step=boom)
    try:
        ft = ring.mint("s", 0, "standard")
        with pytest.raises(RuntimeError, match="step failed"):
            eng.submit(trace=ft, x=np.zeros((3,), np.float32)).result(20)
        done, pending = _records(ring, eng.name)
        assert [r["status"] for r in done] == ["error"] and not pending
        assert [s[0] for s in ft.spans].count("engine.dispatch") == 1
    finally:
        eng.stop()


def test_an_abandoned_batch_completes_once(ring):
    """A stub wedge holds the launch; the pending record reads the clock
    so far; abandon() retires it as abandoned, and the woken launcher
    adds nothing."""
    release = threading.Event()
    eng = _engine("trace-abandon")
    eng.pre_launch = lambda: release.wait(30)
    ft = ring.mint("s", 0, "standard")
    fut = eng.submit(trace=ft, x=np.zeros((3,), np.float32))
    _wait_for(lambda: _records(ring, eng.name)[1], msg="pending record")
    (rec,) = _records(ring, eng.name)[1]
    assert port_trace.last_stage(port_trace._clock_stages(rec["clock"])) \
        == "h2d_issue"
    _wait_for(lambda: eng._outstanding, msg="launch")
    eng.abandon()
    with pytest.raises(TimeoutError):
        fut.result(5)
    release.set()
    eng._launcher.join(10)
    done, pending = _records(ring, eng.name)
    assert [r["status"] for r in done] == ["abandoned"] and not pending
    assert [s[0] for s in ft.spans].count("engine.dispatch") == 1


def test_injected_wedge_leaves_a_flight_artifact(ring, monkeypatch, tmp_path):
    ring.flight_dir = str(tmp_path)
    monkeypatch.setenv("EVAM_FAULT_INJECT", "wedge=1,wedge_n=1,wedge_s=2")
    monkeypatch.setenv("EVAM_FAULT_SEED", "7")
    port_faults.reset_cache()
    sup = SupervisedEngine(
        "trace-wedge",
        lambda: _engine("trace-wedge", deadline_ms=1.0, stall_timeout_s=0.4,
                        first_batch_grace=1.0),
        max_restarts=3, restart_window_s=60.0, backoff_s=0.05)
    try:
        with pytest.raises(TimeoutError):
            sup.submit(x=np.zeros((3,), np.float32)).result(timeout=20)
        _wait_for(lambda: sup.restarts == 1 and sup.state == "running",
                  msg="rebuild")
        (path,) = tmp_path.iterdir()
        assert sup.last_flight == str(path)
        rows = [json.loads(x) for x in path.read_text().splitlines()]
        assert rows[0]["reason"] == "stall watchdog fired"
        assert rows[0]["state"]["outstanding"] == 1
        (wedged,) = [r for r in rows if r["type"] == "batch" and r["pending"]]
        assert wedged["last_stage"] == "h2d_wait"
        out = sup.submit(x=np.full((3,), 4.0, np.float32)).result(timeout=20)
        np.testing.assert_allclose(out, 8.0)
    finally:
        sup.stop()
        port_faults.reset_cache()


def test_profiling_mode_shows_the_stage_ranges(ring):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    port_trace.maybe_start_profiler(True)
    assert port_trace.profiler_running()
    eng = _engine("trace-prof")
    try:
        with profile(activities=[ProfilerActivity.CPU],
                     experimental_config=_ExperimentalConfig(
                         profile_all_threads=True)) as prof:
            # the second batch's submit_wait opens and closes inside
            # the capture
            for _ in range(2):
                eng.submit(x=np.zeros((3,), np.float32)).result(timeout=20)
        names = {e.key for e in prof.key_averages()}
        want = {f"evam.{s}" for s in ("submit_wait", "slot_write", "seal",
                                      "h2d_issue", "h2d_wait", "launch",
                                      "readback", "resolve")} | {"evam.step"}
        assert want <= names, sorted(n for n in names if "evam" in n)
    finally:
        port_trace.stop_profiler()
        eng.stop()
    assert port_trace.prof_range("launch") is port_trace._NO_RANGE


def test_trace_on_and_off_publish_equal_metadata(monkeypatch):
    """person_vehicle_bike's stages served to two streams with EVAM_TRACE
    on and off: the same metadata, bit for bit; the ring holds the
    frames of the run with tracing on."""
    from evam_tpu_torch.config.settings import reset_settings
    from evam_tpu_torch.engine.hub import EngineHub
    from evam_tpu_torch.graph import PipelineLoader, resolve_parameters
    from evam_tpu_torch.media.source import SyntheticSource
    from evam_tpu_torch.models.registry import ModelRegistry
    from evam_tpu_torch.stages.build import build_stages
    from evam_tpu_torch.stages.runner import StreamRunner

    key = "object_detection/person_vehicle_bike"
    registry = ModelRegistry(device="cpu", allow_random_weights=True,
                             input_overrides={key: (64, 64)},
                             width_overrides={key: 8})
    spec = PipelineLoader(REPO / "pipelines").get(*key.split("/"))
    stage_specs, _ = resolve_parameters(spec, {"threshold": 0.2})
    runs = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("EVAM_TRACE", mode)
        monkeypatch.setenv("EVAM_TRACE_SAMPLE_N", "1")
        reset_settings()
        port_trace.reset_cache()
        hub = EngineHub(registry, device="cpu", max_batch=4, deadline_ms=5.0)
        published: dict = {}
        try:
            threads = []
            for s in range(2):
                uri = f"synthetic://64x64@30?count=6&seed={s}"
                stages = build_stages(
                    stage_specs, hub, source_uri=uri,
                    publish_fn=lambda ctx: published.setdefault(
                        ctx.stream_id, []).append(json.dumps(ctx.metadata)))
                runner = StreamRunner(f"s{s}", stages, uri)
                src = SyntheticSource.from_uri(uri)
                threads.append(threading.Thread(target=runner.run,
                                                args=(src.frames(),)))
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            hub.stop()
        ring_now = port_trace.active()
        runs[mode] = (published, ring_now.retained_count if ring_now else None)
    port_trace.reset_cache()
    monkeypatch.delenv("EVAM_TRACE")
    monkeypatch.delenv("EVAM_TRACE_SAMPLE_N")
    reset_settings()
    assert runs["1"][0] == runs["0"][0]
    assert len(runs["1"][0]["s0"]) == 6
    assert runs["0"][1] is None and runs["1"][1] == 12
