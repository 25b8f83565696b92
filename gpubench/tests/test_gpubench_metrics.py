"""The per-layer metrics' arithmetic on a small recorded profile."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from gpubench.harness import profile, readers, reckon, spec
from gpubench.harness.cell import engine_delta

FIXTURE = Path(__file__).parent / "fixtures" / "trace_small.json"


@pytest.fixture
def tl():
    return profile.reduce(json.loads(FIXTURE.read_text())["traceEvents"])


def test_the_trace_reduces_to_device_ops_and_ranges(tl):
    assert tl.seconds == pytest.approx(220e-6)
    assert len(tl.device) == 5 and len(tl.host) == 2
    assert len(tl.kernels()) == 4
    assert len(tl.kernels(readers.K1_KERNEL)) == 2
    assert profile.busy_seconds(tl) == pytest.approx(85e-6)


def test_breakdown_sums_gaps_by_the_range_that_covers_them(tl):
    b = profile.breakdown(tl)
    gaps = dict(b["idle_gaps"])
    assert gaps["evam.launch"] == pytest.approx(70e-6)
    assert gaps["gpubench.submit"] == pytest.approx(50e-6)
    assert gaps["short_gaps"] == pytest.approx(15e-6)
    ops = dict(b["device_ops"])
    assert ops["void at::native::conv_depthwise2d_forward_kernel(...)"] \
        == pytest.approx(40e-6)
    assert sum(ops.values()) == pytest.approx(85e-6)


def _ctx(tl, cfg, **kw):
    delta = {"batches": 4, "items": 400,
             "stage_seconds": {"submit_wait": 1.0, "slot_write": 0.004,
                               "launch": 0.02, "readback": 0.016},
             "bucket_batches": {128: 3, 16: 1}}
    sub = SimpleNamespace(seconds=tl.seconds, frames=2,
                          delta={**delta, "bucket_batches": {1: 1}})
    base = dict(config=cfg, traffic={}, cell="x", window_seconds=10.0,
                frames=1000, rois_per_frame=6.0, engine=delta, sub=sub,
                timeline=tl)
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers(tl):
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "pvb_detect_int8.json")
    ctx = _ctx(tl, cfg)
    assert readers.engine_host_ms(ctx) == pytest.approx(1e3 * 0.04 / 4)
    assert readers.device_ms_per_frame(ctx) == pytest.approx(1e3 * 80e-6 / 2)
    assert readers.device_idle(ctx) == pytest.approx(100 * 135 / 220)
    bound = reckon.forward_bound_seconds(cfg["layers"], 1, 1)
    assert readers.k1_roofline(ctx) == pytest.approx(
        100 * (2 / 10) * bound / 20e-6)
    assert readers.step_mfu(ctx) == pytest.approx(
        100 * 1000 * reckon.peak_seconds(cfg["layers"], "frame") / 10.0)


def test_step_mfu_counts_the_rois_a_frame_has():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "pvb_attrs_int8.json")
    ctx = SimpleNamespace(config=cfg, frames=500, window_seconds=5.0,
                          rois_per_frame=6.0)
    want = 100 * 500 * (reckon.peak_seconds(cfg["layers"], "frame")
                        + 6 * reckon.peak_seconds(cfg["layers"], "roi")) / 5
    assert readers.step_mfu(ctx) == pytest.approx(want)


def test_readers_with_nothing_to_read_return_none():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "pvb_detect_int8.json")
    empty = profile.Timeline([], [], 0.0)
    ctx = _ctx(empty, cfg, frames=0)
    for fn in (readers.device_ms_per_frame, readers.device_idle,
               readers.k1_roofline, readers.step_mfu):
        assert fn(ctx) is None
    ctx.engine = {**ctx.engine, "batches": 0}
    assert readers.engine_host_ms(ctx) is None


def test_engine_delta_takes_differences_of_cumulative_counters():
    r0 = {"batches": 10, "items": 500, "stage_ms": {"launch": 2.0},
          "bucket_batches": {"128": 3, "8": 7}}
    r1 = {"batches": 20, "items": 1780, "stage_ms": {"launch": 3.0},
          "bucket_batches": {"128": 13, "8": 7}}
    d = engine_delta(r0, r1)
    assert d["batches"] == 10 and d["items"] == 1280
    assert d["stage_seconds"]["launch"] == pytest.approx(0.06 - 0.02)
    assert d["bucket_batches"] == {128: 10}
