"""Oversize splits of the port's ``BatchEngine`` against the reference
(``tests/test_ragged.py::TestOversizeSplit``), on the CPU.

A batch formed under ``max_batch`` can outgrow the top bucket (a ladder
shrunk under the engine), and a packed class pick can outgrow the top
unit block. Both engines split such a batch in order, compute every
chunk and count the extra chunks (``EngineStats.oversize_splits``,
``evam_engine_oversize_splits``, the ``/engines`` row), and the
dispatch thread lives on.

Tolerances: the legacy case's uint8 outputs are equal to the plain
unsplit computation ``x * 2 + 1`` and to the reference's, exactly; the
packed case's float32 outputs are within 1e-6 of the plain numpy
computation and of the reference's. Every future waits at most 30 s,
so a dead dispatch thread fails the test instead of hanging the suite.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest
import torch

from evam_tpu.control import state as ref_control_state
from evam_tpu.engine.batcher import BatchEngine as RefEngine
from evam_tpu.obs.metrics import metrics as ref_metrics
from evam_tpu.sched.classes import SchedConfig as RefSchedConfig
from evam_tpu_torch.control import state as control_state
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.engine.ragged import RaggedSpec
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.sched.classes import SchedConfig
from evam_tpu_torch.server.app import App
from test_ragged import SPEC as REF_SPEC
from test_ragged import _items
from test_ragged import _ragged_step as ref_ragged_step

torch.set_num_threads(1)

TIMEOUT_S = 30
SPEC = RaggedSpec("boxes", (4,), max_units=REF_SPEC.max_units,
                  unit_budget=REF_SPEC.unit_budget)
DEADLINES = {"realtime": 1.0, "standard": 30.0, "batch": 4.0}


@pytest.fixture(autouse=True)
def _tune_off(monkeypatch):
    """Both control planes off: a live operating point would cap the
    batch the test means to form."""
    monkeypatch.delenv("EVAM_TUNE", raising=False)
    control_state.reset_cache()
    ref_control_state.reset_cache()
    yield
    control_state.reset_cache()
    ref_control_state.reset_cache()


def _ragged_step(frames, boxes, seg):
    """The port's twin of the reference test's packed step: each unit's
    box sum plus its frame's first byte, and three times that; pad rows
    zero."""
    valid = seg >= 0
    src = torch.clamp(seg, 0, frames.shape[0] - 1).long()
    s = frames[src][:, :1].float()
    a = boxes.sum(-1)[:, None] + s
    return torch.cat([a, a * 3], -1) * valid[:, None].float()


def _engines_row(eng, key: str) -> dict:
    """``eng``'s row as ``GET /engines`` serves it from a hub that
    holds it."""
    hub = EngineHub(ModelRegistry(device="cpu", allow_random_weights=True),
                    device="cpu")
    hub._engines[key] = eng
    resp = App(types.SimpleNamespace(hub=hub)).handle("GET", "/engines", b"")
    assert resp.status == 200
    return json.loads(resp.body)[key]


def _legacy_run(eng) -> list[np.ndarray]:
    """The reference test's traffic: a ladder shrunk to [2, 4] under
    max_batch 16, then 10 items in one deadline."""
    eng.buckets = [2, 4]
    futs = [eng.submit(x=np.full((3,), i, np.uint8)) for i in range(10)]
    return [np.asarray(f.result(timeout=TIMEOUT_S)) for f in futs]


def test_legacy_path_splits_past_top_bucket():
    metrics.reset()
    eng = BatchEngine(
        "rag-oversize", lambda x: x * 2 + 1, "cpu",
        max_batch=16, deadline_ms=50.0, input_names=("x",),
        stall_timeout_s=0, assembly="legacy")
    ref = RefEngine(
        "rag-oversize", lambda params, x: x * 2 + 1, None,
        max_batch=16, deadline_ms=50.0, input_names=("x",),
        stall_timeout_s=0, assembly="legacy")
    try:
        outs = _legacy_run(eng)
        ref_outs = _legacy_run(ref)
        for i, (o, r) in enumerate(zip(outs, ref_outs)):
            plain = np.full((3,), i, np.uint8) * 2 + 1
            np.testing.assert_array_equal(o, plain)
            np.testing.assert_array_equal(o, r)
        assert eng.stats.oversize_splits >= 1
        assert metrics.counter_total("evam_engine_oversize_splits") \
            == eng.stats.oversize_splits
        assert ref.stats.oversize_splits >= 1
        assert _engines_row(eng, "x:oversize")["oversize_splits"] \
            == eng.stats.oversize_splits
        assert eng._dispatcher.is_alive()
    finally:
        eng.stop()
        ref.stop()


def test_packed_unit_split_counts():
    """Sched + packed: a class pick whose units overflow the top unit
    block splits across batches and counts as oversize."""
    metrics.reset()
    ref_metrics.reset()
    eng = BatchEngine(
        "rag-unit-split", _ragged_step, "cpu", max_batch=8,
        deadline_ms=30.0, input_names=("frames", "boxes"),
        stall_timeout_s=0, ragged="packed", ragged_spec=SPEC,
        sched=SchedConfig(deadline_ms=DEADLINES), transfer="inline")
    ref = RefEngine(
        "rag-unit-split", ref_ragged_step, None, max_batch=8,
        deadline_ms=30.0, input_names=("frames", "boxes"),
        stall_timeout_s=0, ragged="packed", ragged_spec=REF_SPEC,
        sched=RefSchedConfig(deadline_ms=DEADLINES), transfer="inline")
    items = _items(8, seed=8, counts=[8])
    try:
        futs = [eng.submit(frames=f, boxes=bx) for f, bx in items]
        outs = [f.result(timeout=TIMEOUT_S) for f in futs]
        ref_futs = [ref.submit(frames=f, boxes=bx) for f, bx in items]
        ref_outs = [np.asarray(f.result(timeout=TIMEOUT_S))
                    for f in ref_futs]
        for (f, bx), o, r in zip(items, outs, ref_outs):
            a = bx.sum(-1) + np.float32(f[0])
            plain = np.stack([a, a * 3], -1)
            assert o.shape == (8, 2)
            np.testing.assert_allclose(o, plain, rtol=0, atol=1e-6)
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-6)
        assert eng.stats.oversize_splits >= 1
        assert metrics.counter_total("evam_engine_oversize_splits") \
            == eng.stats.oversize_splits
        assert ref.stats.oversize_splits >= 1
        assert _engines_row(eng, "classify:oversize")["oversize_splits"] \
            == eng.stats.oversize_splits
        assert eng._dispatcher.is_alive()
    finally:
        eng.stop()
        ref.stop()
