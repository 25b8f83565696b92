"""Ragged packing of the port (``evam_tpu_torch/engine/ragged.py``, the
packed ``SlotRing``, ``build_classify_step_ragged``, the packed engine
and ``ClassifyStage``) against the reference, on the CPU.

Tolerances:

* ``consolidate_buckets`` and ``unit_rows``: equal on every ladder up to
  256;
* the packed ring, through ``write``/``next_batch`` and through
  ``stage_direct``: byte-equal sealed blocks, ``seg``, ``row_len``,
  ``row_offset``, buckets, unit rows and items (the ring is a copy);
* the packed classify step against the reference's **dense**
  ``build_classify_step`` on the same frames and boxes (the reference's
  own packed step is not an oracle: its packed and dense programs differ
  by 1–2 float32 ulp): float32 atol 1e-5 on every real unit (the
  classify tolerance of ``tests/test_torch_classify.py``), INT8/pallas
  atol 2e-2 (bf16 activations); pad rows exactly zero;
* ``ClassifyStage`` through the port's hub, packed against dense, fill
  levels 0, 1, 2, 5 and 8: the same attribute labels, confidences
  within the step tolerance above, and no submit for zero regions.
"""

from __future__ import annotations

from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from evam_tpu.engine import ragged as jragged
from evam_tpu.engine import steps as jsteps
from evam_tpu.engine.ringbuf import SlotRing as RefRing
from evam_tpu.models.registry import ModelRegistry as JaxRegistry
from evam_tpu.ops import qlinear as jql
from evam_tpu_torch.control import state as control_state
from evam_tpu_torch.engine import ragged as tragged
from evam_tpu_torch.engine import steps as tsteps
from evam_tpu_torch.engine.batcher import BatchEngine
from evam_tpu_torch.engine.hub import EngineHub
from evam_tpu_torch.engine.ringbuf import SlotRing
from evam_tpu_torch.models.convert import params_from_jax
from evam_tpu_torch.models.registry import ModelRegistry
from evam_tpu_torch.models.zoo.layers import quantize_model
from evam_tpu_torch.ops import color as tcolor
from evam_tpu_torch.ops import qlinear as tql
from evam_tpu_torch.stages.context import FrameContext, Region
from evam_tpu_torch.stages.infer import ClassifyStage

torch.set_num_threads(1)
CLS = "object_classification/vehicle_attributes"
SMALL = dict(width_overrides={CLS: 8}, allow_random_weights=True)


@pytest.fixture(autouse=True)
def _tune_off(monkeypatch):
    monkeypatch.delenv("EVAM_TUNE", raising=False)
    control_state.reset_cache()
    yield
    control_state.reset_cache()


# ------------------------------------------------- ladder and unit rows


def _ladder(top: int) -> list[int]:
    """The engine's ladder for max_batch ``top``."""
    out, b = [], 1
    while b < top:
        out.append(b)
        b *= 2
    return out + [top]


@pytest.mark.parametrize("align", [1, 2, 4, 8])
def test_consolidate_buckets_equals_the_references(align):
    for top in range(1, 257):
        ladder = _ladder(top)
        assert tragged.consolidate_buckets(ladder, align) == \
            jragged.consolidate_buckets(ladder, align), (top, align)
    assert tragged.consolidate_buckets(_ladder(128)) == [1, 2, 8, 32, 128]


def test_unit_rows_and_modes_equal_the_references():
    for max_units in (1, 4, 8, 16):
        for budget in (1, 2, 4, 8):
            t = tragged.RaggedSpec("boxes", (4,), max_units=max_units,
                                   unit_budget=budget)
            j = jragged.RaggedSpec("boxes", (4,), max_units=max_units,
                                   unit_budget=budget)
            assert [t.unit_rows(b) for b in range(1, 257)] == \
                [j.unit_rows(b) for b in range(1, 257)]
    assert tragged.RAGGED_MODES == jragged.RAGGED_MODES
    assert tragged.ragged_mode(None) == "off"
    assert tragged.ragged_mode("packed") == "packed"
    with pytest.raises(ValueError) as p_exc:
        tragged.ragged_mode("dense")
    with pytest.raises(ValueError) as r_exc:
        jragged.ragged_mode("dense")
    assert str(p_exc.value) == str(r_exc.value)


# ------------------------------------------------------ the packed ring

LADDER = [1, 2, 8]


def _specs(budget: int = 4):
    return (tragged.RaggedSpec("boxes", (4,), max_units=8,
                               unit_budget=budget),
            jragged.RaggedSpec("boxes", (4,), max_units=8,
                               unit_budget=budget))


def _bucket_fn(spec):
    def fn(n, units):
        for b in LADDER:
            if n <= b and units <= spec.unit_rows(b):
                return b
        return LADDER[-1]
    return fn


class _Item:
    """A work item with a future (stage_direct fails a bad row's)."""

    def __init__(self, i: int):
        self.i = i
        self.future = Future()

    def __eq__(self, other):
        return isinstance(other, _Item) and other.i == self.i

    def __repr__(self):
        return f"item{self.i}"


def _inputs(rng, i: int, k: int) -> dict[str, np.ndarray]:
    return {"frames": rng.integers(0, 255, (6, 4), np.uint8),
            "boxes": (rng.random((k, 4), dtype=np.float32) + i)}


def _sealed(sealed) -> tuple:
    return (sealed.n, sealed.bucket, sealed.units, sealed.unit_rows,
            [it.i for it in sealed.items],
            sealed.row_len.tolist(), sealed.row_offset.tolist(),
            {k: (v.shape, v.dtype.str, v.tobytes())
             for k, v in sealed.arrays.items()})


def _groups(seed: int) -> list[list[int]]:
    """Seeded region counts per item, in groups of at most 8 items."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 9, rng.integers(1, 9)).tolist()
            for _ in range(6)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_packed_ring_seals_byte_equal_blocks(seed):
    """Seeded writes of 0..8 boxes each through rings of capacity 8
    (unit block 32 rows): every sealed batch equals the reference's
    byte for byte — blocks, seg (pad tail −1), row_len, row_offset,
    bucket, unit rows — including the seals an overflowing item forces,
    and the zeroed tails of reused slots."""
    tspec, jspec = _specs()
    port = SlotRing(8, depth=4, ragged=tspec)
    ref = RefRing(8, depth=4, ragged=jspec)
    rng = np.random.default_rng(seed)
    seq = 0
    for group in _groups(seed):
        for k in group:
            inputs = _inputs(rng, seq, k)
            port.write(inputs, _Item(seq))
            ref.write(inputs, _Item(seq))
            seq += 1
        while ref.pending_items():
            got = port.next_batch(0.0, _bucket_fn(tspec))
            want = ref.next_batch(0.0, _bucket_fn(jspec))
            assert _sealed(got) == _sealed(want)
            assert (got.arrays["seg"][got.units:] == -1).all()
            assert not got.arrays["boxes"][got.units:].any()
            port.release(got)
            ref.release(want)
        assert port.pending_items() == 0
    assert port.blocks_allocated == ref.blocks_allocated


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_stage_direct_seals_byte_equal_blocks(seed):
    """The dispatcher-side staging of the scheduler: the same staged
    lists give the same batches and the same leftovers (an item past
    the unit block starts the next batch), and a row of the wrong shape
    fails only its own item's future, with the reference's error."""
    tspec, jspec = _specs()
    port = SlotRing(8, depth=3, ragged=tspec)
    ref = RefRing(8, depth=3, ragged=jspec)
    rng = np.random.default_rng(seed)
    seq = 0
    for group in _groups(seed + 10) + [[3, 9, 2]]:
        staged_t, staged_j = [], []
        for k in group:
            inputs = _inputs(rng, seq, k)
            if k > 8:  # over the per-item cap: the shape check fails it
                inputs["boxes"] = inputs["boxes"][:, :3]
            staged_t.append((inputs, _Item(seq)))
            staged_j.append((inputs, _Item(seq)))
            seq += 1
        while staged_j:
            got, staged_t = port.stage_direct(staged_t, _bucket_fn(tspec), {})
            want, staged_j = ref.stage_direct(staged_j, _bucket_fn(jspec), {})
            assert [it.i for _, it in staged_t] == [it.i for _, it in staged_j]
            assert (got is None) == (want is None)
            if want is None:
                continue
            assert _sealed(got) == _sealed(want)
            assert set(got.clock) == set(want.clock) == {"slot_write", "seal"}
            port.release(got)
            ref.release(want)
    assert port.pending_items() == ref.pending_items() == 0


def test_stage_direct_fails_only_the_bad_row():
    tspec, jspec = _specs()
    rng = np.random.default_rng(5)
    errors = []
    for ring, spec in ((SlotRing(8, ragged=tspec), tspec),
                       (RefRing(8, ragged=jspec), jspec)):
        items = [_Item(i) for i in range(3)]
        good = _inputs(rng, 0, 2)
        bad = {"frames": good["frames"], "boxes": np.zeros((2, 3), np.float32)}
        sealed, rest = ring.stage_direct(
            [(good, items[0]), (bad, items[1]), (good, items[2])],
            _bucket_fn(spec), {})
        assert [it.i for it in sealed.items] == [0, 2] and rest == []
        assert sealed.row_len.tolist() == [2, 2]
        assert not items[0].future.done() and not items[2].future.done()
        errors.append(str(items[1].future.exception()))
    assert errors[0] == errors[1]


def test_packed_ring_refuses_what_the_reference_refuses():
    tspec, jspec = _specs()
    ok = _inputs(np.random.default_rng(0), 0, 2)
    messages = []
    for ring in (SlotRing(8, ragged=tspec), RefRing(8, ragged=jspec)):
        ring.write(ok, _Item(0))
        for bad in ({"frames": ok["frames"],
                     "boxes": np.zeros((9, 4), np.float32)},
                    {"frames": ok["frames"],
                     "boxes": np.zeros((2, 4), np.float64)}):
            with pytest.raises(ValueError) as exc:
                ring.write(bad, _Item(1))
            messages.append(str(exc.value))
    assert messages[:2] == messages[2:]


# -------------------------------------------------------- packed engine


def _echo_step(frames, boxes, seg):
    """A packed step that shows which frame and box each unit saw."""
    src = torch.clamp(seg, 0, frames.shape[0] - 1).long()
    f = frames.float()[src, :1]
    return torch.cat([f, boxes], -1) * (seg >= 0).float()[:, None]


def _packed_engine(**kw) -> BatchEngine:
    spec = tragged.RaggedSpec("boxes", (4,), max_units=8, unit_budget=4)
    return BatchEngine("packed", _echo_step, "cpu",
                       input_names=("frames", "boxes"), stall_timeout_s=0,
                       ragged="packed", ragged_spec=spec, **kw)


def test_packed_engine_ladder_accounting_and_scatter_back():
    """The consolidated ladder; each item resolves to exactly its own
    unit rows (none for zero regions), in submit order; unit occupancy
    counts the real units over the packed rows the batches computed."""
    eng = _packed_engine(max_batch=128, deadline_ms=30.0)
    try:
        assert eng.buckets == [1, 2, 8, 32, 128]
        assert eng.max_units == 8 and eng.ragged == "packed"
        rng = np.random.default_rng(3)
        counts = [2, 0, 8, 1, 5, 3]
        subs = [(np.full((2,), i, np.uint8),
                 rng.random((k, 4), dtype=np.float32))
                for i, k in enumerate(counts)]
        futs = [eng.submit(frames=f, boxes=b) for f, b in subs]
        for (f, b), fut in zip(subs, futs):
            rows = fut.result(timeout=30)
            assert rows.shape == (b.shape[0], 5)
            np.testing.assert_array_equal(rows[:, 0], f[0])
            np.testing.assert_array_equal(rows[:, 1:], b)
        st = eng.stats_row()
        assert st["ragged"] == "packed" and st["units"] == sum(counts)
        # every batch computed unit_rows(bucket) rows
        assert st["unit_slots"] == sum(max(8, 4 * int(b)) * c for b, c in
                                       st["bucket_batches"].items())
    finally:
        eng.stop()


def test_packed_engine_splits_at_the_unit_block():
    """Items whose units overflow one slot's block go out in a second
    batch; a lone full item fits the floor bucket."""
    eng = _packed_engine(max_batch=2, deadline_ms=50.0)
    try:
        assert eng.buckets == [1, 2]
        futs = [eng.submit(frames=np.full((2,), i, np.uint8),
                           boxes=np.full((8, 4), i, np.float32))
                for i in range(3)]
        for i, fut in enumerate(futs):
            np.testing.assert_array_equal(fut.result(timeout=30)[:, 1:],
                                          np.full((8, 4), i))
        assert eng.stats_row()["batches"] >= 2
    finally:
        eng.stop()


def test_packed_hub_thins_every_ladder_but_packs_only_classify():
    """An engine without a ragged spec (detect, fused) on a packed hub
    shares the consolidated ladder and keeps its dense rows."""
    eng = BatchEngine("det", lambda x: x + 1.0, "cpu", max_batch=128,
                      input_names=("x",), stall_timeout_s=0,
                      ragged="packed", deadline_ms=1.0)
    try:
        assert eng.buckets == [1, 2, 8, 32, 128]
        assert not eng._packed and eng._step_inputs == ("x",)
        assert eng._ring.ragged is None
        futs = [eng.submit(x=np.full((2,), i, np.float32)) for i in range(3)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(timeout=30), i + 1.0)
    finally:
        eng.stop()


def test_legacy_assembly_forces_packed_off(caplog):
    eng = _packed_engine(assembly="legacy")
    try:
        assert eng.ragged == "off" and eng._ring is None
        assert eng.buckets == _ladder(32)
        assert "forces it off" in caplog.text
    finally:
        eng.stop()


# ------------------------------------------ packed step against dense


_MODELS: dict = {}


def _models(dtype: str, precision: str):
    """The classifier in both registries (width 8), the port's weights
    bridged from the reference's."""
    if (dtype, precision) not in _MODELS:
        jm = JaxRegistry(dtype=dtype, precision=precision, **SMALL).get(CLS)
        tm = ModelRegistry(dtype=dtype, precision=precision, device="cpu",
                           **SMALL).get(CLS)
        tm.module.load_state_dict(params_from_jax(
            jax.tree.map(np.asarray, jm.params)))
        quantize_model(tm.module)
        _MODELS[dtype, precision] = (jm, tm)
    return _MODELS[dtype, precision]


_CASES = [("float32", "FP32"), ("int8", "BF16")]


def _frames(rng, wire: str, n: int = 3) -> np.ndarray:
    bgr = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    if wire == "bgr":
        return bgr
    return np.stack([tcolor.bgr_to_i420_host(f) for f in bgr])


def _boxes(rng, k: int) -> np.ndarray:
    p = rng.random((k, 2, 2), dtype=np.float32)
    return np.concatenate([p.min(1), p.max(1)], -1)


@pytest.mark.parametrize("wire", ["i420", "bgr"])
@pytest.mark.parametrize("dtype,precision", _CASES, ids=["float32", "int8"])
def test_packed_step_matches_the_references_dense_step(monkeypatch, wire,
                                                       dtype, precision):
    if dtype == "int8":
        monkeypatch.setattr(jql, "QGEMM_BACKEND", "pallas")
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    jm, tm = _models(dtype, precision)
    rng = np.random.default_rng(11)
    frames = _frames(rng, wire)
    counts = [3, 0, 8]
    dense = np.zeros((3, 8, 4), np.float32)
    packed, seg = [], []
    for i, k in enumerate(counts):
        b = _boxes(rng, k)
        dense[i, :k] = b
        packed.append(b)
        seg += [i] * k
    units = sum(counts)
    u = 16  # a pad tail after the real units
    boxes = np.zeros((u, 4), np.float32)
    boxes[:units] = np.concatenate(packed)
    seg = np.array(seg + [-1] * (u - units), np.int32)
    ref = np.asarray(jax.jit(jsteps.build_classify_step(jm, wire_format=wire))(
        jm.params, frames, dense))
    got = tsteps.build_classify_step_ragged(tm, wire_format=wire)(
        torch.from_numpy(frames), torch.from_numpy(boxes),
        torch.from_numpy(seg)).numpy()
    assert got.shape == (u, 11) and got.dtype == np.float32
    want = np.concatenate([ref[i, :k] for i, k in enumerate(counts)])
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got[:units], want, rtol=0, atol=tol)
    np.testing.assert_allclose(got[:units].sum(-1), 2.0, rtol=0, atol=1e-5)
    assert (got[units:] == 0).all()


# ----------------------------------------------- ClassifyStage, packed


def _ctx(seed: int, k: int) -> FrameContext:
    rng = np.random.default_rng(seed)
    ctx = FrameContext(frame=rng.integers(0, 255, (64, 64, 3), np.uint8),
                       pts_ns=0, seq=seed, stream_id="rag")
    for _ in range(k):
        x0, x1 = sorted(rng.random(2).tolist())
        y0, y1 = sorted(rng.random(2).tolist())
        ctx.regions.append(Region(x0=x0, y0=y0, x1=x1, y1=y1,
                                  confidence=0.9, label_id=0,
                                  label="vehicle"))
    return ctx


@pytest.mark.parametrize("dtype,precision", _CASES, ids=["float32", "int8"])
def test_packed_classify_stage_matches_dense(monkeypatch, dtype, precision):
    """One registry, two hubs (``ragged`` off and packed): the same
    frames at fill levels 0, 1, 2, 5 and 8 give the same attribute
    labels and confidences within the step tolerance; a zero-region
    frame submits nothing; the packed engine's row reports the mode and
    an honest unit occupancy."""
    if dtype == "int8":
        monkeypatch.setattr(tql, "QGEMM_BACKEND", "pallas")
    reg = ModelRegistry(dtype=dtype, precision=precision, device="cpu",
                        **SMALL)
    hubs = {mode: EngineHub(reg, device="cpu", max_batch=8, deadline_ms=2.0,
                            supervise=False, stall_timeout_s=0, ragged=mode)
            for mode in ("off", "packed")}
    tol = 1e-5 if dtype == "float32" else 2e-2
    try:
        stages = {mode: ClassifyStage(
            "cls", CLS, {"threshold": 0.0, "ingest-size": (64, 64)}, hub)
            for mode, hub in hubs.items()}
        assert stages["packed"]._packed and not stages["off"]._packed
        for seed, k in ((1, 2), (2, 0), (3, 8), (4, 1), (5, 5)):
            ctxs = {mode: _ctx(seed, k) for mode in stages}
            futs = {mode: stages[mode].submit(ctxs[mode]) for mode in stages}
            if k == 0:
                assert futs == {"off": None, "packed": None}
                continue
            res = {mode: f.result(timeout=120) for mode, f in futs.items()}
            assert res["packed"].shape == (k, 11)
            assert res["off"].shape == (8, 11)
            np.testing.assert_allclose(res["packed"], res["off"][:k],
                                       rtol=0, atol=tol)
            for mode in stages:
                stages[mode].complete(ctxs[mode], res[mode])
            for i, (ro, rp) in enumerate(zip(ctxs["off"].regions,
                                             ctxs["packed"].regions)):
                assert [t.name for t in ro.tensors] == \
                    [t.name for t in rp.tensors] == ["color", "type"]
                for to, tp, (a, b) in zip(ro.tensors, rp.tensors,
                                          ((0, 7), (7, 11))):
                    assert abs(to.confidence - tp.confidence) <= tol
                    # labels agree wherever the dense top-2 margin
                    # clears the tolerance
                    top2 = np.sort(res["off"][i, a:b])[-2:]
                    if top2[1] - top2[0] > tol:
                        assert to.label == tp.label
        row = hubs["packed"].stats()[f"classify:{CLS}"]
        assert row["ragged"] == "packed" and row["buckets"] == [1, 2, 8]
        assert row["units"] == 16 and 0 < row["unit_occupancy"] <= 1
        dense = hubs["off"].stats()[f"classify:{CLS}"]
        assert dense["ragged"] == "off" and dense["units"] == 16
        assert row["unit_occupancy"] >= dense["unit_occupancy"]
    finally:
        for hub in hubs.values():
            hub.stop()
