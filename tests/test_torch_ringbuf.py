"""The port's staging ring (``evam_tpu_torch/engine/ringbuf.py``) against
the reference's (``evam_tpu/engine/ringbuf.py``): the same writes and
seals give byte-equal sealed blocks, the same buckets and the same
items in row order; pad tails read zero after a slot is reused; and the
concurrency contract — many writers, drain, close, release — holds the
same way. Exact equality throughout: the ring is a copy."""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest

from evam_tpu.engine.ringbuf import STAGES as REF_STAGES
from evam_tpu.engine.ringbuf import SlotRing as RefRing
from evam_tpu_torch.engine.ringbuf import STAGES, SlotRing, numpy_alloc


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, 8)


def _item(rng, i: int) -> dict[str, np.ndarray]:
    return {"frames": rng.integers(0, 255, (6, 4), np.uint8),
            "boxes": rng.random((3, 4), dtype=np.float32) + i}


def _sealed_bytes(sealed) -> tuple:
    return (sealed.n, sealed.bucket, list(sealed.items),
            {k: (v.shape, v.dtype.str, v.tobytes())
             for k, v in sealed.arrays.items()})


def test_stages_are_the_references():
    assert STAGES == REF_STAGES


@pytest.mark.parametrize("counts", [[3, 8, 1, 5], [8, 8, 2], [1, 1, 7, 3, 6]])
def test_same_writes_seal_byte_equal_blocks(counts):
    """Batches of the given sizes, one after another through rings of
    capacity 8 and depth 2 (so slots are reused with shorter fills):
    every sealed batch is byte-equal to the reference's, pad tails
    zero."""
    rng = np.random.default_rng(sum(counts))
    port, ref = SlotRing(8, depth=2), RefRing(8, depth=2)
    seq = 0
    for n in counts:
        items = [_item(rng, seq + i) for i in range(n)]
        for i, inputs in enumerate(items):
            port.write(inputs, seq + i)
            ref.write(inputs, seq + i)
        seq += n
        got = port.next_batch(0.0, _bucket)
        want = ref.next_batch(0.0, _bucket)
        assert _sealed_bytes(got) == _sealed_bytes(want)
        for arr in got.arrays.values():
            assert not arr[got.n:].any(), "pad tail not zero"
        assert set(got.clock) == {"submit_wait", "slot_write", "seal"}
        port.release(got)
        ref.release(want)
    assert port.blocks_allocated == ref.blocks_allocated == 4


def test_shape_mismatch_is_refused_as_in_the_reference():
    port, ref = SlotRing(4), RefRing(4)
    ok = {"frames": np.zeros((6, 4), np.uint8)}
    bad = {"frames": np.zeros((6, 5), np.uint8)}
    port.write(ok, 0)
    ref.write(ok, 0)
    with pytest.raises(ValueError) as p_exc:
        port.write(bad, 1)
    with pytest.raises(ValueError) as r_exc:
        ref.write(bad, 1)
    assert str(p_exc.value) == str(r_exc.value)


def test_full_slot_seals_before_the_deadline():
    port = SlotRing(4, depth=2)
    for i in range(4):
        port.write({"x": np.full((2,), i, np.int32)}, i)
    t0 = time.perf_counter()
    sealed = port.next_batch(30.0, _bucket)
    assert time.perf_counter() - t0 < 5.0
    assert sealed.n == sealed.bucket == 4 and sealed.items == [0, 1, 2, 3]


def test_concurrent_writers_drain_close_and_release():
    """Eight writers race into a ring of capacity 4 and depth 2: every
    item lands exactly once, rows hold their item's data, writers block
    while both slots are in flight, drain hands back what was never
    sealed, and close wakes blocked writers with RuntimeError."""
    ring = SlotRing(4, depth=2)
    errors: list[BaseException] = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def writer(w: int) -> None:
        for j in range(5):
            try:
                ring.write({"x": np.full((3,), 100 * w + j, np.int32)},
                           100 * w + j)
            except RuntimeError:
                return
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
    try:
        for t in threads:
            t.start()
        seen: list[int] = []
        while len(seen) < 20:
            sealed = ring.next_batch(0.01, _bucket)
            assert sealed is not None
            for row, item in enumerate(sealed.items):
                assert (sealed.arrays["x"][row] == item).all()
            assert not sealed.arrays["x"][sealed.n:].any()
            seen.extend(sealed.items)
            ring.release(sealed)
        # the other 20 writes are staged or waiting; hold one slot in
        # flight, close (as the engine's stop does: a writer woken by the
        # drain could otherwise take the freed slot), then drain what is
        # staged
        held = ring.next_batch(0.01, _bucket)
        seen.extend(held.items)
        ring.close()
        drained = ring.drain_items()
        seen.extend(drained)
        for t in threads:
            t.join(timeout=10)
    finally:
        sys.setswitchinterval(switch)
        ring.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert len(seen) == len(set(seen))
    with pytest.raises(RuntimeError, match="closed"):
        ring.write({"x": np.zeros((3,), np.int32)}, -1)
    ring.release(held)
    assert ring.pending_items() == 0
    assert ring.next_batch(0.01, _bucket) is None
    assert ring.blocks_allocated == 2


def test_pending_and_age_track_staged_rows():
    ring = SlotRing(4, depth=2)
    assert ring.pending_items() == 0 and ring.oldest_age_s() == 0.0
    ring.write({"x": np.zeros((1,), np.int8)}, 0)
    ring.write({"x": np.zeros((1,), np.int8)}, 1)
    time.sleep(0.02)
    assert ring.pending_items() == 2
    assert ring.oldest_age_s() >= 0.02
    sealed = ring.next_batch(0.0, _bucket)
    assert ring.pending_items() == 0
    ring.release(sealed)
    assert len(ring.slots()) == 2


def test_alloc_hook_backs_every_block():
    calls = []

    def alloc(shape, dtype):
        calls.append((shape, np.dtype(dtype)))
        return numpy_alloc(shape, dtype)

    ring = SlotRing(4, depth=3, alloc=alloc)
    ring.write({"a": np.zeros((2, 2), np.float32),
                "b": np.zeros((5,), np.uint8)}, 0)
    assert sorted(calls, key=str) == sorted(
        [((4, 2, 2), np.dtype(np.float32))] * 3
        + [((4, 5), np.dtype(np.uint8))] * 3, key=str)


def test_prepare_allocates_ahead_of_the_first_write():
    """``prepare`` allocates every block from an example; the writes
    after it allocate nothing and seal what the reference's ring seals
    from the same writes."""
    calls = []

    def alloc(shape, dtype):
        calls.append((shape, np.dtype(dtype)))
        return numpy_alloc(shape, dtype)

    rng = np.random.default_rng(5)
    port, ref = SlotRing(8, depth=3, alloc=alloc), RefRing(8, depth=3)
    port.prepare({k: np.zeros_like(v) for k, v in _item(rng, 0).items()})
    assert port.blocks_allocated == 6 and len(calls) == 6
    for i in range(5):
        inputs = _item(rng, i)
        port.write(inputs, i)
        ref.write(inputs, i)
    got, want = port.next_batch(0.0, _bucket), ref.next_batch(0.0, _bucket)
    assert _sealed_bytes(got) == _sealed_bytes(want)
    assert port.blocks_allocated == ref.blocks_allocated == 6
    assert len(calls) == 6


def test_prepare_after_the_first_write_changes_nothing():
    ring = SlotRing(4, depth=2)
    ring.write({"x": np.zeros((3,), np.int32)}, 0)
    ring.prepare({"x": np.zeros((7,), np.float32)})
    assert ring.blocks_allocated == 2
    ring.write({"x": np.ones((3,), np.int32)}, 1)
    sealed = ring.next_batch(0.0, _bucket)
    assert sealed.items == [0, 1]
    assert sealed.arrays["x"].shape == (2, 3)


def test_prepared_ring_refuses_other_shapes_as_in_the_reference():
    port, ref = SlotRing(4), RefRing(4)
    ok = {"frames": np.zeros((6, 4), np.uint8)}
    bad = {"frames": np.zeros((6, 5), np.uint8)}
    port.prepare(ok)
    ref.write(ok, 0)
    with pytest.raises(ValueError) as p_exc:
        port.write(bad, 1)
    with pytest.raises(ValueError) as r_exc:
        ref.write(bad, 1)
    assert str(p_exc.value) == str(r_exc.value)
