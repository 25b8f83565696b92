"""Slot-based host staging ring (counterpart of ``evam_tpu/engine/ringbuf.py``).

A small ring of pre-allocated host blocks, one block per input name,
each sized to the engine's largest bucket and a few slots deep, so the
assembly of batch N+1 overlaps the device round trip of batch N:

* ``write()`` runs on the submitting stream thread and copies each
  item's arrays straight into its reserved row of the open slot — the
  one host copy, off the dispatcher's path and spread across stream
  threads;
* the dispatcher ``next_batch()`` seals a slot — picks the bucket,
  zeroes only the dirty pad tail — and hands contiguous
  ``block[:bucket]`` views to the upload;
* ``release()`` returns the slot to the free list after the batch's
  readback, so a block is never overwritten while a transfer from it
  may still be in flight.

Row indices are reserved under the ring lock, row copies happen outside
it (each row has one writer), and a seal waits for every writer of its
slot. Items resolve in row order.

**Ragged packing** (``engine/ragged.py``, ``EVAM_RAGGED=packed``): a
ring built with a ``RaggedSpec`` packs one declared input's
variable-length unit rows (a frame's real region boxes, shape
``(k, *unit_shape)``) end to end into a fixed unit block, with a
segment-id vector (``seg[j]`` = the owning batch row, −1 on the pad
tail) and per-item ``row_len``/``row_offset`` vectors the completer
uses to hand each item its rows. An item reserves one batch row and k
unit rows; a slot seals when either runs out, so a packed batch never
overflows its fixed device shape.

``stage_direct`` stages a batch the dispatcher assembled (the
scheduler's path: items leave per-class queues in class order, so their
rows are copied on the dispatcher thread).

The port allocates each block through ``alloc(shape, dtype)``: plain
numpy by default, page-locked host memory on a ``cuda`` engine
(:func:`pinned_alloc`), so the block's host→device copy is a true
asynchronous DMA; the unit block and ``seg`` are staged the same way.
Each slot also carries ``device``, a dict the engine keeps its per-slot
device buffers in.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable

import numpy as np

from evam_tpu_torch.engine.ragged import RaggedSpec
from evam_tpu_torch.obs.trace import prof_range

#: stage names of the per-batch host clock, in pipeline order.
#: submit_wait covers slot backpressure and the deadline-batching wait;
#: slot_write is the summed per-item row copies (spent on stream
#: threads); h2d_issue the time to enqueue the host→device copy,
#: h2d_wait the residual wait for it at launch (0 by definition on the
#: inline path, where the launch absorbs it), and readback the
#: device→host residual the completer still blocks on.
STAGES = (
    "submit_wait", "slot_write", "seal",
    "h2d_issue", "h2d_wait", "launch", "readback", "resolve",
)

Alloc = Callable[[tuple[int, ...], np.dtype], np.ndarray]


def numpy_alloc(shape: tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    return np.zeros(shape, dtype)


def pinned_alloc(shape: tuple[int, ...], dtype: np.dtype) -> np.ndarray:
    """A zeroed numpy view of page-locked host memory (the view keeps
    its torch tensor alive)."""
    import torch

    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    t = torch.zeros(shape, dtype=tdtype, pin_memory=True)
    return t.numpy()


class _Slot:
    """One staging block set: per-input pre-allocated (capacity, …)
    arrays plus fill bookkeeping, guarded by the ring's condition
    variable except the row contents (one writer per reserved row)."""

    __slots__ = ("arrays", "items", "count", "high", "writers",
                 "t_first", "closed", "wait_sum", "write_sum", "gen",
                 "device", "unit_count", "unit_high", "row_len", "seg")

    def __init__(self, arrays: dict[str, np.ndarray],
                 row_len: np.ndarray | None = None,
                 seg: np.ndarray | None = None):
        self.arrays = arrays
        self.items: list[Any] = []
        self.count = 0
        #: exclusive upper bound of possibly-nonzero rows left behind
        #: by earlier uses — the only rows a seal must zero
        self.high = 0
        self.writers = 0
        self.t_first = 0.0
        self.closed = False
        self.wait_sum = 0.0   # summed per-item slot-acquire waits
        self.write_sum = 0.0  # summed per-item row-copy times
        #: bumped on every recycle, so a dispatcher that slept through
        #: a drain sees its claim went stale
        self.gen = 0
        #: the engine's per-slot device buffers (ring never touches it)
        self.device: dict[str, Any] = {}
        #: ragged packing (None on a dense ring): packed units staged,
        #: the bound of possibly nonzero unit rows, each row's unit
        #: count, and each unit's owning row (−1 on the pad tail)
        self.unit_count = 0
        self.unit_high = 0
        self.row_len = row_len
        self.seg = seg


class SealedBatch:
    """A sealed slot ready for dispatch: contiguous ``[:bucket]`` views
    over the staging blocks, the items in row order, and the host-clock
    readings so far.

    On a ragged ring it also carries the packed-unit descriptor:
    ``row_len[i]``/``row_offset[i]`` locate item i's unit rows (copies:
    the slot is reused before the completer reads them), ``units`` is
    the real unit count and ``unit_rows`` the unit rows the device shape
    computes; ``arrays`` then holds the ragged input at ``[:unit_rows]``
    and ``seg``."""

    __slots__ = ("slot", "arrays", "items", "n", "bucket", "clock",
                 "row_len", "row_offset", "units", "unit_rows")

    def __init__(self, slot: _Slot, arrays: dict[str, np.ndarray],
                 items: list, n: int, bucket: int,
                 clock: dict[str, float],
                 row_len: np.ndarray | None = None,
                 row_offset: np.ndarray | None = None,
                 units: int = 0, unit_rows: int = 0):
        self.slot = slot
        self.arrays = arrays
        self.items = items
        self.n = n
        self.bucket = bucket
        self.clock = clock
        self.row_len = row_len
        self.row_offset = row_offset
        self.units = units
        self.unit_rows = unit_rows


class SlotRing:
    """Ring of ``depth`` pre-allocated staging slots for one engine.

    Blocks are allocated on the first ``write()`` (item shapes are not
    known at engine construction) and never reallocated —
    ``blocks_allocated`` pins that invariant.

    ``ragged`` (a RaggedSpec) switches the declared input to packed
    unit rows; the bucket callback then takes ``(n, units)`` instead of
    ``(n)``."""

    def __init__(self, capacity: int, depth: int = 4,
                 alloc: Alloc = numpy_alloc,
                 ragged: RaggedSpec | None = None):
        if capacity < 1 or depth < 2:
            raise ValueError("capacity >= 1 and depth >= 2 required")
        self.capacity = capacity
        self.depth = depth
        self._alloc = alloc
        self.ragged = ragged
        #: fixed unit rows of the packed block (0 on a dense ring)
        self.unit_capacity = ragged.unit_rows(capacity) if ragged else 0
        self._cv = threading.Condition()
        self._free: deque[_Slot] = deque()
        self._full: deque[_Slot] = deque()
        self._open: _Slot | None = None
        self._closed = False
        self._shapes: dict[str, tuple[tuple[int, ...], np.dtype]] | None = None
        self._all: list[_Slot] = []
        #: staging-block allocations ever made (one per input name per
        #: slot; constant after the first write)
        self.blocks_allocated = 0

    # ------------------------------------------------------- submit side

    def write(self, inputs: dict[str, np.ndarray], item) -> None:
        """Reserve the next row of the open slot and copy ``inputs``
        into it (outside the ring lock). Blocks while every slot is in
        flight — backpressure. On a ragged ring the item also reserves
        its k unit rows; an item that would overflow the open slot's
        unit block seals that slot and takes the next. Raises
        RuntimeError once closed."""
        arrays = {k: np.asarray(v) for k, v in inputs.items()}
        spec = self.ragged
        k = int(arrays[spec.input].shape[0]) if spec is not None else 0
        t0 = time.perf_counter()
        with self._cv:
            if self._shapes is None:
                self._allocate(arrays)
            else:
                self._check_shapes(arrays)
            while True:
                if self._closed:
                    raise RuntimeError("staging ring is closed")
                if self._open is not None:
                    slot = self._open
                    if (spec is None
                            or slot.unit_count + k <= self.unit_capacity):
                        break
                    # the packed units would overflow the fixed block:
                    # seal what is staged and take a fresh slot
                    slot.closed = True
                    self._full.append(slot)
                    self._open = None
                    self._cv.notify_all()
                    continue
                if self._free:
                    slot = self._free.popleft()
                    slot.t_first = time.perf_counter()
                    self._open = slot
                    break
                self._cv.wait(0.1)
            waited = time.perf_counter() - t0
            row = slot.count
            off = slot.unit_count
            slot.count += 1
            slot.unit_count += k
            if spec is not None:
                slot.row_len[row] = k
            slot.writers += 1
            slot.items.append(item)
            slot.wait_sum += waited
            filled = (slot.count >= self.capacity
                      or (spec is not None
                          and slot.unit_count >= self.unit_capacity))
            if filled:
                slot.closed = True
                self._full.append(slot)
                self._open = None
            if row == 0 or filled:
                # wake the dispatcher only on the edges it waits for
                self._cv.notify_all()
        t1 = time.perf_counter()
        try:
            with prof_range("slot_write"):
                for name, a in arrays.items():
                    if spec is not None and name == spec.input:
                        if k:  # the packed span is exclusively owned
                            slot.arrays[name][off:off + k] = a
                            slot.seg[off:off + k] = row
                    else:
                        slot.arrays[name][row] = a  # row exclusively owned
        finally:
            with self._cv:
                slot.write_sum += time.perf_counter() - t1
                slot.writers -= 1
                if slot.writers == 0 and slot.closed:
                    self._cv.notify_all()

    # --------------------------------------------------- dispatcher side

    def next_batch(self, deadline_s: float, bucket_fn) -> SealedBatch | None:
        """Wait for rows, honour the batch-fill deadline (from the open
        slot's first write), then seal: close the slot, wait out its
        writers, zero the dirty pad tail and return ``[:bucket]``
        views. On a ragged ring ``bucket_fn`` takes ``(n, units)`` and
        the packed block's and seg's tails are masked too. None once the
        ring is closed and drained."""
        with prof_range("submit_wait"), self._cv:
            while True:
                if self._full:
                    slot = self._full.popleft()
                elif self._open is not None and self._open.count > 0:
                    slot = self._open
                    gen = slot.gen
                    deadline = slot.t_first + deadline_s
                    while (not slot.closed and slot.gen == gen
                           and not self._closed):
                        remaining = deadline - time.perf_counter()
                        if remaining <= 0:
                            break
                        self._cv.wait(remaining)
                    if slot.gen != gen:
                        continue  # drained (stall/stop) mid-wait
                    if slot.closed:
                        # filled while we waited: claim its _full entry
                        try:
                            self._full.remove(slot)
                        except ValueError:
                            continue
                    else:
                        slot.closed = True
                        if self._open is slot:
                            self._open = None
                elif self._closed:
                    return None
                else:
                    self._cv.wait(0.1)
                    continue
                # exclusively claimed: in neither _open nor _full
                while slot.writers:
                    self._cv.wait(0.05)
                if slot.count == 0:
                    # lost a race with a drain — recycle, keep waiting
                    slot.closed = False
                    self._free.append(slot)
                    continue
                n = slot.count
                items = list(slot.items)
                submit_wait = (time.perf_counter() - slot.t_first
                               + slot.wait_sum)
                write_sum = slot.write_sum
                break
        t0 = time.perf_counter()
        with prof_range("seal"):
            sealed = self._seal(slot, items, n, bucket_fn)
        sealed.clock.update({
            "submit_wait": submit_wait,
            "slot_write": write_sum,
        })
        sealed.clock["seal"] = time.perf_counter() - t0
        return sealed

    def _seal(self, slot: _Slot, items: list, n: int,
              bucket_fn) -> SealedBatch:
        """Pick the bucket, zero the dirty pad tails (the dense rows
        and, on a ragged ring, the packed unit block; the seg tail is
        always −1), build the views and the ragged descriptor."""
        spec = self.ragged
        if spec is not None:
            units = slot.unit_count
            bucket = bucket_fn(n, units)
            u = min(spec.unit_rows(bucket), self.unit_capacity)
            dirty = min(slot.high, bucket)
            views: dict[str, np.ndarray] = {}
            for name, arr in slot.arrays.items():
                if name == spec.input:
                    udirty = min(slot.unit_high, u)
                    if udirty > units:
                        arr[units:udirty] = 0
                    views[name] = arr[:u]
                else:
                    if dirty > n:
                        arr[n:dirty] = 0
                    views[name] = arr[:bucket]
            # the seg pad tail is always −1 (the masked-compute
            # sentinel), whatever an earlier batch left there
            slot.seg[units:u] = -1
            views["seg"] = slot.seg[:u]
            row_len = slot.row_len[:n].copy()
            row_offset = np.zeros(n, np.int32)
            np.cumsum(row_len[:-1], out=row_offset[1:])
            return SealedBatch(slot, views, items, n, bucket, {},
                               row_len=row_len, row_offset=row_offset,
                               units=units, unit_rows=u)
        bucket = bucket_fn(n)
        dirty = min(slot.high, bucket)
        for arr in slot.arrays.values():
            if dirty > n:
                arr[n:dirty] = 0
        views = {k: a[:bucket] for k, a in slot.arrays.items()}
        return SealedBatch(slot, views, items, n, bucket, {})

    # ------------------------------------------------------- completion

    def release(self, sealed: SealedBatch) -> None:
        """Return a dispatched slot to the free list (after the batch's
        readback — its block may back an in-flight transfer until
        then)."""
        slot = sealed.slot
        with self._cv:
            # rows [n, bucket) were zeroed at seal; rows beyond the
            # bucket may still hold older data
            if slot.high <= sealed.bucket:
                slot.high = sealed.n
            if self.ragged is not None:
                if slot.unit_high <= sealed.unit_rows:
                    slot.unit_high = sealed.units
                slot.unit_count = 0
            slot.count = 0
            slot.items = []
            slot.closed = False
            slot.wait_sum = 0.0
            slot.write_sum = 0.0
            slot.gen += 1
            self._free.append(slot)
            self._cv.notify_all()

    # -------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Reject new writes and wake every waiter."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def drain_items(self) -> list:
        """Remove and return every written-but-undispatched item (open
        and full slots), so the engine can fail their futures on stop
        or stall. The slots return to the free list."""
        out: list = []
        with self._cv:
            slots = list(self._full)
            self._full.clear()
            if self._open is not None:
                slots.append(self._open)
                self._open = None
            for slot in slots:
                while slot.writers:
                    self._cv.wait(0.05)
                out.extend(slot.items)
                slot.high = max(slot.high, slot.count)
                slot.count = 0
                if self.ragged is not None:
                    slot.unit_high = max(slot.unit_high, slot.unit_count)
                    slot.unit_count = 0
                slot.items = []
                slot.closed = False
                slot.wait_sum = 0.0
                slot.write_sum = 0.0
                slot.gen += 1
                self._free.append(slot)
            self._cv.notify_all()
        return out

    def pending_items(self) -> int:
        """Rows written but not yet sealed (the queue-depth gauge)."""
        with self._cv:
            n = sum(s.count for s in self._full)
            if self._open is not None:
                n += self._open.count
            return n

    def oldest_age_s(self, now: float | None = None) -> float:
        """Age (s) of the oldest staged-but-undispatched work: the
        earliest first-write time across full and open slots."""
        now = time.perf_counter() if now is None else now
        with self._cv:
            firsts = [s.t_first for s in self._full if s.count]
            if self._open is not None and self._open.count:
                firsts.append(self._open.t_first)
        return max(0.0, now - min(firsts)) if firsts else 0.0

    def slots(self) -> list[_Slot]:
        """Every allocated slot, wherever it is — the engine frees their
        device buffers on stop."""
        with self._cv:
            return list(self._all)

    # ------------------------------------------- dispatcher-side staging

    def stage_direct(self, staged: list[tuple[dict, Any]], bucket_fn,
                     clock: dict[str, float],
                     ) -> tuple[SealedBatch | None, list]:
        """Stage a batch the dispatcher assembled into a free slot (the
        scheduler's path: the row copies happen here, on the dispatcher
        thread, with no per-batch allocation).

        ``staged`` is ``[(inputs, item), ...]`` in dispatch order. A row
        whose arrays do not fit the ring's shapes fails only its item's
        future; the survivors take contiguous rows. Items past the
        slot's capacity — batch rows, or packed unit rows — come back as
        the second element, for the caller to stage as another batch.
        Blocks while every slot is in flight; raises RuntimeError once
        the ring is closed; the sealed batch is None when no row
        survived."""
        first = {k: np.asarray(v) for k, v in staged[0][0].items()}
        spec = self.ragged
        with self._cv:
            if self._shapes is None:
                self._allocate(first)
            while not self._free and not self._closed:
                self._cv.wait(0.1)
            if self._closed:
                raise RuntimeError("staging ring is closed")
            slot = self._free.popleft()
        t0 = time.perf_counter()
        ok_items: list = []
        remaining: list = []
        row = 0
        off = 0
        with prof_range("slot_write"):
            for idx, (inputs, item) in enumerate(staged):
                if row >= self.capacity:
                    remaining = list(staged[idx:])
                    break
                try:
                    arrays = {k: np.asarray(v) for k, v in inputs.items()}
                    self._check_shapes(arrays)
                except Exception as exc:  # noqa: BLE001 — fail only this item
                    try:
                        item.future.set_exception(exc)
                    except Exception:  # noqa: BLE001 — already resolved
                        pass
                    continue
                if spec is not None:
                    k = int(arrays[spec.input].shape[0])
                    if off + k > self.unit_capacity:
                        remaining = list(staged[idx:])
                        break
                    for name, a in arrays.items():
                        if name == spec.input:
                            if k:
                                slot.arrays[name][off:off + k] = a
                                slot.seg[off:off + k] = row
                        else:
                            slot.arrays[name][row] = a
                    slot.row_len[row] = k
                    off += k
                else:
                    for name, a in arrays.items():
                        slot.arrays[name][row] = a
                ok_items.append(item)
                row += 1
        clock["slot_write"] = time.perf_counter() - t0
        if not ok_items:
            with self._cv:
                slot.count = 0
                slot.unit_count = 0
                slot.items = []
                slot.closed = False
                slot.gen += 1
                self._free.append(slot)
                self._cv.notify_all()
            return None, remaining
        t1 = time.perf_counter()
        slot.count = row
        slot.unit_count = off
        with prof_range("seal"):
            sealed = self._seal(slot, ok_items, row, bucket_fn)
        sealed.clock.update(clock)
        sealed.clock["seal"] = time.perf_counter() - t1
        return sealed, remaining

    # -------------------------------------------------------- internals

    def _allocate(self, example: dict[str, np.ndarray]) -> None:
        spec = self.ragged
        self._shapes = {}
        for k, a in example.items():
            if spec is not None and k == spec.input:
                # the leading dim varies per item: pin the unit shape
                self._shapes[k] = (tuple(spec.unit_shape),
                                   np.dtype(spec.dtype))
            else:
                self._shapes[k] = (tuple(a.shape), a.dtype)
        for _ in range(self.depth):
            arrays = {}
            for k, (shape, dtype) in self._shapes.items():
                rows = (self.unit_capacity
                        if spec is not None and k == spec.input
                        else self.capacity)
                arrays[k] = self._alloc((rows,) + shape, dtype)
            self.blocks_allocated += len(arrays)
            row_len = seg = None
            if spec is not None:
                row_len = np.zeros(self.capacity, np.int32)
                seg = self._alloc((self.unit_capacity,), np.dtype(np.int32))
                seg[:] = -1
            self._all.append(_Slot(arrays, row_len=row_len, seg=seg))
            self._free.append(self._all[-1])

    def _check_shapes(self, arrays: dict[str, np.ndarray]) -> None:
        spec = self.ragged
        for k, a in arrays.items():
            want = self._shapes.get(k)
            if spec is not None and k == spec.input:
                if (want is None
                        or (tuple(a.shape[1:]), a.dtype) != want
                        or a.shape[0] > spec.max_units):
                    raise ValueError(
                        f"ragged input {k}: want (<= {spec.max_units}, "
                        f"{want[0] if want else '?'}) "
                        f"{want[1] if want else '?'}, got shape "
                        f"{tuple(a.shape)} dtype {a.dtype}")
                continue
            if want is None or (tuple(a.shape), a.dtype) != want:
                raise ValueError(
                    f"staging ring configured for {self._shapes}, got "
                    f"{k}: shape {tuple(a.shape)} dtype {a.dtype} — "
                    "engines batch fixed ingest shapes; use a distinct "
                    "model-instance-id for a different resolution"
                )
