"""Shared decode pool: M workers decoding N streams (N ≫ M).

Counterpart of ``evam_tpu/media/pool.py``. Per-stream decoding
(``DecodeWorker``, a thread a stream) oversubscribes a host at many
concurrent captures; the pool inverts it: a fixed worker team
round-robins over every registered stream, decoding ONE frame per
scheduling turn. Total decode threads = ``workers`` whatever the
stream count; fairness comes from FIFO turn order among ready streams,
and paced streams wait on per-stream due times in a heap. A stream is
held by at most one worker at a time (it leaves the heap while it is
serviced), so a source never sees concurrent access.
"""

from __future__ import annotations

import heapq
import itertools
import logging
import queue
import threading
import time
from typing import Callable, Iterator

from evam_tpu_torch.media.decode import drop_oldest_put
from evam_tpu_torch.media.source import FrameEvent, VideoSource
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.media.pool")


class PooledStream:
    """One stream's registration in the pool.

    Mirrors ``DecodeWorker``'s consumption contract: a bounded
    ``queue`` with drop-oldest backpressure, a ``frames()`` iterator
    facade (so it can stand in for ``VideoSource.frames()`` in
    ``StreamRunner``), and decoded/dropped counters.
    """

    def __init__(self, stream_id: str,
                 source_factory: Callable[[], VideoSource],
                 maxsize: int = 8, drop_when_full: bool = True,
                 fps: float | None = None,
                 on_frame: Callable[[FrameEvent], None] | None = None):
        self.stream_id = stream_id
        self.source_factory = source_factory
        self.queue: queue.Queue[FrameEvent | None] = queue.Queue(
            maxsize=maxsize)
        self.drop_when_full = drop_when_full
        self.fps = fps        # None: free-running (file-rate) stream
        self.on_frame = on_frame
        self.frames_decoded = 0
        self.frames_dropped = 0
        self.error: str | None = None
        self.finished = False
        #: per-stream restart budget; set by DecodePool.add_stream
        self.max_restarts = 0
        self._source: VideoSource | None = None
        self._iter: Iterator[FrameEvent] | None = None
        self._removed = False
        #: lossless mode: a decoded frame waiting for queue space.
        #: A full queue must NEVER block a shared pool worker — the
        #: frame parks here and the stream is rescheduled instead.
        self._pending: FrameEvent | None = None
        #: lossless mode: clean EOS waiting for queue space (the
        #: drop-to-make-room EOS in _finish would lose a real frame)
        self._eos_pending = False

    # -------------------------------------------------- consumer side

    def frames(self) -> Iterator[FrameEvent]:
        """Drain the pool's output queue until EOS — drop-in for
        ``VideoSource.frames()`` on the consuming thread."""
        while True:
            ev = self.queue.get()
            if ev is None:
                return
            yield ev

    def close(self) -> None:
        self._removed = True
        src = self._source
        if src is not None:
            try:
                src.close()
            except Exception:  # noqa: BLE001
                pass

    # ----------------------------------------------------- pool side

    def _emit(self, ev: FrameEvent) -> None:
        self.frames_decoded += 1
        metrics.inc("evam_frames_decoded",
                    labels={"stream": self.stream_id})
        if self.on_frame is not None:
            self.on_frame(ev)
            return
        if self.drop_when_full:
            dropped = drop_oldest_put(self.queue, ev)
            if dropped:
                # every pool drop is consumer-side by construction
                # (lossless mode parks instead of dropping): the
                # downstream runner/engine is behind — same stage
                # attribution as DemuxStream.frames_dropped_downstream
                self.frames_dropped += dropped
                metrics.inc("evam_frames_dropped", dropped,
                            labels={"stream": self.stream_id,
                                    "stage": "downstream"})
        else:
            # lossless: park the frame; the pool retries the put on
            # the stream's next turn (never blocks a shared worker)
            try:
                self.queue.put_nowait(ev)
            except queue.Full:
                self._pending = ev

    def _finish(self, error: str | None = None) -> None:
        """Terminal transition (removal / pool stop / drop-mode
        error): deliver EOS without ever blocking a pool worker,
        evicting a queued frame if it must. Lossless streams route
        BOTH clean-EOS and decode-error EOS through ``_eos_pending``
        scheduling in the pool instead, so queued frames survive."""
        self.error = error
        self.finished = True
        if self.on_frame is None:
            drop_oldest_put(self.queue, None)


class DecodePool:
    """Fixed team of decode workers multiplexing many streams.

    ``workers`` bounds TOTAL decode threads (the whole point); each
    scheduling turn decodes one frame of the most-overdue ready
    stream. Streams added with ``fps`` are paced (a turn is scheduled
    every 1/fps); free-running streams re-enter the ready set
    immediately, FIFO-fair among themselves.
    """

    def __init__(self, workers: int = 2, max_restarts: int = 3,
                 restart_backoff_s: float = 0.5):
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        #: (due_time, turn_seq, stream, restarts_left)
        self._heap: list = []
        #: cumulative counters of terminated streams (same fold-on-
        #: retire pattern as RtspDemux: long-lived servers churn
        #: streams, dead objects must not accumulate)
        self._retired_decoded = 0
        self._retired_dropped = 0
        self._turn = itertools.count()
        self._cv = threading.Condition()
        self._stop = False
        self._threads = [
            threading.Thread(target=self._work, name=f"decode-pool-{i}",
                             daemon=True)
            for i in range(workers)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------- registry

    def add_stream(self, stream_id: str,
                   source_factory: Callable[[], VideoSource],
                   maxsize: int = 8, drop_when_full: bool = True,
                   fps: float | None = None, on_frame=None,
                   max_restarts: int | None = None) -> PooledStream:
        """``max_restarts=None`` uses the pool default; pass 0 when an
        outer supervisor (StreamInstance retry) owns reconnection."""
        ps = PooledStream(stream_id, source_factory, maxsize,
                          drop_when_full, fps, on_frame)
        ps.max_restarts = (self.max_restarts if max_restarts is None
                           else max_restarts)
        with self._cv:
            if self._stop:
                raise RuntimeError("pool is stopped")
            heapq.heappush(
                self._heap,
                (time.monotonic(), next(self._turn), ps,
                 ps.max_restarts))
            self._cv.notify()
        return ps

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            pending = [e[2] for e in self._heap]
            self._heap.clear()
            self._cv.notify_all()
        for ps in pending:
            ps.close()
            ps._finish("pool stopped")
            self._fold(ps)
        for t in self._threads:
            t.join(timeout=10)

    def _fold(self, ps: PooledStream) -> None:
        """Fold a terminated stream's counters into the cumulative
        totals (called exactly once per stream: terminal _service
        return, stop-race cleanup, or pool stop)."""
        with self._cv:
            self._retired_decoded += ps.frames_decoded
            self._retired_dropped += ps.frames_dropped

    def stats(self) -> dict:
        """Worker/stream counts + cumulative frame counters for
        /healthz (same shape family as ``RtspDemux.stats``). Pool
        drops are all consumer-side (``dropped_downstream`` ==
        ``dropped``): lossless streams park instead of dropping, and
        drop-when-full only engages when the runner/engine lags —
        decode-bound loss can't happen inside the pool itself."""
        with self._cv:
            live = [e[2] for e in self._heap]
            decoded = self._retired_decoded
            dropped = self._retired_dropped
        decoded += sum(s.frames_decoded for s in live)
        dropped += sum(s.frames_dropped for s in live)
        return {
            "workers": len(self._threads),
            "queued_streams": len(live),
            "decoded": decoded,
            "dropped": dropped,
            "dropped_downstream": dropped,
        }

    # -------------------------------------------------------- workers

    def _work(self) -> None:
        while True:
            with self._cv:
                while not self._stop and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    if self._heap:
                        self._cv.wait(
                            max(0.0,
                                self._heap[0][0] - time.monotonic()))
                    else:
                        self._cv.wait()
                if self._stop:
                    return
                due, _seq, ps, restarts_left = heapq.heappop(self._heap)
            requeue = self._service(ps, restarts_left)
            if requeue is not None:
                with self._cv:
                    if not self._stop:
                        heapq.heappush(self._heap, requeue)
                        self._cv.notify()
                        continue
                ps.close()
                ps._finish("pool stopped")
                self._fold(ps)
            else:
                self._fold(ps)  # terminal: stream left the pool

    def _service(self, ps: PooledStream, restarts_left: int):
        """Decode one frame of ``ps``; return its next heap entry or
        None when the stream is done."""
        if ps._removed:
            ps._finish(ps.error)
            return None
        if ps._eos_pending:
            try:
                ps.queue.put_nowait(None)
            except queue.Full:
                return (time.monotonic() + 0.02, next(self._turn),
                        ps, restarts_left)
            ps.finished = True
            return None
        if ps._pending is not None:
            # lossless backlog: retry the parked frame before
            # decoding anything new (preserves order)
            try:
                ps.queue.put_nowait(ps._pending)
                ps._pending = None
            except queue.Full:
                return (time.monotonic() + 0.02, next(self._turn),
                        ps, restarts_left)
        try:
            if ps._iter is None:
                ps._source = ps.source_factory()
                ps._iter = iter(ps._source.frames())
            ev = next(ps._iter, None)
        except Exception as exc:  # noqa: BLE001 — supervised restart
            if ps._removed:
                ps._finish(None)
                return None
            metrics.inc("evam_stream_errors",
                        labels={"stream": ps.stream_id})
            # close the failed capture before dropping the handle:
            # single-connection sources (RTSP cameras) reject the
            # reconnect while the dead connection is still open, and
            # FFmpeg's decoder threads leak with it
            ps._iter = None
            src, ps._source = ps._source, None
            if src is not None:
                try:
                    src.close()
                except Exception:  # noqa: BLE001
                    pass
            if restarts_left <= 0:
                log.error("pooled stream %s failed permanently: %s",
                          ps.stream_id, exc)
                if ps.on_frame is None and not ps.drop_when_full:
                    # lossless: the consumer must still see every
                    # frame decoded before the failure — deliver EOS
                    # through the same rescheduling as clean EOS
                    # instead of evicting the oldest queued frame
                    ps.error = str(exc)
                    ps._eos_pending = True
                    return (time.monotonic() + 0.02,
                            next(self._turn), ps, 0)
                ps._finish(str(exc))
                return None
            # budget is per-stream (add_stream override), not the
            # pool default — a mismatch would corrupt the backoff
            used = ps.max_restarts - restarts_left + 1
            backoff = self.restart_backoff_s * (2 ** (used - 1))
            log.warning(
                "pooled stream %s source error (%s); restart %d/%d "
                "in %.1fs", ps.stream_id, exc, used,
                ps.max_restarts, backoff)
            return (time.monotonic() + backoff, next(self._turn), ps,
                    restarts_left - 1)
        if ev is None:            # clean EOS
            if ps.on_frame is None and not ps.drop_when_full:
                # lossless: EOS must queue without displacing a frame
                try:
                    ps.queue.put_nowait(None)
                except queue.Full:
                    ps._eos_pending = True
                    return (time.monotonic() + 0.02,
                            next(self._turn), ps, restarts_left)
                ps.finished = True
                return None
            ps._finish(None)
            return None
        ps._emit(ev)
        # free-running streams re-enter at NOW (not 0.0): an overdue
        # paced stream must still win its turn, else free-runners
        # starve paced ones
        now = time.monotonic()
        due = now + 1.0 / ps.fps if ps.fps else now
        if ps._pending is not None:
            # consumer is behind: don't decode ahead, retry the put
            due = max(due, now + 0.02)
        return (due, next(self._turn), ps, restarts_left)
