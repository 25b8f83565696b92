"""Decode worker: one lightweight thread per stream.

Counterpart of ``evam_tpu/media/decode.py``. A stream costs one decode
thread feeding the shared engines, with per-stream supervision: a
source error restarts the source with backoff instead of killing the
engine, and a dead stream never takes the batch engine down. Each
event carries ``decode_s``, the seconds its source took to produce it
(the frame trace's ``decode`` span).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Callable

from evam_tpu_torch.media.source import FrameEvent, VideoSource
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.media.decode")


def drop_oldest_put(q: "queue.Queue", item) -> int:
    """``put_nowait`` with drop-oldest eviction (live-stream
    backpressure); returns how many queued items were evicted. Shared
    by DecodeWorker and the DecodePool so the accounting semantics
    can't diverge."""
    dropped = 0
    while True:
        try:
            q.put_nowait(item)
            return dropped
        except queue.Full:
            try:
                q.get_nowait()
                dropped += 1
            except queue.Empty:
                pass


class DecodeWorker:
    """Reads a source on a daemon thread into a bounded queue.

    ``on_frame`` (if given) is called inline on the decode thread and
    its return ignored; otherwise frames land in ``self.queue``.
    Bounded queue = backpressure: when the engine falls behind, frames
    drop oldest-first (live-stream semantics) rather than growing
    memory — the behavior knob is ``drop_when_full``.
    """

    def __init__(
        self,
        stream_id: str,
        source_factory: Callable[[], VideoSource],
        maxsize: int = 8,
        drop_when_full: bool = True,
        max_restarts: int = 3,
        restart_backoff_s: float = 0.5,
        on_frame: Callable[[FrameEvent], None] | None = None,
    ):
        self.stream_id = stream_id
        self.source_factory = source_factory
        self.queue: queue.Queue[FrameEvent | None] = queue.Queue(maxsize=maxsize)
        self.drop_when_full = drop_when_full
        self.max_restarts = max_restarts
        self.restart_backoff_s = restart_backoff_s
        self.on_frame = on_frame
        self.frames_decoded = 0
        self.frames_dropped = 0
        self.error: str | None = None
        self._source: VideoSource | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"decode-{stream_id}", daemon=True
        )

    def start(self) -> "DecodeWorker":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._source is not None:
            self._source.close()
        self._thread.join(timeout=10)

    @property
    def finished(self) -> bool:
        return not self._thread.is_alive()

    def _emit(self, ev: FrameEvent) -> None:
        self.frames_decoded += 1
        metrics.inc("evam_frames_decoded", labels={"stream": self.stream_id})
        if self.on_frame is not None:
            self.on_frame(ev)
            return
        if self.drop_when_full:
            dropped = drop_oldest_put(self.queue, ev)
            if dropped:
                self.frames_dropped += dropped
                metrics.inc(
                    "evam_frames_dropped", dropped,
                    labels={"stream": self.stream_id, "stage": "decode"})
        else:
            while not self._stop.is_set():
                try:
                    self.queue.put(ev, timeout=0.5)
                    return
                except queue.Full:
                    continue

    def _run(self) -> None:
        restarts = 0
        while not self._stop.is_set():
            try:
                self._source = self.source_factory()
                t_d = time.perf_counter()
                for ev in self._source.frames():
                    # time spent inside the source generator ≈ host
                    # decode cost; rides the event into the frame
                    # trace's "decode" span (obs/trace.py)
                    ev.decode_s = time.perf_counter() - t_d
                    if self._stop.is_set():
                        break
                    self._emit(ev)
                    t_d = time.perf_counter()
                break  # clean EOS
            except Exception as exc:  # noqa: BLE001 — supervised restart
                restarts += 1
                self.error = str(exc)
                metrics.inc("evam_stream_errors", labels={"stream": self.stream_id})
                if restarts > self.max_restarts or self._stop.is_set():
                    log.error(
                        "stream %s failed permanently after %d restarts: %s",
                        self.stream_id, restarts - 1, exc,
                    )
                    break
                backoff = self.restart_backoff_s * (2 ** (restarts - 1))
                log.warning(
                    "stream %s source error (%s); restart %d/%d in %.1fs",
                    self.stream_id, exc, restarts, self.max_restarts, backoff,
                )
                time.sleep(backoff)
        if self.on_frame is None:
            self.queue.put(None)  # EOS sentinel
