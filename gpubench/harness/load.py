"""The one traffic generator: a mix file's parameters → load on an engine.

A mix is a closed loop (``"loop": "closed"``): ``streams`` clients, each
keeping ``outstanding`` frames in flight and sending the next frame of
a stream as soon as one of its frames resolves. Each frame is one
uint32 seed, drawn from the run's seed, the stream and the frame's
index, and submitted through the engine's ``submit``; the engine makes
the frame's pixels on the device.

The client is the calling thread alone: completions come back through
the futures' callbacks, which hand them to the client through a queue;
it then submits the stream's next frame.
"""

from __future__ import annotations

import contextlib
import queue
import time
from dataclasses import dataclass, field

import numpy as np

from gpubench.harness.weights import mix_seed

#: salts of the frame seeds and of the sample of frames whose rows are
#: kept for the comparison
_FRAME_SALT = 0x5EED
_KEEP_SALT = 0xC0FFEE


def frame_seed(run_seed: int, stream: int, index: int) -> int:
    """The uint32 seed of frame ``index`` of ``stream``."""
    return mix_seed(run_seed ^ _FRAME_SALT, (stream << 32) | index) & 0xFFFFFFFF


def kept(run_seed: int, stream: int, index: int, one_in: int) -> bool:
    """Whether a frame's rows are kept for the comparison: one frame in
    ``one_in``, drawn from the seed."""
    return mix_seed(run_seed ^ _KEEP_SALT, (stream << 32) | index) % one_in == 0


@dataclass
class Record:
    """Every frame a run submitted, in submit order."""

    seed: list = field(default_factory=list)
    stream: list = field(default_factory=list)
    done: list = field(default_factory=list)
    error: list = field(default_factory=list)
    #: frame id → its rows, for the kept frames
    rows: dict = field(default_factory=dict)

    def add(self, seed: int, stream: int) -> int:
        self.seed.append(seed)
        self.stream.append(stream)
        self.done.append(None)
        self.error.append(None)
        return len(self.seed) - 1

    def finish(self, fid: int, fut, t: float, keep: bool) -> None:
        exc = fut.exception()
        if exc is not None:
            self.error[fid] = f"{type(exc).__name__}: {exc}"
        elif keep:
            self.rows[fid] = fut.result()
        self.done[fid] = t


class Client:
    """Drives one engine with one mix for one window.

    ``tick(now)`` is called from the client loop, so the run can take
    snapshots and start or stop the profiler at set times; ``span`` is
    a context manager factory wrapped around every submit (the traced
    run's ``gpubench.submit`` range)."""

    def __init__(self, engine, traffic: dict, seed: int, keep_one_in: int,
                 tick=None, span=None):
        self.engine = engine
        self.traffic = traffic
        self.seed = seed
        self.keep_one_in = keep_one_in
        self.tick = tick or (lambda now: None)
        self.span = span or contextlib.nullcontext
        self.rec = Record()
        self.keep: set[int] = set()

    def _submit(self, stream: int, index: int, on_done) -> None:
        rec = self.rec
        fid = rec.add(frame_seed(self.seed, stream, index), stream)
        if kept(self.seed, stream, index, self.keep_one_in):
            self.keep.add(fid)
        frame = np.uint32(rec.seed[fid])
        with self.span():
            fut = self.engine.submit(frames=frame)
        fut.add_done_callback(lambda f, fid=fid: on_done(fid, f))

    def run(self, t_start: float, seconds: float, drain_s: float) -> Record:
        """Offer the mix from ``t_start`` for ``seconds``, then wait up
        to ``drain_s`` for what is still in flight."""
        if self.traffic["loop"] != "closed":
            raise ValueError(f"unknown loop {self.traffic['loop']!r}")
        streams = int(self.traffic["streams"])
        depth = int(self.traffic["outstanding"])
        done: queue.SimpleQueue = queue.SimpleQueue()
        nxt = [0] * streams
        t_end = t_start + seconds

        def on_done(fid, fut):
            done.put((fid, fut, time.perf_counter()))

        def send(s):
            self._submit(s, nxt[s], on_done)
            nxt[s] += 1

        for _ in range(depth):
            for s in range(streams):
                send(s)
        flight = streams * depth
        while flight:
            try:
                fid, fut, t = done.get(timeout=0.02)
            except queue.Empty:
                now = time.perf_counter()
                self.tick(now)
                if now > t_end + drain_s:
                    break
                continue
            flight -= 1
            self.rec.finish(fid, fut, t, fid in self.keep)
            now = time.perf_counter()
            self.tick(now)
            if now < t_end:
                send(self.rec.stream[fid])
                flight += 1
        return self.rec
