"""StreamRunner: drives one stream's frames through its stage chain
with several frames in flight (counterpart of ``evam_tpu/stages/runner.py``).

A frame walks sync stages inline, parks at an async (engine-backed)
stage, and resumes — strictly in seq order — once its batch result
lands, so one stream keeps up to ``window`` frames in the engine at
once. Each frame that leaves the chain adds its ingest-to-exit latency
to :attr:`StreamRunner.latencies`. The reference's trace, fault
injection, shedding and checkpoint hooks come with later slices.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Iterator

from evam_tpu_torch.media.source import FrameEvent
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.stages.base import AsyncStage, Stage
from evam_tpu_torch.stages.context import FrameContext

log = logging.getLogger("evam_tpu_torch.stages.runner")


@dataclass
class _Parked:
    ctx: FrameContext
    stage: AsyncStage
    future: Future | None


class StreamRunner:
    def __init__(
        self,
        stream_id: str,
        stages: list[Stage],
        source_uri: str = "",
        window: int = 4,
        on_error: Callable[[Exception], None] | None = None,
    ):
        self.stream_id = stream_id
        self.stages = stages
        self.source_uri = source_uri
        self.window = max(1, window)
        self.on_error = on_error
        self.frames_in = 0
        self.frames_out = 0
        self.errors = 0
        #: ingest → exit seconds of every frame that left the chain
        self.latencies: list[float] = []
        self._parked: deque[_Parked] = deque()
        self._stopped = False

    # ----------------------------------------------------------- API

    def run(self, events: Iterator[FrameEvent]) -> None:
        """Consume the event iterator to completion (blocking)."""
        for ev in events:
            if self._stopped:
                break
            self.feed(ev)
        self.drain()

    def stop(self) -> None:
        self._stopped = True

    def feed(self, ev: FrameEvent) -> None:
        self.frames_in += 1
        ctx = FrameContext(
            frame=ev.frame,
            pts_ns=ev.pts_ns,
            seq=ev.seq,
            stream_id=self.stream_id,
            source_uri=self.source_uri,
            ingest_t=time.perf_counter(),
        )
        # free a slot first (blocking only when the window is full),
        # then start this frame down the chain
        self.pump(block=len(self._parked) >= self.window)
        self._advance(ctx)
        self.pump(block=False)

    def drain(self) -> None:
        while self._parked:
            self.pump(block=True)

    # ------------------------------------------------------ internals

    def pump(self, block: bool) -> None:
        """Resume parked frames whose results are ready (in order)."""
        while self._parked:
            head = self._parked[0]
            if (head.future is not None and not head.future.done()
                    and not block):
                return
            self._parked.popleft()
            try:
                result = (head.future.result()
                          if head.future is not None else None)
                outs = head.stage.complete(head.ctx, result)
            except Exception as exc:  # noqa: BLE001 — frame-level fault isolation
                self._handle_error(exc, head.ctx)
                continue
            for ctx in outs:
                ctx.stage_index = head.ctx.stage_index + 1
                if ctx.ingest_t is None:
                    ctx.ingest_t = head.ctx.ingest_t
                self._advance(ctx)
            block = False  # only the head wait is blocking

    def _advance(self, ctx: FrameContext) -> None:
        """Walk sync stages until the chain ends or an async stage parks."""
        i = ctx.stage_index
        while i < len(self.stages):
            stage = self.stages[i]
            ctx.stage_index = i
            if stage.is_async:
                try:
                    fut = stage.submit(ctx)
                except Exception as exc:  # noqa: BLE001
                    self._handle_error(exc, ctx)
                    return
                self._parked.append(_Parked(ctx, stage, fut))
                return
            try:
                outs = stage.process(ctx)
            except Exception as exc:  # noqa: BLE001
                self._handle_error(exc, ctx)
                return
            if not outs:
                return  # frame consumed/dropped
            if len(outs) == 1 and outs[0] is ctx:
                i += 1
                continue
            # fan-out: each emitted ctx continues from the next stage
            for out in outs:
                out.stage_index = i + 1
                if out.ingest_t is None:
                    out.ingest_t = ctx.ingest_t
                self._advance(out)
            return
        self.frames_out += 1
        metrics.inc("evam_frames_processed", labels={"stream": self.stream_id})
        if ctx.ingest_t is not None:
            self.latencies.append(time.perf_counter() - ctx.ingest_t)

    def _handle_error(self, exc: Exception, ctx: FrameContext) -> None:
        self.errors += 1
        metrics.inc("evam_frame_errors", labels={"stream": self.stream_id})
        log.warning("stream %s frame %d error: %s", self.stream_id, ctx.seq,
                    exc)
        if self.on_error is not None:
            self.on_error(exc)
