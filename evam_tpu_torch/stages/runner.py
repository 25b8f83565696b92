"""StreamRunner: drives one stream's frames through its stage chain
with several frames in flight (counterpart of ``evam_tpu/stages/runner.py``).

A frame walks sync stages inline, parks at an async (engine-backed)
stage, and resumes — strictly in seq order — once its batch result
lands, so one stream keeps up to ``window`` frames in the engine at
once. Each frame that leaves the chain adds its ingest-to-exit latency
to :attr:`StreamRunner.latencies`. Every frame carries the stream's
``priority`` into its submits; a frame the scheduler sheds
(``ShedError``) is one counted frame error, also counted in
:attr:`StreamRunner.shed`, never the end of the stream.

Each frame is traced (``obs/trace.py``, EVAM_TRACE on by default): a
trace minted at ingest, a ``stage.<name>`` span per sync stage and per
async completion, ``finish_frame`` with the frame's status (ok, error,
shed), and the trace id as the latency histogram's exemplar. The fault
injector (EVAM_FAULT_INJECT) is consulted per frame, its injected
errors isolated like any other frame error; with EVAM_CKPT on, the
stream's checkpoint is refreshed every ``EVAM_CKPT_INTERVAL`` resolved
frames (the post-resolve barrier).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Iterator

from evam_tpu_torch.media.source import FrameEvent
from evam_tpu_torch.obs import trace
from evam_tpu_torch.obs.faults import from_env as faults_from_env
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.obs.trace import observe_frame_latency, stage_timer
from evam_tpu_torch.sched.shedder import ShedError
from evam_tpu_torch.stages.base import AsyncStage, Stage
from evam_tpu_torch.stages.context import FrameContext
from evam_tpu_torch.state import active as ckpt_active

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
        priority: str = "standard",
    ):
        self.stream_id = stream_id
        #: QoS class stamped on every FrameContext
        self.priority = priority
        self.stages = stages
        self.source_uri = source_uri
        self.window = max(1, window)
        self.on_error = on_error
        self.frames_in = 0
        self.frames_out = 0
        self.errors = 0
        #: frames the scheduler shed (each also counts in errors)
        self.shed = 0
        #: ingest → exit seconds of every frame that left the chain
        self.latencies: list[float] = []
        self._parked: deque[_Parked] = deque()
        self._stopped = False
        self._faults = faults_from_env()
        #: the checkpoint store, resolved once (None with EVAM_CKPT off:
        #: the post-resolve hook is one None check)
        self._ckpt = ckpt_active()
        #: trace id of the last resolved frame — the checkpoint's
        #: trace-continuity marker (kept only with ckpt on)
        self.last_trace_id = ""

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
            audio=ev.audio,
            pts_ns=ev.pts_ns,
            seq=ev.seq,
            stream_id=self.stream_id,
            source_uri=self.source_uri,
            ingest_t=time.perf_counter(),
            priority=self.priority,
            trace=trace.start_frame(self.stream_id, ev.seq, self.priority),
        )
        if ctx.trace is not None and ev.decode_s is not None:
            # decode happened before ingest: backdate its span so the
            # tree starts where the frame's wall time started
            ctx.trace.add_span("decode", ctx.ingest_t - ev.decode_s,
                               ev.decode_s)
        if self._faults is not None:
            try:
                frame = self._faults.apply(ctx.frame)
            except Exception as exc:  # noqa: BLE001 — injected error
                self._handle_error(exc, ctx)
                return
            if frame is None and ctx.frame is not None:
                return  # injected drop
            ctx.frame = frame
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
                t_c = time.perf_counter()
                with stage_timer(f"{head.stage.name}.complete"):
                    outs = head.stage.complete(head.ctx, result)
                if head.ctx.trace is not None:
                    head.ctx.trace.add_span(
                        f"stage.{head.stage.name}.complete", t_c,
                        time.perf_counter() - t_c)
            except Exception as exc:  # noqa: BLE001 — frame-level fault isolation
                self._handle_error(exc, head.ctx)
                continue
            for ctx in outs:
                ctx.stage_index = head.ctx.stage_index + 1
                if ctx.ingest_t is None:
                    ctx.ingest_t = head.ctx.ingest_t
                if ctx.trace is None:
                    ctx.trace = head.ctx.trace
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
                t_s = time.perf_counter()
                with stage_timer(stage.name):
                    outs = stage.process(ctx)
                if ctx.trace is not None:
                    ctx.trace.add_span(f"stage.{stage.name}", t_s,
                                       time.perf_counter() - t_s)
            except Exception as exc:  # noqa: BLE001
                self._handle_error(exc, ctx)
                return
            if not outs:
                return  # frame consumed/dropped
            if len(outs) == 1 and outs[0] is ctx:
                i += 1
                continue
            # fan-out (e.g. audio re-chunking): each emitted ctx
            # continues from the next stage, inheriting the parent's
            # ingest time so the latency list covers them
            for out in outs:
                out.stage_index = i + 1
                if out.ingest_t is None:
                    out.ingest_t = ctx.ingest_t
                if out.trace is None:
                    out.trace = ctx.trace
                self._advance(out)
            return
        self.frames_out += 1
        metrics.inc("evam_frames_processed", labels={"stream": self.stream_id})
        if ctx.ingest_t is not None:
            latency = time.perf_counter() - ctx.ingest_t
            self.latencies.append(latency)
            observe_frame_latency(
                self.stream_id, latency, priority=ctx.priority,
                trace_id=ctx.trace.trace_id if ctx.trace is not None else None)
        trace.finish_frame(ctx.trace, "ok")
        if self._ckpt is not None:
            # post-resolve barrier: the frame left the chain, so every
            # stage's cross-frame state is consistent — refresh this
            # stream's checkpoint on the capture cadence
            if ctx.trace is not None:
                self.last_trace_id = ctx.trace.trace_id
            if self.frames_out % self._ckpt.interval == 0:
                self._ckpt.capture(self.stream_id, barrier="post_resolve")

    def _handle_error(self, exc: Exception, ctx: FrameContext) -> None:
        self.errors += 1
        if isinstance(exc, ShedError):
            self.shed += 1
        metrics.inc("evam_frame_errors", labels={"stream": self.stream_id})
        log.warning("stream %s frame %d error: %s", self.stream_id, ctx.seq,
                    exc)
        # tail sampling always retains shed and error frames
        trace.finish_frame(ctx.trace,
                           "shed" if isinstance(exc, ShedError) else "error")
        if self.on_error is not None:
            self.on_error(exc)
