"""Per-bucket CUDA graphs: the port's counterpart of the reference's
per-bucket ``jax.jit`` executable (``evam_tpu/engine/batcher.py``
``_jit_step`` and the compile inside ``warmup()``).

A step issues dozens of kernels from Python per batch (every layer, the
``k`` updates of NMS); a captured graph issues them all with one
``replay()``. :class:`StepGraphs` holds one ``torch.cuda.CUDAGraph``
per batch bucket of one engine:

* ``capture(b, batch)`` runs the step eagerly once on a side stream
  (one-time set-up: kernel attributes, cuDNN plans, the lazily built
  constants), then captures it into a graph with static input and
  output tensors, with ``capture_error_mode="thread_local"`` so other
  engines' threads keep launching meanwhile. Captures are serialized
  process-wide, and each against its engine's own launches (the warm
  run is not: the engine keeps serving while it runs).
* ``replay(bg, inputs)`` copies the batch into the static inputs, in
  stream order on the caller's current stream, and replays — the
  output is the graph's static output, valid until the next replay of
  the same graph, so the caller copies it out in stream order first.
* All buckets of one engine share one graph memory pool; they replay
  one after another on the engine's one compute stream, never
  concurrently.
* The capture stream is the engine's own (``engine/streams.py``), never
  one of torch's pooled streams, which another engine could be handed
  too; :meth:`StepGraphs.close` destroys it once no capture runs.
* Every capture gets cuBLAS workspaces of its own. PyTorch keeps one
  cuBLAS (and one cuBLASLt) workspace per (handle, stream) and a
  capture bakes the current one into the graph, so without care the
  next eager GEMM on the warm thread's stream (the next bucket's warm
  run) shares scratch memory with the replays of the graph before it
  on the compute stream. Two GEMM kernels running at once on one
  workspace can corrupt its reduction flags and spin forever (seen on
  the H100: a warm run's stream that never drained). So the workspace
  map is cleared just before ``capture_begin`` (the capture allocates
  its workspaces on the capturing stream, hence in the graph's private
  pool) and just after ``capture_end`` (no eager call reuses them).

The hand kernels' wrappers launch nothing while a graph is captured:
the capture records their calls (the int8 GEMM's by variant,
``ops/qgemm.py`` ``recording``; the device-synth generator's,
``ops/synth.py`` ``recording``) and each replay adds them to the launch
counts.

No ``torch.compile``: it would change the arithmetic by fusing ops. The
graph replays exactly the kernels the eager step runs, so a replay and
an eager call of one bucket give the same bits.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from evam_tpu_torch.engine import streams
from evam_tpu_torch.ops import qgemm, synth

#: one capture at a time in the process (captures happen at warmup only)
_capture_lock = threading.Lock()


@dataclass
class BucketGraph:
    graph: torch.cuda.CUDAGraph
    inputs: list[torch.Tensor]
    output: torch.Tensor
    #: qgemm launches by variant that one replay makes
    launches: dict[str, int]
    #: synth launches that one replay makes
    synth_launches: int = 0


class StepGraphs:
    """The captured graphs of one engine's step, one per bucket."""

    def __init__(self, step_fn, device: torch.device):
        self.step_fn = step_fn
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = streams.create(self.device)
        #: held while a capture uses the stream, and by close()
        self._stream_lock = threading.Lock()
        self._graphs: dict[int, BucketGraph] = {}
        #: bucket → (seconds of its eager warm step, synchronized;
        #: seconds of its capture, lock waits excluded): what a cache of
        #: the warmup would have to save
        self.timings: dict[int, tuple[float, float]] = {}
        self.freed = False

    def __len__(self) -> int:
        return len(self._graphs)

    def get(self, b: int) -> BucketGraph | None:
        return self._graphs.get(b)

    def capture(self, b: int, batch: list[np.ndarray],
                lock: threading.Lock) -> BucketGraph:
        """Warm bucket ``b`` eagerly on the side stream, then capture
        it holding ``lock`` (the engine's device lock: no launch of the
        engine meanwhile). ``batch``: one host array per step input,
        leading dim b."""
        with self._stream_lock:
            if self.freed:
                raise RuntimeError("graphs were freed")
            return self._capture(b, batch, lock)

    def _capture(self, b: int, batch: list[np.ndarray],
                 lock: threading.Lock) -> BucketGraph:
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                      for a in batch]
            t0 = time.perf_counter()
            self.step_fn(*inputs)
            self.stream.synchronize()
            eager_s = time.perf_counter() - t0
            graph = torch.cuda.CUDAGraph()
            with _capture_lock, lock:
                if self.freed:
                    raise RuntimeError("graphs were freed")
                t1 = time.perf_counter()
                with qgemm.recording() as launches, \
                        synth.recording() as synth_launches:
                    torch._C._cuda_clearCublasWorkspaces()
                    graph.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        output = self.step_fn(*inputs)
                    finally:
                        graph.capture_end()
                        torch._C._cuda_clearCublasWorkspaces()
                bg = BucketGraph(graph, inputs, output, dict(launches),
                                 synth_launches["launches"])
                self._graphs[b] = bg
                self.timings[b] = (eager_s, time.perf_counter() - t1)
        return bg

    @staticmethod
    def replay(bg: BucketGraph, inputs: list[torch.Tensor]) -> torch.Tensor:
        """Replay ``bg`` on the current stream over ``inputs``; returns
        its static output."""
        for static, x in zip(bg.inputs, inputs):
            static.copy_(x, non_blocking=True)
        bg.graph.replay()
        qgemm.count_replay(bg.launches)
        synth.count_replay(bg.synth_launches)
        return bg.output

    def pool_bytes(self) -> int | None:
        """Device bytes the graphs' memory pool holds (None where the
        allocator snapshot does not name pools)."""
        pool = tuple(self.pool)
        segments = torch.cuda.memory_snapshot()
        if segments and "segment_pool_id" not in segments[0]:
            return None
        return sum(s["total_size"] for s in segments
                   if tuple(s["segment_pool_id"]) == pool)

    def free(self) -> None:
        """Drop every graph, its static tensors and the pool's memory
        (the caller has waited for the engine's streams)."""
        self.freed = True
        for bg in self._graphs.values():
            bg.graph.reset()
        self._graphs.clear()
        torch.cuda.empty_cache()

    def close(self) -> None:
        """Destroy the capture stream, once a capture that is running
        has finished (it then finds the graphs freed). Call it after
        :meth:`free`, without holding the engine's device lock, which a
        capture takes."""
        with self._stream_lock:
            if streams.is_live(self.stream):
                self.stream.synchronize()
                streams.destroy(self.stream)
