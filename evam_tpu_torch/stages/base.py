"""Stage interfaces (counterpart of ``evam_tpu/stages/base.py``).

Sync stages transform a FrameContext inline; async stages submit work
to a shared BatchEngine and are resumed by the StreamRunner when the
batch holding their item completes.
"""

from __future__ import annotations

from concurrent.futures import Future

import numpy as np

from evam_tpu_torch.stages.context import FrameContext


class Stage:
    """Synchronous stage: ctx in → list of ctx out (0..n)."""

    name: str = "stage"
    is_async = False

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        raise NotImplementedError


class AsyncStage(Stage):
    """Engine-backed stage: submit() returns a Future (or None to skip
    inference for this frame), complete() folds the packed result back
    into the context."""

    is_async = True

    def submit(self, ctx: FrameContext) -> Future | None:
        raise NotImplementedError

    def complete(self, ctx: FrameContext,
                 result: np.ndarray | None) -> list[FrameContext]:
        raise NotImplementedError

    def process(self, ctx: FrameContext) -> list[FrameContext]:
        fut = self.submit(ctx)
        return self.complete(ctx, fut.result() if fut is not None else None)
