"""Per-frame context flowing through a stream's stage chain.

Counterpart of ``evam_tpu/stages/context.py`` (a copy).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class Tensor:
    """One inference result attached to a region (detection or
    classification attribute)."""

    name: str
    confidence: float
    label_id: int
    label: str = ""
    is_detection: bool = False
    data: list[float] | None = None


@dataclass
class Region:
    """A detected object: normalized [0,1] corners plus the pixel rect
    the published metadata carries."""

    x0: float
    y0: float
    x1: float
    y1: float
    confidence: float
    label_id: int
    label: str
    object_id: int | None = None
    tensors: list[Tensor] = field(default_factory=list)

    def rect(self, width: int, height: int) -> tuple[int, int, int, int]:
        x = int(round(self.x0 * width))
        y = int(round(self.y0 * height))
        w = int(round((self.x1 - self.x0) * width))
        h = int(round((self.y1 - self.y0) * height))
        return x, y, w, h

    @property
    def box(self) -> np.ndarray:
        return np.asarray([self.x0, self.y0, self.x1, self.y1], np.float32)


@dataclass
class FrameContext:
    """State of one frame walking the stage chain."""

    frame: np.ndarray | None  # BGR uint8 [H,W,3]; None for audio
    pts_ns: int
    seq: int
    stream_id: str
    source_uri: str = ""
    #: S16LE mono 16 kHz chunk (audio pipelines)
    audio: np.ndarray | None = None
    regions: list[Region] = field(default_factory=list)
    #: frame-level tensors (action recognition, audio events)
    tensors: list[Tensor] = field(default_factory=list)
    #: JSON messages attached by UDF stages
    messages: list[dict[str, Any]] = field(default_factory=list)
    #: serialized metadata (set by metaconvert)
    metadata: dict[str, Any] | None = None
    #: stage cursor used by the runner
    stage_index: int = 0
    #: wall-clock ingest time (perf_counter) for frame latency
    ingest_t: float | None = None
    #: arbitrary cross-stage scratch
    scratch: dict[str, Any] = field(default_factory=dict)
    #: the stream's QoS class (``sched/``), carried into every submit
    priority: str = "standard"
    #: per-frame trace handle (``obs/trace.py`` FrameTrace), minted at
    #: ingest and threaded into engine submits for the batch↔frame
    #: link; None when EVAM_TRACE=off
    trace: Any | None = None

    @property
    def height(self) -> int:
        return 0 if self.frame is None else int(self.frame.shape[0])

    @property
    def width(self) -> int:
        return 0 if self.frame is None else int(self.frame.shape[1])
