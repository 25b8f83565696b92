"""Frame sources (counterpart of ``evam_tpu/media/source.py``).

This slice ports the deterministic ``synthetic://`` source (without
real-time pacing); file, camera and RTSP sources come with the REST
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

NS = 1_000_000_000


@dataclass
class FrameEvent:
    """One decoded frame entering the pipeline."""

    frame: np.ndarray | None  # BGR uint8 [H, W, 3]
    pts_ns: int        # presentation timestamp, ns
    seq: int


class SyntheticSource:
    """Deterministic generated stream (``synthetic://WxH@fps?count=&seed=``):
    a moving bright square on a dark background."""

    def __init__(
        self,
        width: int = 768,
        height: int = 432,
        fps: float = 30.0,
        count: int | None = None,
        seed: int = 0,
    ):
        self.width, self.height, self.fps = width, height, fps
        self.count = count
        self.seed = seed
        self._closed = False

    @classmethod
    def from_uri(cls, uri: str) -> "SyntheticSource":
        # synthetic://640x480@30?count=100&seed=3
        body = uri.split("://", 1)[1]
        params = {}
        if "?" in body:
            body, q = body.split("?", 1)
            params = dict(p.split("=", 1) for p in q.split("&") if "=" in p)
        size, _, fps = body.partition("@")
        w, _, h = size.partition("x")
        return cls(
            width=int(w or 768),
            height=int(h or 432),
            fps=float(fps or 30),
            count=int(params["count"]) if "count" in params else None,
            seed=int(params.get("seed", 0)),
        )

    def frames(self) -> Iterator[FrameEvent]:
        frame_ns = int(NS / self.fps)
        base = np.full((self.height, self.width, 3), 16, np.uint8)
        sq = max(8, min(self.height, self.width) // 8)
        seq = 0
        while not self._closed and (self.count is None or seq < self.count):
            frame = base.copy()
            x = (self.seed * 37 + seq * 7) % max(1, self.width - sq)
            y = (self.seed * 53 + seq * 5) % max(1, self.height - sq)
            frame[y : y + sq, x : x + sq] = (64, 160, 240)
            yield FrameEvent(frame=frame, pts_ns=seq * frame_ns, seq=seq)
            seq += 1

    def close(self) -> None:
        self._closed = True
