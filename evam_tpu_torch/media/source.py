"""Frame sources — the ``{auto_source}`` resolution layer
(counterpart of ``evam_tpu/media/source.py``).

Ported: the deterministic ``synthetic://`` source (with its real-time
pacing), ``FileSource`` (file / RTSP / HTTP URIs through OpenCV, which
is imported only when a stream opens — a machine without ``cv2``, such
as the card's, fails that instance with an error naming ``cv2``), and
:func:`create_source`. Webcam, GigE, application and audio sources
raise naming the slice that brings them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Protocol

import numpy as np

from evam_tpu_torch import slices

NS = 1_000_000_000


@dataclass
class FrameEvent:
    """One decoded frame entering the pipeline."""

    frame: np.ndarray | None  # BGR uint8 [H, W, 3]
    pts_ns: int        # presentation timestamp, ns
    seq: int


class VideoSource(Protocol):
    def frames(self) -> Iterator[FrameEvent]: ...
    def close(self) -> None: ...


class FileSource:
    """File / RTSP / HTTP source via OpenCV (FFmpeg-backed).

    Counterpart of uridecodebin/decodebin in every reference template
    (e.g. pipelines/object_detection/person/pipeline.json:4).
    """

    def __init__(self, uri: str, loop: bool = False, realtime: bool = False):
        self.uri = uri
        self.loop = loop
        self.realtime = realtime
        self._cap = None
        self._closed = False

    def _open(self):
        import cv2

        path = self.uri
        for prefix in ("file://",):
            if path.startswith(prefix):
                path = path[len(prefix):]
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open source {self.uri}")
        return cap

    def frames(self) -> Iterator[FrameEvent]:
        self._cap = self._open()
        fps = self._cap.get(5) or 30.0  # CAP_PROP_FPS
        if fps <= 0 or fps > 1000:
            fps = 30.0
        frame_ns = int(NS / fps)
        seq = 0
        t_wall = time.perf_counter()
        while not self._closed:
            ok, frame = self._cap.read()
            if not ok:
                if self.loop and not self._closed:
                    self._cap.release()
                    self._cap = self._open()
                    continue
                break
            yield FrameEvent(frame=frame, pts_ns=seq * frame_ns, seq=seq)
            seq += 1
            if self.realtime:
                t_wall += 1.0 / fps
                delay = t_wall - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
        if self._cap is not None:
            self._cap.release()

    def close(self) -> None:
        self._closed = True


class SyntheticSource:
    """Deterministic generated stream (``synthetic://WxH@fps?count=&seed=``):
    a moving bright square on a dark background."""

    def __init__(
        self,
        width: int = 768,
        height: int = 432,
        fps: float = 30.0,
        count: int | None = None,
        realtime: bool = False,
        seed: int = 0,
    ):
        self.width, self.height, self.fps = width, height, fps
        self.count = count
        self.realtime = realtime
        self.seed = seed
        self._closed = False

    @classmethod
    def from_uri(cls, uri: str, realtime: bool = False) -> "SyntheticSource":
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
            realtime=realtime,
        )

    def frames(self) -> Iterator[FrameEvent]:
        frame_ns = int(NS / self.fps)
        base = np.full((self.height, self.width, 3), 16, np.uint8)
        sq = max(8, min(self.height, self.width) // 8)
        seq = 0
        t_wall = time.perf_counter()
        while not self._closed and (self.count is None or seq < self.count):
            frame = base.copy()
            x = (self.seed * 37 + seq * 7) % max(1, self.width - sq)
            y = (self.seed * 53 + seq * 5) % max(1, self.height - sq)
            frame[y : y + sq, x : x + sq] = (64, 160, 240)
            yield FrameEvent(frame=frame, pts_ns=seq * frame_ns, seq=seq)
            seq += 1
            if self.realtime:
                t_wall += 1.0 / self.fps
                delay = t_wall - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)

    def close(self) -> None:
        self._closed = True


#: request source types the reference resolves that come with later
#: slices
_LATER_TYPES = {
    "webcam": slices.INGEST_EGRESS,
    "gige": slices.INGEST_EGRESS,
    "application": slices.INGEST_EGRESS,
}


def check_source(source_cfg: dict) -> None:
    """Raise ``NotImplementedError`` for a source that comes with a
    later slice — called when a start request arrives, so the request
    fails (501) before any resource is opened."""
    stype = source_cfg.get("type", "uri")
    if stype in _LATER_TYPES:
        raise NotImplementedError(
            f"source type '{stype}' comes with {_LATER_TYPES[stype]}")
    uri = str(source_cfg.get("uri", ""))
    if stype in ("uri", "file") and (uri.startswith("synthetic-audio://")
                                     or uri.endswith(".wav")):
        raise NotImplementedError(
            f"audio sources come with {slices.ACTION_AUDIO}")


def create_source(source_cfg: dict, realtime: bool = False) -> VideoSource:
    """Resolve a request ``source`` object into a VideoSource.

    Mirrors the reference request schema
    ``{"source": {"uri": ..., "type": "uri"}}``
    (charts/templates/NOTES.txt:9-13).
    """
    check_source(source_cfg)
    stype = source_cfg.get("type", "uri")
    if stype in ("uri", "file"):
        uri = source_cfg["uri"]
        if uri.startswith("synthetic://"):
            return SyntheticSource.from_uri(uri, realtime=realtime)
        return FileSource(
            uri,
            loop=bool(source_cfg.get("loop", False)),
            realtime=realtime or bool(source_cfg.get("realtime", False)),
        )
    raise ValueError(f"unsupported source type '{stype}'")
