"""Frame sources — the ``{auto_source}`` resolution layer
(counterpart of ``evam_tpu/media/source.py``).

Ported: the deterministic ``synthetic://`` source (with its real-time
pacing); ``FileSource``; the audio sources of ``media/audio.py``
(``synthetic-audio://`` and ``*.wav``); ``rtsp://`` URIs through
:class:`~evam_tpu_torch.media.demux.RtspSource` (the demux with one
stream and one decode worker: the reference reads them with cv2); the
application source ``AppSource`` (frames an embedder pushes: the EII
manager's message-bus ingest); ``WebcamSource`` and ``GigeSource``
(with cv2, and harvesters where installed, imported when the stream
opens); and :func:`create_source`.

``FileSource`` decodes two kinds of file without cv2: Annex-B H.264
(``.h264``, ``.264``) in the I_PCM dialect ``media/h264.py`` writes, and
MJPEG (``.mjpeg``, ``.mjpg``: concatenated JFIF) through the port's JPEG
codec. Any other file, and an H.264 access unit that is not I_PCM, goes
through ``cv2.VideoCapture`` as in the reference, and fails naming
``cv2`` where it is missing. A port note: those two kinds give the
pixels of the reference's demux path (``cv2.cvtColor``,
``cv2.imdecode``), not of FFmpeg's converter behind
``cv2.VideoCapture``; their rate is 25 fps, the rate FFmpeg reports for
a raw stream without timing.
"""

from __future__ import annotations

import logging
import mmap
import os
import queue
import time
from dataclasses import dataclass
from typing import Iterator, Protocol

import numpy as np

log = logging.getLogger("evam_tpu_torch.media.source")

NS = 1_000_000_000


@dataclass
class FrameEvent:
    """One decoded frame (or audio chunk) entering the pipeline."""

    frame: np.ndarray | None  # BGR uint8 [H, W, 3]; None for audio
    pts_ns: int        # presentation timestamp, ns
    seq: int
    audio: np.ndarray | None = None  # S16LE mono 16 kHz chunk
    #: seconds the source spent decoding this frame, where it measures
    #: them (the runner backdates a ``decode`` span by it)
    decode_s: float | None = None


class VideoSource(Protocol):
    def frames(self) -> Iterator[FrameEvent]: ...
    def close(self) -> None: ...


#: file suffixes FileSource decodes without cv2
_ANNEXB = (".h264", ".264")
_MJPEG = (".mjpeg", ".mjpg")
#: FFmpeg's rate for a raw elementary stream without timing (what
#: ``cv2.VideoCapture`` reports for these files)
RAW_STREAM_FPS = 25.0


def _split_jfif(data) -> Iterator[bytes]:
    """Concatenated JFIF images → one bytes object each, one at a time
    (``data`` is ``bytes`` or an ``mmap``). Walks each image's marker
    segments (an APP segment may hold a whole thumbnail JPEG) and its
    entropy-coded data (where a 0xFF byte is stuffed or starts a restart
    marker) to its EOI."""
    start = data.find(b"\xff\xd8")
    while start >= 0:
        pos = start + 2
        while pos + 4 <= len(data) and data[pos] == 0xFF:
            marker = data[pos + 1]
            if marker == 0xD9:                      # EOI
                pos += 2
                break
            if marker == 0xFF or 0xD0 <= marker <= 0xD7 or marker == 0x01:
                pos += 1 if marker == 0xFF else 2   # fill, RSTn, TEM
                continue
            pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
            if marker == 0xDA:                      # SOS: to the next marker
                while True:
                    pos = data.find(b"\xff", pos)
                    if pos < 0 or pos + 1 >= len(data):
                        pos = len(data)
                        break
                    if data[pos + 1] == 0 or 0xD0 <= data[pos + 1] <= 0xD7:
                        pos += 2
                        continue
                    break
        else:
            pos = len(data)                         # cut short: keep it
        yield data[start:pos]
        start = data.find(b"\xff\xd8", pos)


def _access_units(data) -> Iterator[bytes]:
    """An Annex-B stream (``bytes`` or an ``mmap``) → self-contained
    access units, one at a time: each picture's slice NAL led by the
    latest SPS and PPS."""
    from evam_tpu_torch.media.h264 import iter_annexb

    sps = pps = b""
    for nal in iter_annexb(data):
        kind = nal[0] & 0x1F
        if kind == 7:
            sps = b"\x00\x00\x00\x01" + nal
        elif kind == 8:
            pps = b"\x00\x00\x00\x01" + nal
        elif kind in (1, 5):
            yield sps + pps + b"\x00\x00\x00\x01" + nal


def _map_file(path: str):
    """The file's bytes as a read-only ``mmap`` (``b""`` when empty):
    its pages come and go with the page cache, so a long recording is
    read one frame at a time and never held whole."""
    with open(path, "rb") as fh:
        if os.fstat(fh.fileno()).st_size == 0:
            return b""
        return mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)


class FileSource:
    """File / HTTP source (counterpart of uridecodebin/decodebin in
    every reference template, e.g.
    pipelines/object_detection/person/pipeline.json:4): Annex-B I_PCM
    H.264 and MJPEG files without cv2, anything else through OpenCV
    (FFmpeg-backed), imported when the stream opens."""

    def __init__(self, uri: str, loop: bool = False, realtime: bool = False):
        self.uri = uri
        self.loop = loop
        self.realtime = realtime
        self._cap = None
        self._map = None
        self._closed = False

    def _path(self) -> str:
        path = self.uri
        for prefix in ("file://",):
            if path.startswith(prefix):
                path = path[len(prefix):]
        return path

    def _open(self):
        import cv2

        cap = cv2.VideoCapture(self._path())
        if not cap.isOpened():
            raise IOError(f"cannot open source {self.uri}")
        return cap

    def _decoded(self):
        """Frames of an Annex-B or MJPEG file decoded here, or None for
        a file that is neither. An access unit that is not I_PCM hands
        the rest of the file to cv2, from the frame it stopped at."""
        path = self._path().lower()
        if not path.endswith(_ANNEXB + _MJPEG):
            return None
        self._map = data = _map_file(self._path())
        if path.endswith(_MJPEG):
            from evam_tpu_torch.media import jpeg

            return (jpeg.decode(j) for j in _split_jfif(data))
        return self._annexb_frames(data)

    def _annexb_frames(self, data: bytes):
        from evam_tpu_torch.media.h264 import decode_ipcm_au

        done = 0
        for au in _access_units(data):
            frame = decode_ipcm_au(au)
            if frame is None:
                break
            yield frame
            done += 1
        else:
            return
        self._cap = self._open()
        for _ in range(done):
            self._cap.read()
        while not self._closed:
            ok, frame = self._cap.read()
            if not ok:
                break
            yield frame

    def _read_all(self):
        """One pass over the file: (frames iterator, fps)."""
        decoded = self._decoded()
        if decoded is not None:
            return decoded, RAW_STREAM_FPS
        self._cap = self._open()
        fps = self._cap.get(5) or 30.0  # CAP_PROP_FPS
        if fps <= 0 or fps > 1000:
            fps = 30.0

        def read():
            while not self._closed:
                ok, frame = self._cap.read()
                if not ok:
                    return
                yield frame

        return read(), fps

    def frames(self) -> Iterator[FrameEvent]:
        try:
            it, fps = self._read_all()
            frame_ns = int(NS / fps)
            seq = 0
            t_wall = time.perf_counter()
            while not self._closed:
                frame = next(it, None)
                if frame is None:
                    if self.loop and not self._closed:
                        self._release()
                        it, _ = self._read_all()
                        continue
                    break
                yield FrameEvent(frame=frame, pts_ns=seq * frame_ns, seq=seq)
                seq += 1
                if self.realtime:
                    t_wall += 1.0 / fps
                    delay = t_wall - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
        finally:  # an abandoned iterator lets go of its file too
            self._release()

    def _release(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        if isinstance(self._map, mmap.mmap):
            self._map.close()
        self._map = None

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


class WebcamSource(FileSource):
    """Live camera source (reference docker/run.sh webcam probe,
    :107-113): a cv2 camera index instead of a URI; cv2 is imported
    when the stream opens."""

    def __init__(self, index: int = 0):
        super().__init__(uri=str(index), realtime=False)
        self.index = index

    def _open(self):
        import cv2

        cap = cv2.VideoCapture(self.index)
        if not cap.isOpened():
            raise IOError(f"cannot open camera {self.index}")
        return cap


def gige_frame_to_bgr(data: np.ndarray, pixel_format: str) -> np.ndarray:
    """GenICam pixel-format → BGR uint8 (pure helper, unit-testable
    without camera hardware)."""
    import cv2

    fmt = pixel_format.lower()
    if fmt in ("mono8", "mono"):
        return cv2.cvtColor(data, cv2.COLOR_GRAY2BGR)
    if fmt.startswith("bayerrg"):
        return cv2.cvtColor(data, cv2.COLOR_BAYER_RG2BGR)
    if fmt.startswith("bayergb"):
        return cv2.cvtColor(data, cv2.COLOR_BAYER_GB2BGR)
    if fmt.startswith("bayergr"):
        return cv2.cvtColor(data, cv2.COLOR_BAYER_GR2BGR)
    if fmt.startswith("bayerbg"):
        return cv2.cvtColor(data, cv2.COLOR_BAYER_BG2BGR)
    if fmt in ("rgb8", "rgb"):
        return cv2.cvtColor(data, cv2.COLOR_RGB2BGR)
    if fmt in ("bgr8", "bgr"):
        return data
    raise ValueError(f"unsupported GenICam pixel format {pixel_format!r}")


class GigeSource:
    """GenICam / GigE Vision camera source — the gencamsrc counterpart
    (reference resolves ``{auto_source}`` to gencamsrc for gige
    cameras; EII compose wires GENICAM + ``GST_DEBUG gencamsrc``,
    reference eii/docker-compose.yml:59).

    Backends, tried in order:

    1. **harvesters** (GenICam GenTL consumer; needs a ``.cti``
       producer from the camera vendor, path via ``cti`` property or
       ``GENICAM_GENTL64_PATH``);
    2. **cv2 + GStreamer** (``aravissrc``/``gencamsrc`` pipeline
       string) when OpenCV is built with GStreamer.

    Both are imported when the stream opens, and ``frames()`` raises
    an error naming both options where neither is there (the card's
    machine has neither) — the request contract (``source.type:
    "gige"`` + serial/pixel-format properties) is stable either way.
    """

    def __init__(self, serial: str | None = None,
                 pixel_format: str = "BayerRG8",
                 cti: str | None = None):
        self.serial = serial
        self.pixel_format = pixel_format
        self.cti = cti
        self._ia = None        # harvesters image acquirer
        self._cap = None       # cv2 GStreamer capture
        self._closed = False

    def _open(self) -> None:
        import os as _os

        h = None
        try:
            from harvesters.core import Harvester  # type: ignore

            h = Harvester()
            cti = self.cti or _os.environ.get("GENICAM_GENTL64_PATH")
            if cti:
                for p in cti.split(":"):
                    h.add_file(p)
            h.update()
            self._ia = h.create_image_acquirer(
                serial_number=self.serial) if self.serial else \
                h.create_image_acquirer(0)
            self._harvester = h
            self._ia.start_acquisition()
            return
        except Exception as exc:  # noqa: BLE001 — installed-but-no-device
            # falls through to GStreamer: harvesters without a .cti
            # producer or with no camera raises here, not ImportError
            if h is not None:
                h.reset()
            if not isinstance(exc, ImportError):
                log.info("harvesters backend unavailable: %s", exc)

        import cv2

        if "GStreamer" in cv2.getBuildInformation():
            sel = f"serial={self.serial} " if self.serial else ""
            gst = (
                f"aravissrc {sel}! videoconvert ! "
                "video/x-raw,format=BGR ! appsink"
            )
            cap = cv2.VideoCapture(gst, cv2.CAP_GSTREAMER)
            if cap.isOpened():
                self._cap = cap
                return
        raise RuntimeError(
            "no GigE backend available: install a GenICam GenTL "
            "producer (.cti) + the 'harvesters' package, or an OpenCV "
            "build with GStreamer and aravissrc (reference parity: "
            "gencamsrc in the DL Streamer image)"
        )

    def frames(self) -> Iterator[FrameEvent]:
        self._open()
        seq = 0
        packed = self.pixel_format.lower() in ("rgb8", "rgb", "bgr8", "bgr")
        while not self._closed:
            if self._ia is not None:
                with self._ia.fetch_buffer() as buf:
                    comp = buf.payload.components[0]
                    shape = (
                        (comp.height, comp.width, 3) if packed
                        else (comp.height, comp.width)
                    )
                    # copy INSIDE the with-block: fetch_buffer requeues
                    # the GenTL buffer on exit, so a zero-copy view
                    # would be overwritten by the next capture
                    data = np.array(comp.data.reshape(shape), copy=True)
                frame = gige_frame_to_bgr(data, self.pixel_format)
            else:
                ok, frame = self._cap.read()
                if not ok:
                    break
            yield FrameEvent(frame=frame, pts_ns=time.monotonic_ns(), seq=seq)
            seq += 1

    def close(self) -> None:
        self._closed = True
        if self._ia is not None:
            self._ia.stop_acquisition()
            self._ia.destroy()
            self._harvester.reset()
        if self._cap is not None:
            self._cap.release()


class AppSource:
    """Application-injected frames (appsrc / message-bus source):
    callers push numpy frames or raw BGR bytes."""

    def __init__(self, maxsize: int = 64):
        self._queue: queue.Queue = queue.Queue(maxsize=maxsize)
        self._closed = False
        self._seq = 0

    def push(self, frame: np.ndarray, pts_ns: int | None = None) -> None:
        """Never blocks: when the consumer stalls (or died), the oldest
        queued frame is dropped — live-stream semantics, and it keeps
        feeder threads (message-bus ingest) and shutdown deadlock-free."""
        if self._closed:
            raise RuntimeError("source closed")
        if pts_ns is None:
            pts_ns = time.monotonic_ns()
        ev = FrameEvent(frame=frame, pts_ns=pts_ns, seq=self._seq)
        while True:
            try:
                self._queue.put_nowait(ev)
                break
            except queue.Full:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass
        self._seq += 1

    def push_raw(self, data: bytes, width: int, height: int,
                 pts_ns: int | None = None) -> None:
        frame = np.frombuffer(data, np.uint8).reshape(height, width, 3)
        self.push(frame, pts_ns)

    def end(self) -> None:
        # _closed is the end-of-stream signal: frames() re-checks it on
        # every queue timeout, so it cannot be lost even when a
        # concurrent push()'s drop-oldest consumes the in-band None
        # (the sentinel only wakes the reader sooner)
        self._closed = True
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            pass  # frames() sees _closed on its next timeout

    def frames(self) -> Iterator[FrameEvent]:
        while True:
            try:
                ev = self._queue.get(timeout=0.2)
            except queue.Empty:
                if self._closed:
                    break
                continue
            if ev is None:
                if self._closed:
                    break
                continue  # a stale sentinel displaced by a late push
            yield ev

    def close(self) -> None:
        if not self._closed:
            self.end()


def create_source(source_cfg: dict, realtime: bool = False) -> VideoSource:
    """Resolve a request ``source`` object into a VideoSource.

    Mirrors the reference request schema
    ``{"source": {"uri": ..., "type": "uri"}}``
    (charts/templates/NOTES.txt:9-13).
    """
    stype = source_cfg.get("type", "uri")
    if stype in ("uri", "file"):
        uri = source_cfg["uri"]
        if uri.startswith("synthetic://"):
            return SyntheticSource.from_uri(uri, realtime=realtime)
        if uri.startswith("synthetic-audio://"):
            from evam_tpu_torch.media.audio import SyntheticAudioSource

            return SyntheticAudioSource.from_uri(uri)
        if uri.endswith(".wav"):
            from evam_tpu_torch.media.audio import WavSource

            return WavSource(
                uri,
                loop=bool(source_cfg.get("loop", False)),
                realtime=realtime,
            )
        if uri.startswith("rtsp://"):
            # the per-stream blocking reader: the demux with one stream
            # and one decode worker (the reference reads it with cv2)
            from evam_tpu_torch.media.demux import RtspSource

            return RtspSource(uri)
        return FileSource(
            uri,
            loop=bool(source_cfg.get("loop", False)),
            realtime=realtime or bool(source_cfg.get("realtime", False)),
        )
    if stype == "webcam":
        # cv2 needs an int index for camera devices, not a string path
        device = source_cfg.get("device", 0)
        return WebcamSource(int(device))
    if stype == "application":
        return AppSource(maxsize=int(source_cfg.get("queue-size", 64)))
    if stype == "gige":
        # reference {auto_source} resolves gige → gencamsrc
        # (eii/docker-compose.yml:59); properties mirror gencamsrc's
        return GigeSource(
            serial=source_cfg.get("serial"),
            pixel_format=source_cfg.get("pixel-format", "BayerRG8"),
            cti=source_cfg.get("cti"),
        )
    raise ValueError(f"unsupported source type '{stype}'")
