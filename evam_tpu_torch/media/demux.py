"""Async RTSP/RTP demux: N live streams on ONE selector thread.

Counterpart of ``evam_tpu/media/demux.py``. The demux owns the socket:
an RTSP client handshake (DESCRIBE/SETUP/PLAY) per stream, then every
connection registers with one ``selectors`` loop that parses
TCP-interleaved RTP (RFC 2326 §10.12) and depacketizes RTP/JPEG
(RFC 2435) and RTP/H.264 (RFC 6184 packetization-mode 1: single NAL,
STAP-A and FU-A reassembled into Annex-B access units) incrementally —
no thread ever blocks on a socket. Complete frames go to a small
decode-worker team that keeps each stream's order by servicing at most
one frame a stream at a time. Threads for N streams = 1 selector +
``decode_workers``, whatever N.

Decode without cv2: JPEG frames through the port's codec
(``media/jpeg.py``), H.264 access units through ``decode_ipcm_au`` (the
I_PCM dialect ``media/h264.py`` writes). Only an H.264 access unit that
is not I_PCM (a camera's CAVLC or CABAC) takes the reference's cv2 file
shim, and fails the stream naming ``cv2`` where it is missing; so does a
codec library that cannot be built. Each event carries ``decode_s``, the
seconds its decode took.

:class:`RtspSource` is the per-stream blocking reader ``create_source``
gives ``rtsp://`` URIs when the shared demux is off: a demux of its own
with one stream and one decode worker.

Consumer contract matches ``PooledStream``: ``frames()`` iterator on
a bounded queue with live drop-oldest semantics, decoded/dropped
counters, ``error``/``finished`` terminal state.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import re
import selectors
import socket
import struct
import threading
import time
from collections import deque
from urllib.parse import urlparse

import numpy as np

from evam_tpu_torch.media import jpeg
from evam_tpu_torch.media.decode import drop_oldest_put
from evam_tpu_torch.media.h264 import decode_ipcm_au
from evam_tpu_torch.media.source import FrameEvent
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.media.demux")

RTP_CLOCK = 90_000

# ---------------------------------------------------------------- JFIF
# Standard JPEG Huffman tables (ITU-T T.81 Annex K.3) — RFC 2435
# streams omit them (every compliant encoder uses these unless it
# optimizes coding, which cv2/libjpeg does not by default), so the
# receiver re-emits them when rebuilding a decodable JFIF.

_DC_LUM_BITS = bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0])
_DC_LUM_VALS = bytes(range(12))
_DC_CHM_BITS = bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
_DC_CHM_VALS = bytes(range(12))
_AC_LUM_BITS = bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D])
_AC_LUM_VALS = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])
_AC_CHM_BITS = bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
_AC_CHM_VALS = bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])


def _dht(table_class: int, table_id: int, bits: bytes,
         vals: bytes) -> bytes:
    body = bytes([(table_class << 4) | table_id]) + bits + vals
    return b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body


# Q < 128 sends NO tables on the wire (RFC 2435 §4.2): both ends
# derive them from Q by scaling the T.81 Annex K.1 example tables
# with libjpeg's quality curve (RFC 2435 Appendix A is that exact
# formula) and storing them in the JPEG zigzag order DQT uses.
# Byte-equal to the reference's (tests/test_torch_h264.py).

_ZIGZAG = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63)
_K1_LUMA = (
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99)
_K1_CHROMA = (
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99)


def rfc2435_qtables(q: int) -> list[bytes]:
    """Quantization tables for an RFC 2435 Q value in 1..127
    (128..255 carry tables in-band instead)."""
    q = max(1, min(int(q), 99))          # 100..127 reserved: clamp
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def mk(base: tuple) -> bytes:
        return bytes(
            min(255, max(1, (base[_ZIGZAG[k]] * scale + 50) // 100))
            for k in range(64))

    return [mk(_K1_LUMA), mk(_K1_CHROMA)]


def reconstruct_jfif(width: int, height: int, qtables: list[bytes],
                     scan: bytes, subsampling: int = 1) -> bytes:
    """Rebuild a decodable baseline JFIF from RFC 2435 pieces — the
    inverse of ``publish/rtsp.parse_jpeg``. ``subsampling`` is the
    RFC 2435 type: 0 → 4:2:2, 1 → 4:2:0."""
    out = bytearray(b"\xff\xd8")                        # SOI
    for i, tbl in enumerate(qtables[:2]):
        out += b"\xff\xdb" + struct.pack(">H", 3 + len(tbl))
        out += bytes([i]) + tbl                          # Pq=0, Tq=i
    cq = 1 if len(qtables) > 1 else 0
    lum_sampling = 0x22 if subsampling == 1 else 0x21
    out += (b"\xff\xc0" + struct.pack(">HBHHB", 17, 8, height, width, 3)
            + bytes([1, lum_sampling, 0])                # Y
            + bytes([2, 0x11, cq])                       # Cb
            + bytes([3, 0x11, cq]))                      # Cr
    out += _dht(0, 0, _DC_LUM_BITS, _DC_LUM_VALS)
    out += _dht(1, 0, _AC_LUM_BITS, _AC_LUM_VALS)
    out += _dht(0, 1, _DC_CHM_BITS, _DC_CHM_VALS)
    out += _dht(1, 1, _AC_CHM_BITS, _AC_CHM_VALS)
    out += (b"\xff\xda" + struct.pack(">HB", 12, 3)
            + bytes([1, 0x00, 2, 0x11, 3, 0x11, 0, 0x3F, 0]))
    out += scan
    out += b"\xff\xd9"                                   # EOI
    return bytes(out)


def _decode_h264_au(au: bytes):
    """Decode ONE self-contained Annex-B access unit (SPS+PPS+slice)
    that is not I_PCM: the reference's shim around cv2.VideoCapture's
    bundled FFmpeg, which reads files, so each AU is written to a
    tmpfs-backed file and opened as a one-frame elementary stream. It
    works only for intra-only streams (every AU self-contained). cv2 is
    imported here and nowhere else in the demux: without it the stream
    fails naming it."""
    import os
    import tempfile

    import cv2

    d = "/dev/shm" if os.path.isdir("/dev/shm") else None
    fd, path = tempfile.mkstemp(suffix=".h264", dir=d)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(au)
        cap = cv2.VideoCapture(path)
        ok, img = cap.read()
        cap.release()
        return img if ok else None
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def _decode(kind: str, data: bytes):
    """One frame's bytes → BGR, or None for an undecodable frame (the
    reference's ``cv2.imdecode`` returning None). Raises for what fails
    the stream: a codec library that cannot be built, cv2 missing for a
    non-I_PCM access unit."""
    if kind == "h264":
        # fast path first: the I_PCM dialect decodes in one numpy
        # stride pass; anything else (real cameras) takes the shim
        img = decode_ipcm_au(data)
        return img if img is not None else _decode_h264_au(data)
    try:
        return jpeg.decode(data)
    except ValueError:
        return None


def _parse_sdp_media(sdp: str) -> dict:
    """Pull the video payload type + codec + control URL out of a
    DESCRIBE SDP. Static PT 26 = RFC 2435 JPEG; dynamic PTs resolve
    via rtpmap (H264/90000 → the RFC 6184 path). ``a=control:`` is
    tracked at both session level (before any m= line) and video
    media level — media-level wins (RFC 2326 §C.1; real cameras
    advertise trackID-style control URLs)."""
    pt = 26
    codec = "jpeg"
    session_control: str | None = None
    media_control: str | None = None
    in_media = False
    in_video = False
    for line in sdp.splitlines():
        line = line.strip()
        if line.startswith("m="):
            in_media = True
            in_video = line.startswith("m=video")
        if line.lower().startswith("a=control:"):
            val = line.split(":", 1)[1].strip()
            if not in_media:
                session_control = val
            elif in_video and media_control is None:
                media_control = val
            continue
        if line.startswith("m=video"):
            parts = line.split()
            if len(parts) >= 4:
                try:
                    pt = int(parts[3])
                except ValueError:
                    pass
            codec = "jpeg" if pt == 26 else "unknown"
        elif line.lower().startswith(f"a=rtpmap:{pt} "):
            enc = line.split(" ", 1)[1].split("/")[0].strip().upper()
            if enc == "H264":
                codec = "h264"
            elif enc in ("JPEG", "MJPEG"):
                codec = "jpeg"
        elif (line.lower().startswith(f"a=fmtp:{pt} ")
              and "packetization-mode" in line):
            # only mode 0/1 (non-interleaved) is reassembled here;
            # mode 2 (STAP-B/MTAP/FU-B) must be rejected at
            # add_stream, not discovered as a silent stall
            mode = line.split("packetization-mode=", 1)[1]
            if mode.split(";")[0].strip() not in ("0", "1"):
                codec = "unknown"
    return {"pt": pt, "codec": codec,
            "control": media_control or session_control}


def _resolve_control(base: str, control: str | None) -> str:
    """SETUP target from the SDP control attribute, resolved against
    the Content-Base/request URL (RFC 2326 §C.1.1):

    * absolute control → use it verbatim;
    * ``*`` → aggregate control on the base itself;
    * relative (``trackID=1``, ``streamid=0``) → appended to base;
    * absent → the legacy ``streamid=0`` guess, which matches our own
      RtspServer and the streamid-style servers the old hardcoded
      path worked against.
    """
    if control is None:
        return base.rstrip("/") + "/streamid=0"
    if control == "*":
        return base.rstrip("/")
    if "://" in control:
        return control
    return base.rstrip("/") + "/" + control.lstrip("/")


# -------------------------------------------------------------- stream

class DemuxStream:
    """One live stream's registration — same consumer contract as
    ``PooledStream`` (bounded queue, ``frames()`` facade, counters),
    fed by the demux selector + decode workers instead of a reader
    thread."""

    def __init__(self, stream_id: str, url: str, maxsize: int = 8,
                 max_pending: int = 4):
        self.stream_id = stream_id
        self.url = url
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=maxsize)
        self.frames_decoded = 0
        #: drop counters by stage, so a drop budget says which side
        #: fell behind:
        #: * ``frames_dropped_decode`` — queue-side, taken on the
        #:   selector thread under the demux lock: the shared decode
        #:   workers are behind (decode-bound);
        #: * ``frames_dropped_downstream`` — emit-side, touched only
        #:   by the single decode worker servicing this stream at a
        #:   time (per-stream order guarantee), so it needs no lock:
        #:   the consumer (runner/engine) is behind (engine-bound).
        self.frames_dropped_decode = 0
        self.frames_dropped_downstream = 0
        self.error: str | None = None
        self.finished = False
        self.sock: socket.socket | None = None
        self._demux: "RtspDemux | None" = None
        # ---- selector-side state (touched only by the demux thread)
        self._buf = bytearray()      # raw TCP bytes
        self._scan = bytearray()     # current frame's entropy scan
        self._qtables: list[bytes] = []
        self._qtable_q = -1          # Q the derived tables were built for
        self._dims = (0, 0)
        self._last_ts32 = -1         # RTP timestamp unwrap state
        self._ts_ext = 0
        self._codec = "jpeg"         # from the DESCRIBE SDP
        self._pt = 26
        #: interleaved channel pair from the server's Transport reply
        #: (SETUP may assign other than the requested 0-1)
        self._rtp_ch = 0
        self._rtcp_ch = 1
        # ---- RFC 6184 reassembly state (h264 streams)
        self._nals: list[bytes] = []   # current access unit's NALs
        self._fu: bytearray | None = None   # in-flight FU-A NAL
        self._sps: bytes | None = None      # cached parameter sets
        self._pps: bytes | None = None
        self._frame_corrupt = False
        self._seq = 0
        # ---- decode-side state (guarded by the demux lock)
        self._jpegs: deque = deque()          # complete frames waiting
        self._max_pending = max_pending
        self._scheduled = False
        self._eof = False
        self._removed = False
        #: selector-side teardown already ran (close may be requested
        #: from several paths — instance.stop AND the runner's
        #: finally both close; teardown must be idempotent)
        self._gone = False

    @property
    def frames_dropped(self) -> int:
        """Total drops (both stages) — the ``PooledStream`` contract."""
        return self.frames_dropped_decode + self.frames_dropped_downstream

    def frames(self):
        """Drain until EOS — drop-in for ``VideoSource.frames()``."""
        while True:
            ev = self.queue.get()
            if ev is None:
                return
            yield ev

    def close(self) -> None:
        """Consumer-side teardown. MUST route through the selector
        thread: closing a registered fd here would silently drop it
        from the epoll set (no EOF event ever fires) AND leave a
        stale entry in the selector's fd map that poisons the next
        stream whose socket reuses the fd number."""
        self._removed = True
        demux = self._demux
        if demux is not None:
            demux._request_close(self)

    # pool-side emit (decode workers; at most one per stream at a
    # time, so the downstream counter has a single writer)
    def _emit(self, ev: FrameEvent) -> None:
        self.frames_decoded += 1
        metrics.inc("evam_frames_decoded",
                    labels={"stream": self.stream_id})
        dropped = drop_oldest_put(self.queue, ev)   # live: newest wins
        if dropped:
            self.frames_dropped_downstream += dropped
            metrics.inc("evam_frames_dropped", dropped,
                        labels={"stream": self.stream_id,
                                "stage": "downstream"})

    def _finish(self, error: str | None) -> None:
        if self.finished:
            return
        self.error = self.error or error
        self.finished = True
        drop_oldest_put(self.queue, None)


# --------------------------------------------------------------- demux

class RtspDemux:
    """N live RTSP streams through 1 selector thread + M decoders.

    ``add_stream`` performs the (blocking, timeout-bounded) RTSP
    handshake, then hands the socket to the selector; everything
    after that is non-blocking. Per-stream frame order is preserved:
    a stream has at most one frame in decode at any moment.
    """

    def __init__(self, decode_workers: int = 2,
                 connect_timeout_s: float = 5.0):
        if decode_workers < 1:
            raise ValueError("decode_workers must be >= 1")
        self.connect_timeout_s = connect_timeout_s
        self._sel = selectors.DefaultSelector()
        self._lock = threading.Lock()
        self._streams: list[DemuxStream] = []
        #: counters of retired (finished) streams so stats() stays
        #: cumulative without keeping dead DemuxStream objects alive
        self._retired_decoded = 0
        self._retired_dropped_decode = 0
        self._retired_dropped_downstream = 0
        #: seconds the decode workers spent in the decode call, by codec
        #: (over the workers' wall time: how busy they are)
        self._decode_s = {"jpeg": 0.0, "h264": 0.0}
        #: consumer-side closes waiting for the selector thread
        self._to_close: list[DemuxStream] = []
        self._ready: "queue_mod.Queue" = queue_mod.Queue()
        self._stop = threading.Event()
        # self-pipe so add_stream/stop can wake the selector
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._sel_thread = threading.Thread(
            target=self._select_loop, name="rtsp-demux", daemon=True)
        self._sel_thread.start()
        self._workers = [
            threading.Thread(target=self._decode_loop,
                             name=f"rtsp-demux-dec-{i}", daemon=True)
            for i in range(decode_workers)
        ]
        for t in self._workers:
            t.start()

    # ------------------------------------------------------- lifecycle

    def add_stream(self, url: str, stream_id: str | None = None,
                   maxsize: int = 8) -> DemuxStream:
        if self._stop.is_set():
            raise RuntimeError("demux is stopped")
        ps = DemuxStream(stream_id or url, url, maxsize=maxsize)
        ps._demux = self
        sock, residue, media = self._handshake(url)
        if media["codec"] == "unknown":
            sock.close()
            raise IOError(
                f"unsupported RTSP media (payload type {media['pt']}) "
                "— the demux speaks RFC 2435 JPEG and RFC 6184 H.264; "
                "unset EVAM_RTSP_DEMUX_WORKERS for this camera")
        ps._codec = media["codec"]
        ps._pt = media["pt"]
        ps._rtp_ch, ps._rtcp_ch = media.get("channels", (0, 1))
        sock.setblocking(False)
        ps.sock = sock
        ps._buf.extend(residue)   # interleaved data behind the PLAY 200
        with self._lock:
            # re-check: stop() may have run during the blocking
            # handshake — registering on a closed selector raises
            # ValueError and would leak the registry entry
            if self._stop.is_set():
                sock.close()
                raise RuntimeError("demux is stopped")
            self._streams.append(ps)
        try:
            self._sel.register(sock, selectors.EVENT_READ, ps)
            self._wake_w.send(b"x")
        except (ValueError, KeyError, OSError) as exc:
            with self._lock:
                if ps in self._streams:
                    self._streams.remove(ps)
            sock.close()
            raise RuntimeError(f"demux is stopping: {exc}") from exc
        return ps

    def stop(self) -> None:
        self._stop.set()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        self._sel_thread.join(timeout=10)
        self._ready.put(None)
        for t in self._workers:
            t.join(timeout=10)
        with self._lock:
            streams = list(self._streams)
        for ps in streams:
            # the selector thread is gone: direct teardown is safe now
            ps._removed = True
            sock = ps.sock
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            ps._finish("demux stopped")
            self._retire(ps)

    def _request_close(self, ps: DemuxStream) -> None:
        """Hand a consumer-side close to the selector thread (epoll
        teardown must happen where the registration lives). Falls
        back to direct teardown when the selector is already gone."""
        with self._lock:
            if not self._stop.is_set():
                self._to_close.append(ps)
                try:
                    self._wake_w.send(b"x")
                except OSError:
                    pass
                return
        # demux stopped: no selector thread to do it
        sock = ps.sock
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        ps._finish(ps.error)
        self._retire(ps)

    def _retire(self, ps: DemuxStream) -> None:
        """Drop a FINISHED stream from the registry, folding its
        counters into the cumulative totals (long-lived servers churn
        streams; dead objects must not accumulate)."""
        with self._lock:
            if ps in self._streams:
                self._streams.remove(ps)
                self._retired_decoded += ps.frames_decoded
                self._retired_dropped_decode += ps.frames_dropped_decode
                self._retired_dropped_downstream += (
                    ps.frames_dropped_downstream)

    # ------------------------------------------------------- handshake

    def _handshake(self, url: str) -> tuple[socket.socket, bytes, dict]:
        """Minimal RTSP client: DESCRIBE → SETUP (TCP interleaved) →
        PLAY against ``rtsp://host:port/path``. Returns the socket,
        any interleaved bytes that trailed the PLAY 200, and media
        info from the SDP ({"codec": "jpeg"|"h264", "pt": int})."""
        u = urlparse(url)
        host, port = u.hostname, u.port or 554
        sock = socket.create_connection(
            (host, port), timeout=self.connect_timeout_s)
        sock.settimeout(self.connect_timeout_s)
        buf = bytearray()

        def request(method: str, target: str, cseq: int,
                    extra: str = "") -> dict:
            msg = f"{method} {target} RTSP/1.0\r\nCSeq: {cseq}\r\n"
            if extra:
                msg += extra if extra.endswith("\r\n") else extra + "\r\n"
            msg += "\r\n"
            sock.sendall(msg.encode("latin-1"))
            while b"\r\n\r\n" not in buf:
                chunk = sock.recv(4096)
                if not chunk:
                    raise IOError("rtsp server closed during handshake")
                buf.extend(chunk)
            head, _, rest = bytes(buf).partition(b"\r\n\r\n")
            del buf[:len(head) + 4]
            lines = head.decode("latin-1").split("\r\n")
            if " 200 " not in lines[0] + " ":
                raise IOError(f"rtsp {method} failed: {lines[0]}")
            headers = {
                k.strip().lower(): v.strip()
                for k, v in (l.split(":", 1) for l in lines[1:]
                             if ":" in l)
            }
            # drain any Content-Length body (the SDP)
            body_len = int(headers.get("content-length", "0"))
            while len(buf) < body_len:
                chunk = sock.recv(4096)
                if not chunk:
                    raise IOError("rtsp server closed mid-body")
                buf.extend(chunk)
            headers["_body"] = bytes(buf[:body_len]).decode("latin-1")
            del buf[:body_len]
            return headers

        try:
            d = request("DESCRIBE", url, 1, "Accept: application/sdp")
            media = _parse_sdp_media(d.get("_body", ""))
            # control URL per the SDP, resolved against Content-Base
            # (real cameras advertise trackID=N; a hardcoded
            # streamid=0 fails their SETUP)
            base = d.get("content-base") or d.get("content-location") or url
            h = request(
                "SETUP", _resolve_control(base, media.get("control")), 2,
                "Transport: RTP/AVP/TCP;unicast;interleaved=0-1")
            # honor the server's channel assignment instead of
            # assuming the requested 0-1 came back
            m = re.search(r"interleaved=(\d+)-(\d+)",
                          h.get("transport", ""))
            media["channels"] = ((int(m.group(1)), int(m.group(2)))
                                 if m else (0, 1))
            session = h.get("session", "0").split(";")[0]
            request("PLAY", url, 3, f"Session: {session}")
        except Exception:
            sock.close()
            raise
        # interleaved data may already trail the PLAY 200 in the same
        # TCP segments — hand it back so no bytes are lost
        return sock, bytes(buf), media

    # -------------------------------------------------------- selector

    def _select_loop(self) -> None:
        while not self._stop.is_set():
            events = self._sel.select(timeout=0.5)
            # consumer-side closes, executed HERE so unregister
            # precedes close (epoll registration hygiene)
            with self._lock:
                to_close, self._to_close = self._to_close, []
            for ps in to_close:
                if ps.sock is not None:
                    try:
                        self._socket_gone(ps.sock, ps, None)
                    except Exception:  # noqa: BLE001
                        log.exception("demux close of %s failed",
                                      ps.stream_id)
            for key, _mask in events:
                if key.data is None:            # wake pipe
                    try:
                        self._wake_r.recv(4096)
                    except OSError:
                        pass
                    continue
                try:
                    self._service_socket(key.fileobj, key.data)
                except Exception:  # noqa: BLE001
                    # one stream's parse must never kill ingest for
                    # every stream — fail that stream, keep looping
                    log.exception("demux stream %s failed",
                                  key.data.stream_id)
                    try:
                        self._socket_gone(
                            key.fileobj, key.data, "demux parse error")
                    except Exception:  # noqa: BLE001
                        pass
        # teardown: unregister everything
        for key in list(self._sel.get_map().values()):
            try:
                self._sel.unregister(key.fileobj)
            except (KeyError, OSError):
                pass
        self._sel.close()

    def _service_socket(self, sock, ps: DemuxStream) -> None:
        try:
            data = sock.recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return
        except OSError as exc:
            self._socket_gone(sock, ps,
                              None if ps._removed else str(exc))
            return
        if not data:
            self._socket_gone(
                sock, ps, None if ps._removed else "rtsp EOF")
            return
        ps._buf.extend(data)
        self._drain_buffer(ps)

    def _socket_gone(self, sock, ps: DemuxStream,
                     error: str | None) -> None:
        if ps._gone:
            return
        ps._gone = True
        try:
            self._sel.unregister(sock)
        except (KeyError, ValueError, OSError):
            # ValueError: fd already -1 (closed) — unregister of an
            # already-torn-down socket must never kill the selector
            pass
        try:
            sock.close()
        except OSError:
            pass
        if error:
            metrics.inc("evam_stream_errors",
                        labels={"stream": ps.stream_id})
        with self._lock:
            ps._eof = True
            ps.error = ps.error or error
            deliver_now = not ps._scheduled and not ps._jpegs
        if deliver_now:
            ps._finish(ps.error)
            self._retire(ps)

    def _drain_buffer(self, ps: DemuxStream) -> None:
        buf = ps._buf
        while True:
            if len(buf) < 4:
                return
            if buf[0] != 0x24:                  # not '$': RTSP msg
                end = bytes(buf).find(b"\r\n\r\n")
                if end < 0:
                    if len(buf) > 65536:
                        self._socket_gone(
                            ps.sock, ps, "rtsp framing lost")
                    return
                del buf[:end + 4]               # skip server notices
                continue
            length = (buf[2] << 8) | buf[3]
            if len(buf) < 4 + length:
                return
            channel = buf[1]
            if ps._fu is not None and self._drain_fu_a(ps):
                continue
            pkt = bytes(buf[4:4 + length])
            del buf[:4 + length]
            if channel == ps._rtp_ch:      # RTCP rides ps._rtcp_ch
                self._on_rtp(ps, pkt)

    @staticmethod
    def _drain_fu_a(ps: DemuxStream) -> bool:
        """The bulk of an H.264 stream's packets at once: a run of
        equal-length FU-A fragments at the head of the buffer that
        neither start nor end their NAL, without marker, padding,
        extension or CSRCs, at an unchanged timestamp, for which
        ``_on_rtp`` would only append the payload. Checks their headers
        as rows of one array (a 720p I_PCM frame is a thousand packets,
        too many for a Python loop on the selector thread) and appends
        their payloads; True when it took any."""
        buf = ps._buf
        n = len(buf)
        if n < 18 or buf[0] != 0x24 or ps._last_ts32 < 0:
            return False
        length = (buf[2] << 8) | buf[3]
        stride = 4 + length
        rows = n // stride
        if length < 14 or rows == 0:
            return False
        head = np.frombuffer(buf, np.uint8, count=rows * stride).reshape(
            rows, stride)
        ok = ((head[:, 0] == 0x24) & (head[:, 1] == ps._rtp_ch)
              & (head[:, 2] == length >> 8) & (head[:, 3] == length & 0xFF)
              & (head[:, 4] == 0x80) & (head[:, 5] == ps._pt)
              & ((head[:, 16] & 0x1F) == 28) & ((head[:, 17] & 0xC0) == 0)
              & (head[:, 8:12] == np.frombuffer(
                  ps._last_ts32.to_bytes(4, "big"), np.uint8)).all(1))
        take = rows if ok.all() else int(ok.argmin())
        if take:
            ps._fu += np.ascontiguousarray(head[:take, 18:]).reshape(-1).data
        del head  # the view pins the buffer's size
        if take:
            del buf[:take * stride]
        return take > 0

    def _on_rtp(self, ps: DemuxStream, pkt: bytes) -> None:
        if len(pkt) < 12 or pkt[0] >> 6 != 2:
            return
        pt = pkt[1] & 0x7F
        if pt != ps._pt:
            # not the negotiated payload: fail LOUDLY — silently
            # dropping a codec-switched camera's packets would leave
            # the instance RUNNING forever with zero frames and no
            # visible error
            self._socket_gone(
                ps.sock, ps,
                f"unexpected RTP payload type {pt} (SDP negotiated "
                f"{ps._pt}/{ps._codec}) — unset "
                "EVAM_RTSP_DEMUX_WORKERS for this camera (per-stream "
                "reader handles other codecs via FFmpeg)")
            return
        marker = pkt[1] >> 7
        ts32 = struct.unpack(">I", pkt[4:8])[0]
        # unwrap the 32-bit RTP timestamp (90 kHz wraps every ~13.25 h
        # — a 24/7 camera must not publish a regressing pts)
        if ps._last_ts32 >= 0:
            delta = (ts32 - ps._last_ts32) & 0xFFFFFFFF
            if delta >= 0x80000000:          # backward (reorder) move
                delta -= 1 << 32
            ps._ts_ext += delta
        else:
            ps._ts_ext = ts32
        ps._last_ts32 = ts32
        ts = ps._ts_ext
        # honor the header-extension (X) and padding (P) bits — a
        # camera sending extensions would otherwise have the payload
        # header misparsed on EVERY packet, a zero-frames silent
        # stall. Malformed lengths fail LOUDLY,
        # matching the unsupported-feature policy below.
        off = 12 + 4 * (pkt[0] & 0x0F)          # skip CSRCs
        end = len(pkt)
        if pkt[0] & 0x20:                       # P: trailing padding
            pad = pkt[-1]
            if pad == 0 or off + pad > end:
                self._socket_gone(
                    ps.sock, ps,
                    f"malformed RTP padding (pad={pad}, len={end})")
                return
            end -= pad
        if pkt[0] & 0x10:                       # X: header extension
            if off + 4 > end:
                self._socket_gone(
                    ps.sock, ps, "truncated RTP header extension")
                return
            xwords = struct.unpack(">H", pkt[off + 2:off + 4])[0]
            off += 4 + 4 * xwords
            if off > end:
                self._socket_gone(
                    ps.sock, ps,
                    f"RTP header extension overruns packet "
                    f"({4 * xwords} bytes)")
                return
        payload = pkt[off:end]
        if ps._codec == "h264":
            self._on_rtp_h264(ps, payload, bool(marker), ts)
            return
        if len(payload) < 8:
            return
        # RFC 2435 main JPEG header
        offset = (payload[1] << 16) | (payload[2] << 8) | payload[3]
        jtype, q = payload[4], payload[5]
        width, height = payload[6] * 8, payload[7] * 8
        frag = payload[8:]
        if offset == 0:
            ps._scan.clear()
            ps._frame_corrupt = False
            ps._dims = (width, height)
            if q >= 128:
                if len(frag) < 4:
                    ps._frame_corrupt = True
                    return
                qlen = struct.unpack(">H", frag[2:4])[0]
                qdata = frag[4:4 + qlen]
                ps._qtables = [qdata[i:i + 64]
                               for i in range(0, len(qdata), 64)]
                frag = frag[4 + qlen:]
            else:
                # tables derived from Q (static per Q — cache them)
                if ps._qtable_q != q:
                    ps._qtables = rfc2435_qtables(q)
                    ps._qtable_q = q
        if ps._frame_corrupt:
            return
        if offset != len(ps._scan):
            # TCP keeps order, so a gap means a parse bug or a frame
            # started mid-stream — drop this frame, resync on offset 0
            ps._frame_corrupt = True
            return
        ps._scan.extend(frag)
        if marker:
            jfif = reconstruct_jfif(
                *ps._dims, ps._qtables, bytes(ps._scan),
                subsampling=jtype & 0x3F)
            ps._scan.clear()
            self._queue_jpeg(ps, jfif, ts)

    def _on_rtp_h264(self, ps: DemuxStream, payload: bytes,
                     marker: bool, ts: int) -> None:
        """RFC 6184 depacketization: single NAL units, STAP-A
        aggregates, FU-A fragments → Annex-B access units on the
        marker bit. SPS/PPS are cached and re-prepended so each AU
        handed to decode is self-contained (the file-shim decoder
        needs it; intra-only streams guarantee it suffices)."""
        if not payload:
            return
        nal_type = payload[0] & 0x1F
        if nal_type == 28 and len(payload) >= 2:        # FU-A
            fu = payload[1]
            start, end = fu & 0x80, fu & 0x40
            if start:
                ps._fu = bytearray(
                    bytes([(payload[0] & 0xE0) | (fu & 0x1F)]))
            if ps._fu is not None:
                ps._fu.extend(payload[2:])
                if end:
                    self._h264_nal(ps, bytes(ps._fu))
                    ps._fu = None
        elif nal_type == 24:                            # STAP-A
            i = 1
            while i + 2 <= len(payload):
                size = struct.unpack(">H", payload[i:i + 2])[0]
                self._h264_nal(ps, payload[i + 2:i + 2 + size])
                i += 2 + size
        elif 1 <= nal_type <= 23:                       # single NAL
            self._h264_nal(ps, payload)
        else:
            # STAP-B/MTAP/FU-B (interleaved mode) or reserved types:
            # fail LOUDLY — silently skipping them would leave the
            # stream RUNNING with zero frames forever (the same
            # failure the payload-type check above rejects)
            self._socket_gone(
                ps.sock, ps,
                f"unsupported H.264 RTP NAL type {nal_type} "
                "(packetization-mode 1 only: single NAL / STAP-A / "
                "FU-A) — unset EVAM_RTSP_DEMUX_WORKERS for this "
                "camera")
            return
        if marker and ps._nals:
            nals = ps._nals
            ps._nals = []
            # self-contained AU: ensure BOTH parameter sets lead it
            # (cameras commonly repeat SPS per IDR but send PPS once)
            if not any(n[0] & 0x1F == 8 for n in nals) \
                    and ps._pps is not None:
                nals.insert(0, ps._pps)
            if not any(n[0] & 0x1F == 7 for n in nals) \
                    and ps._sps is not None:
                nals.insert(0, ps._sps)
            au = b"".join(b"\x00\x00\x00\x01" + n for n in nals)
            self._queue_frame(ps, "h264", au, ts)

    def _h264_nal(self, ps: DemuxStream, nal: bytes) -> None:
        if not nal:
            return
        t = nal[0] & 0x1F
        if t == 7:
            ps._sps = nal
        elif t == 8:
            ps._pps = nal
        ps._nals.append(nal)

    def _queue_jpeg(self, ps: DemuxStream, jfif: bytes,
                    ts: int) -> None:
        self._queue_frame(ps, "jpeg", jfif, ts)

    def _queue_frame(self, ps: DemuxStream, kind: str, data: bytes,
                     ts: int) -> None:
        with self._lock:
            if ps._removed or ps.finished:
                return
            ps._jpegs.append((kind, data, ts))
            if len(ps._jpegs) > ps._max_pending:   # live: newest wins
                ps._jpegs.popleft()
                ps.frames_dropped_decode += 1      # under the lock
                metrics.inc("evam_frames_dropped",
                            labels={"stream": ps.stream_id,
                                    "stage": "decode"})
            if not ps._scheduled:
                ps._scheduled = True
                self._ready.put(ps)

    # --------------------------------------------------------- decode

    def _decode_loop(self) -> None:
        while True:
            ps = self._ready.get()
            if ps is None:
                self._ready.put(None)           # release siblings
                return
            with self._lock:
                if ps._jpegs:
                    item = ps._jpegs.popleft()
                    terminal = False
                else:
                    item = None
                    ps._scheduled = False
                    terminal = ps._eof
            if item is None:
                if terminal:                    # decisions in lock,
                    ps._finish(ps.error)        # actions outside it
                    self._retire(ps)
                continue
            kind, data, ts = item
            decode_s = 0.0
            if not ps._removed:
                t_d = time.perf_counter()
                try:
                    img = _decode(kind, data)
                except Exception as exc:  # noqa: BLE001 — fails the stream
                    img = None
                    self._fail(ps, f"{type(exc).__name__}: {exc}")
                decode_s = time.perf_counter() - t_d
                if img is not None:
                    ps._seq += 1
                    ps._emit(FrameEvent(
                        frame=img,
                        pts_ns=int(ts * (1_000_000_000 / RTP_CLOCK)),
                        seq=ps._seq,
                        decode_s=decode_s))
            with self._lock:
                self._decode_s[kind] += decode_s
                if ps._jpegs:
                    self._ready.put(ps)         # stay scheduled
                    deliver_eos = False
                else:
                    ps._scheduled = False
                    deliver_eos = ps._eof
            if deliver_eos:
                ps._finish(ps.error)
                self._retire(ps)

    def _fail(self, ps: DemuxStream, error: str) -> None:
        """A decode error that ends the stream: record it, stop decoding
        its frames, and have the selector close its socket (EOS follows
        once its queued frames are skipped)."""
        log.error("demux stream %s failed: %s", ps.stream_id, error)
        metrics.inc("evam_stream_errors", labels={"stream": ps.stream_id})
        with self._lock:
            ps.error = ps.error or error
        ps._removed = True
        self._request_close(ps)

    # ---------------------------------------------------------- stats

    def stats(self) -> dict:
        """Live stream count + CUMULATIVE frame counters (retired
        streams fold their totals in at retirement). Drops are
        stage-attributed: ``dropped_decode`` (shared decode workers
        behind — decode-bound) vs ``dropped_downstream`` (the
        runner/engine consumer behind — engine/framework-bound);
        ``dropped`` is their sum, the pre-attribution contract.
        ``decode_s`` (the port's addition) holds the decode workers'
        seconds inside the decode call, by codec: over the wall time of
        ``threads - 1`` workers, how busy they are."""
        with self._lock:
            streams = list(self._streams)
            decoded = self._retired_decoded
            drop_dec = self._retired_dropped_decode
            drop_down = self._retired_dropped_downstream
            decode_s = dict(self._decode_s)
        drop_dec += sum(s.frames_dropped_decode for s in streams)
        drop_down += sum(s.frames_dropped_downstream for s in streams)
        return {
            "streams": len(streams),
            "threads": 1 + len(self._workers),
            "decoded": decoded + sum(s.frames_decoded for s in streams),
            "dropped": drop_dec + drop_down,
            "dropped_decode": drop_dec,
            "dropped_downstream": drop_down,
            "decode_s": decode_s,
        }


class RtspSource:
    """``rtsp://`` without the shared demux: the per-stream blocking
    reader, here a demux of its own with one stream and one decode
    worker (the reference reads the URI with cv2). The server closing
    the stream ends it cleanly, as a capture's last read does; any
    other error raises ``IOError`` for the instance's retry."""

    def __init__(self, uri: str, maxsize: int = 8):
        self.uri = uri
        self.maxsize = maxsize
        self._demux: RtspDemux | None = None
        self._stream: DemuxStream | None = None
        self._lock = threading.Lock()
        self._closed = False

    def frames(self):
        with self._lock:
            if self._closed:
                return
            self._demux = RtspDemux(decode_workers=1)
        try:
            stream = self._demux.add_stream(self.uri, maxsize=self.maxsize)
            with self._lock:
                self._stream = stream
                if self._closed:
                    stream.close()
            yield from stream.frames()
            if stream.error and stream.error != "rtsp EOF":
                raise IOError(stream.error)
        finally:
            self.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            stream, demux = self._stream, self._demux
        if stream is not None:
            stream.close()
        if demux is not None:
            demux.stop()
