"""RTSP re-streaming server: RTP/MJPEG (RFC 2435) and RTP/H.264
(RFC 6184) over TCP interleaved.

Counterpart of ``evam_tpu/publish/rtsp.py``. The reference re-streams
annotated pipelines at ``rtsp://<host>:8554/<path>`` when ENABLE_RTSP
is set (per-request path via ``destination.frame.{type: rtsp, path}``):
an RTSP handshake (OPTIONS/DESCRIBE/SETUP/PLAY/TEARDOWN), an SDP with
the static JPEG payload type 26 (or dynamic 96 for H.264 mounts), and
RFC 2435 packets with in-band quantization tables (Q=255), interleaved
on the RTSP TCP connection ('$' channel framing), so no UDP ports are
needed. ``FrameRelay.push_bgr`` resizes with the native library's
``resize_bgr`` and encodes with the port's JPEG codec
(``media/jpeg.py``), not cv2.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time

import numpy as np

from evam_tpu_torch import native
from evam_tpu_torch.media import jpeg
from evam_tpu_torch.media.h264 import packetize_rfc6184

log = logging.getLogger("evam_tpu_torch.publish.rtsp")

JPEG_PT = 26          # RTP/AVP static payload type for JPEG
RTP_CLOCK = 90_000
MAX_FRAG = 1400       # payload bytes per RTP packet


# ---------------------------------------------------------------- JPEG

def parse_jpeg(data: bytes):
    """Extract (width, height, qtables, scan_bytes) from a baseline
    JFIF buffer (the shape RFC 2435 needs: tables sent in-band,
    entropy-coded scan re-framed as RTP payloads)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG")
    i = 2
    qtables: list[bytes] = []
    width = height = 0
    while i < len(data):
        if data[i] != 0xFF:
            raise ValueError("bad marker")
        marker = data[i + 1]
        if marker == 0xD9:  # EOI
            break
        seg_len = struct.unpack(">H", data[i + 2 : i + 4])[0]
        seg = data[i + 4 : i + 2 + seg_len]
        if marker == 0xDB:  # DQT — may hold several 65-byte tables
            j = 0
            while j < len(seg):
                precision = seg[j] >> 4
                tbl_len = 64 * (2 if precision else 1)
                qtables.append(seg[j + 1 : j + 1 + tbl_len])
                j += 1 + tbl_len
        elif marker in (0xC0, 0xC1):  # SOF0/1 (baseline)
            height, width = struct.unpack(">HH", seg[1:5])
        elif marker == 0xDA:  # SOS — scan follows until EOI
            scan = data[i + 2 + seg_len : ]
            if scan.endswith(b"\xff\xd9"):
                scan = scan[:-2]
            return width, height, qtables, scan
        i += 2 + seg_len
    raise ValueError("no SOS segment")


def packetize_jpeg(jpeg: bytes, seq: int, timestamp: int, ssrc: int):
    """RFC 2435 packets for one frame. Returns (packets, next_seq)."""
    width, height, qtables, scan = parse_jpeg(jpeg)
    if width > FrameRelay.MAX_DIM or height > FrameRelay.MAX_DIM:
        raise ValueError(
            f"RFC 2435 caps dimensions at {FrameRelay.MAX_DIM}; got "
            f"{width}x{height} (downscale before push)"
        )
    qdata = b"".join(qtables)
    packets = []
    offset = 0
    first = True
    while offset < len(scan) or first:
        frag = scan[offset : offset + MAX_FRAG]
        last = offset + len(frag) >= len(scan)
        header = struct.pack(
            ">BBHII",
            0x80,
            (0x80 if last else 0) | JPEG_PT,
            seq & 0xFFFF,
            timestamp & 0xFFFFFFFF,
            ssrc,
        )
        # JPEG payload header: tspec=0, 24-bit offset, type 1 (4:2:0),
        # Q=255 (quantization tables in-band on the first fragment).
        jpeg_hdr = struct.pack(
            ">BBBBBB",
            0,
            (offset >> 16) & 0xFF, (offset >> 8) & 0xFF, offset & 0xFF,
            1,
            255,
        ) + bytes([width // 8 & 0xFF, height // 8 & 0xFF])
        body = header + jpeg_hdr
        if first:
            body += struct.pack(">BBH", 0, 0, len(qdata)) + qdata
            first = False
        body += frag
        packets.append(body)
        seq += 1
        offset += len(frag)
    return packets, seq


# --------------------------------------------------------------- relay

class FrameRelay:
    """Latest-frame mailbox for one mount: pipeline pushes encoded
    frames (JPEGs, or Annex-B H.264 access units for ``codec='h264'``
    mounts), client threads block for the next one (slow clients skip
    frames — live semantics, never backpressure into the pipeline)."""

    #: RFC 2435 encodes dimensions as blocks/8 in one byte → 2040 max.
    MAX_DIM = 2040

    def __init__(self, path: str, codec: str = "jpeg"):
        if codec not in ("jpeg", "h264"):
            raise ValueError(f"unsupported RTSP mount codec {codec!r}")
        self.path = path
        self.codec = codec
        self._cond = threading.Condition()
        self._jpeg: bytes | None = None
        self._gen = 0
        self._clients = 0

    def add_client(self) -> None:
        with self._cond:
            self._clients += 1

    def remove_client(self) -> None:
        with self._cond:
            self._clients = max(0, self._clients - 1)

    @property
    def has_clients(self) -> bool:
        """Producers check this to skip annotate/encode work when
        nobody is watching (64 streams x 1080p encode for zero viewers
        is real CPU)."""
        return self._clients > 0

    def push_jpeg(self, jpeg: bytes) -> None:
        with self._cond:
            self._jpeg = jpeg
            self._gen += 1
            self._cond.notify_all()

    def push_annexb(self, access_unit: bytes) -> None:
        """H.264 mounts: one self-contained Annex-B access unit
        (SPS+PPS+IDR for intra-only streams, e.g. media/h264.py
        output sliced per frame)."""
        self.push_jpeg(access_unit)   # same mailbox, codec-tagged mount

    def push_bgr(self, frame_bgr: np.ndarray, quality: int = 80) -> None:
        h, w = frame_bgr.shape[:2]
        # The RFC 2435 header carries dims as blocks-of-8: cap at
        # MAX_DIM and round to multiples of 8 so the advertised size
        # matches the JPEG MCU grid exactly.
        scale = min(1.0, self.MAX_DIM / max(h, w))
        dh = max(8, int(h * scale) & ~7)
        dw = max(8, int(w * scale) & ~7)
        if (dh, dw) != (h, w):
            frame_bgr = native.resize_bgr(
                np.ascontiguousarray(frame_bgr), dh, dw)
        self.push_jpeg(jpeg.encode(frame_bgr, quality))

    def next_frame(self, last_gen: int, timeout: float = 2.0):
        """Block until a frame newer than ``last_gen`` arrives.

        Returns ``(None, last_gen)`` on timeout so serving loops only
        send genuinely new frames — a stalled pipeline must not be
        re-sent as a fresh RTP frame every timeout period."""
        with self._cond:
            if self._cond.wait_for(lambda: self._gen != last_gen, timeout):
                return self._jpeg, self._gen
            return None, last_gen


class RtspServer:
    def __init__(self, port: int = 8554, host: str = "0.0.0.0"):
        self.host = host
        self.port = port
        self._mounts: dict[str, FrameRelay] = {}
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.host, self.port))
        self.port = self._sock.getsockname()[1]  # resolve port 0
        self._sock.listen(8)
        self._sock.settimeout(0.5)
        self._thread = threading.Thread(
            target=self._accept_loop, name="rtsp-server", daemon=True
        )
        self._thread.start()
        log.info("rtsp server on %s:%d", self.host, self.port)

    def stop(self) -> None:
        self._stop.set()
        if self._sock is not None:
            self._sock.close()

    def mount(self, path: str, codec: str = "jpeg") -> FrameRelay:
        path = path.strip("/")
        with self._lock:
            if path not in self._mounts:
                self._mounts[path] = FrameRelay(path, codec=codec)
            relay = self._mounts[path]
            if relay.codec != codec:
                # pushing H.264 AUs into a JPEG mount (or vice versa)
                # would serve undecodable packets with no error
                raise ValueError(
                    f"mount {path!r} already exists with codec "
                    f"{relay.codec!r}, requested {codec!r}")
            return relay

    def unmount(self, path: str) -> None:
        with self._lock:
            self._mounts.pop(path.strip("/"), None)

    # --------------------------------------------------------- serving

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._serve_client, args=(conn, addr), daemon=True
            ).start()

    def _serve_client(self, conn: socket.socket, addr) -> None:
        conn.settimeout(10)
        session = f"{int(time.time()) & 0xFFFFFF:06x}"
        playing_path = None
        try:
            buf = b""
            while not self._stop.is_set():
                while b"\r\n\r\n" not in buf:
                    chunk = conn.recv(2048)
                    if not chunk:
                        return
                    buf += chunk
                head, _, buf = buf.partition(b"\r\n\r\n")
                lines = head.decode("latin-1").split("\r\n")
                method, url = lines[0].split(" ")[:2]
                headers = {
                    k.strip().lower(): v.strip()
                    for k, v, in (l.split(":", 1) for l in lines[1:] if ":" in l)
                }
                cseq = headers.get("cseq", "0")
                path = url.rstrip("/").split("/")[-1] if "/" in url else ""

                if method == "OPTIONS":
                    self._reply(conn, cseq, extra=(
                        "Public: OPTIONS, DESCRIBE, SETUP, PLAY, TEARDOWN"))
                elif method == "DESCRIBE":
                    relay = self._mounts.get(path)
                    if relay is None:
                        self._reply(conn, cseq, code="404 Not Found")
                        continue
                    if relay.codec == "h264":
                        media = (
                            "m=video 0 RTP/AVP 96\r\n"
                            "a=rtpmap:96 H264/90000\r\n"
                            "a=fmtp:96 packetization-mode=1\r\n"
                        )
                    else:
                        media = "m=video 0 RTP/AVP 26\r\n"
                    sdp = (
                        "v=0\r\n"
                        f"o=- 0 0 IN IP4 {self.host}\r\n"
                        "s=evam-tpu\r\n"
                        "t=0 0\r\n"
                        + media +
                        "c=IN IP4 0.0.0.0\r\n"
                        "a=control:streamid=0\r\n"
                    )
                    self._reply(conn, cseq, body=sdp,
                                extra="Content-Type: application/sdp")
                elif method == "SETUP":
                    self._reply(conn, cseq, extra=(
                        "Transport: RTP/AVP/TCP;unicast;interleaved=0-1\r\n"
                        f"Session: {session}"))
                elif method == "PLAY":
                    self._reply(conn, cseq, extra=f"Session: {session}")
                    playing_path = path or playing_path
                    self._stream(conn, playing_path)
                    return
                elif method == "TEARDOWN":
                    self._reply(conn, cseq, extra=f"Session: {session}")
                    return
                else:
                    self._reply(conn, cseq, code="405 Method Not Allowed")
        except (OSError, ValueError) as exc:
            log.debug("rtsp client %s: %s", addr, exc)
        finally:
            conn.close()

    @staticmethod
    def _reply(conn, cseq, code="200 OK", extra="", body=""):
        msg = f"RTSP/1.0 {code}\r\nCSeq: {cseq}\r\n"
        if extra:
            msg += extra + "\r\n"
        if body:
            msg += f"Content-Length: {len(body)}\r\n"
        msg += "\r\n" + body
        conn.sendall(msg.encode("latin-1"))

    def _stream(self, conn: socket.socket, path: str) -> None:
        relay = self._mounts.get(path)
        if relay is None:
            return
        seq = 0
        ssrc = 0x45564154  # "EVAT"
        gen = 0
        t0 = time.monotonic()
        relay.add_client()
        try:
            while not self._stop.is_set():
                jpeg, gen = relay.next_frame(gen)
                if jpeg is None:
                    continue
                ts = int((time.monotonic() - t0) * RTP_CLOCK)
                if relay.codec == "h264":
                    packets, seq = packetize_rfc6184(
                        jpeg, seq, ts, ssrc)
                else:
                    packets, seq = packetize_jpeg(jpeg, seq, ts, ssrc)
                # interleaved framing ('$', channel 0, length) for every
                # packet of the frame, sent with one call: a 720p I_PCM
                # access unit is a thousand packets
                try:
                    conn.sendall(b"".join(
                        b"$\x00" + struct.pack(">H", len(pkt)) + pkt
                        for pkt in packets))
                except OSError:
                    return
        finally:
            relay.remove_client()
