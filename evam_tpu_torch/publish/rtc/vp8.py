"""VP8 frames from the port's own encoder + RFC 7741 RTP payloading.

Counterpart of ``evam_tpu/publish/rtc/vp8.py``. The reference encodes
through ``cv2.VideoWriter`` (FFmpeg and libvpx into a temporary WebM)
and lifts the frames out of the container; the card's machine has
neither cv2 nor libvpx. The port encodes with ``csrc/evam_vp8.cpp``
(RFC 6386: 16×16 intra keyframes, ZEROMV inter frames, no loop filter,
a fixed quantizer), built into the port's native library
(``native.py``) and called through ctypes with the interpreter lock
released. Its bitstream is its own, not libvpx's: bytes and bitrate
differ from the reference's at equal input, while any VP8 decoder
reproduces the encoder's reconstruction exactly
(``tests/test_torch_rtc.py`` decodes with libvpx).

Frames are resized as ``cv2.resize`` would (``native.resize_bgr``),
padded to whole macroblocks by repeating the last row and column, and
converted to I420 on the port's BT.601 path (``native.bgr_to_i420``).
There is no numpy or cv2 stand-in: where the library cannot be built,
a call raises with the compiler's output.

``Vp8Packetizer``, ``depacketize`` and ``parse_vp8_header`` are the
reference's, byte for byte; without a WebM writer there is no EBML
walk.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from evam_tpu_torch import native

RTP_HEADER_LEN = 12
DEFAULT_MTU = 1200  # typical WebRTC payload budget under 1500-byte UDP
#: the encoder's quantizer index (RFC 6386 §9.6 ``y_ac_qi``, 0-127),
#: fixed for every frame: step 36 for luma AC, 29 for luma DC
Q_INDEX = 32
_ERR_LEN = 256


def parse_vp8_header(payload: bytes) -> dict:
    """First bytes of a VP8 frame (RFC 6386 §9.1): frame tag +
    keyframe start code + dimensions."""
    tag = payload[0] | (payload[1] << 8) | (payload[2] << 16)
    info = {
        "keyframe": (tag & 1) == 0,
        "show_frame": bool((tag >> 4) & 1),
        "first_part_size": tag >> 5,
    }
    if info["keyframe"]:
        info["sync_ok"] = payload[3:6] == b"\x9d\x01\x2a"
        info["width"] = ((payload[7] << 8) | payload[6]) & 0x3FFF
        info["height"] = ((payload[9] << 8) | payload[8]) & 0x3FFF
    return info


# ----------------------------------------------------------------- encoder


class Vp8Encoder:
    """VP8 frames of one size. ``encode`` gives a keyframe;
    ``encode_frame(frame, keyframe=False)`` an inter frame against the
    last one. One thread at a time."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self._aligned = ((height + 15) // 16 * 16, (width + 15) // 16 * 16)
        self._lib = native.vp8_library()
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._enc = self._lib.evam_vp8_new(width, height, Q_INDEX, err,
                                           _ERR_LEN)
        if not self._enc:
            raise ValueError(err.value.decode())

    def _i420(self, frame_bgr: np.ndarray) -> np.ndarray:
        """BGR → the macroblock-aligned I420 buffer the encoder reads."""
        frame = np.ascontiguousarray(frame_bgr)
        if frame.shape[:2] != (self.height, self.width):
            frame = native.resize_bgr(frame, self.height, self.width)
        ah, aw = self._aligned
        if (ah, aw) != (self.height, self.width):
            frame = np.pad(frame, ((0, ah - self.height),
                                   (0, aw - self.width), (0, 0)), mode="edge")
        return native.bgr_to_i420(frame)

    def encode(self, frame_bgr: np.ndarray) -> bytes:
        """BGR frame → one raw VP8 keyframe payload."""
        return self.encode_frame(frame_bgr, keyframe=True)

    def encode_frame(self, frame_bgr: np.ndarray, keyframe: bool) -> bytes:
        """BGR frame → one VP8 payload: a keyframe, or an inter frame
        (ZEROMV against the last frame's reconstruction)."""
        if self._enc is None:
            raise RuntimeError("vp8: encoder closed")
        i420 = self._i420(frame_bgr)
        err = ctypes.create_string_buffer(_ERR_LEN)
        n = self._lib.evam_vp8_encode(self._enc, native._ptr(i420),
                                      int(keyframe), err, _ERR_LEN)
        if n < 0:
            raise ValueError(err.value.decode())
        out = np.empty(n, np.uint8)
        self._lib.evam_vp8_payload(self._enc, native._ptr(out))
        return out.tobytes()

    def _planes(self, buf: np.ndarray):
        """An aligned I420 buffer → its Y, U, V planes at the frame's
        size (copies)."""
        ah, aw = self._aligned
        flat = buf.reshape(-1)
        ch, cw = (self.height + 1) // 2, (self.width + 1) // 2
        u0 = ah * aw
        v0 = u0 + (ah // 2) * (aw // 2)
        return (buf[:self.height, :self.width].copy(),
                flat[u0:v0].reshape(ah // 2, aw // 2)[:ch, :cw].copy(),
                flat[v0:].reshape(ah // 2, aw // 2)[:ch, :cw].copy())

    def source_planes(self, frame_bgr: np.ndarray):
        """The I420 planes the encoder codes for ``frame_bgr`` (resized
        and converted as ``encode`` does), shaped as
        :meth:`reconstruction`'s: what a PSNR is taken against."""
        return self._planes(self._i420(frame_bgr))

    def reconstruction(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The last frame as a decoder outputs it: I420 planes Y
        ``[h, w]``, U and V ``[(h + 1) // 2, (w + 1) // 2]``."""
        ah, aw = self._aligned
        buf = np.empty((ah * 3 // 2, aw), np.uint8)
        self._lib.evam_vp8_reconstruction(self._enc, native._ptr(buf))
        return self._planes(buf)

    def close(self) -> None:
        enc, self._enc = getattr(self, "_enc", None), None
        if enc:
            self._lib.evam_vp8_free(enc)

    def __del__(self):  # noqa: D105 — native memory
        self.close()


class Vp8GopEncoder:
    """Delta-frame VP8 in GOP batches, with the reference's contract.

    The reference's encoder (cv2.VideoWriter → FFmpeg/libvpx) buffered
    its output until ``release()``, so it collected frames into a GOP
    and encoded them in one pass: one keyframe + (gop-1) inter frames,
    at ``gop/fps`` seconds of added latency, the session pacing the
    burst out one payload per frame tick. The port keeps that contract
    and latency: ``push`` returns ``[]`` while the GOP fills, then the
    whole GOP (``payload[0]`` a keyframe, the rest ZEROMV inter frames
    each against the one before).

    ``force_keyframe()`` (PLI / heavy RR loss / viewer join) discards
    the pending GOP and encodes the next frame alone, which makes it an
    immediate keyframe.
    """

    def __init__(self, width: int, height: int, gop: int = 12):
        if gop < 1:
            raise ValueError("gop must be >= 1")
        self.width, self.height = width, height
        self.gop = gop
        self._buf: list[np.ndarray] = []
        self._force_key = False
        self._enc = Vp8Encoder(width, height)

    def force_keyframe(self) -> None:
        self._force_key = True

    def push(self, frame_bgr: np.ndarray) -> list[bytes]:
        """Add one frame; returns [] while the GOP fills, then the
        whole GOP's payloads (payload[0] is the keyframe)."""
        if self._force_key:
            self._force_key = False
            self._buf = [frame_bgr]      # 1-frame GOP ⇒ keyframe now
            return self._encode_buf()
        self._buf.append(frame_bgr)
        if len(self._buf) < self.gop:
            return []
        return self._encode_buf()

    def flush(self) -> list[bytes]:
        """Encode whatever is buffered (end-of-stream)."""
        return self._encode_buf() if self._buf else []

    def _encode_buf(self) -> list[bytes]:
        frames, self._buf = self._buf, []
        return [self._enc.encode_frame(f, keyframe=i == 0)
                for i, f in enumerate(frames)]

    def close(self) -> None:
        self._enc.close()


# -------------------------------------------------------------- packetizer


class Vp8Packetizer:
    """VP8 frame → RTP packets (RFC 7741 minimal descriptor)."""

    def __init__(self, ssrc: int, payload_type: int = 96,
                 mtu: int = DEFAULT_MTU):
        self.ssrc = ssrc
        self.payload_type = payload_type
        self.mtu = mtu
        self.seq = int.from_bytes(os.urandom(2), "big")

    def packetize(self, vp8_frame: bytes, timestamp: int) -> list[bytes]:
        packets = []
        budget = self.mtu - RTP_HEADER_LEN - 1  # 1-byte VP8 descriptor
        chunks = [vp8_frame[i:i + budget]
                  for i in range(0, len(vp8_frame), budget)]
        for ci, chunk in enumerate(chunks):
            marker = ci == len(chunks) - 1
            header = struct.pack(
                "!BBHII",
                0x80,                                   # V=2, no P/X/CC
                (0x80 if marker else 0) | self.payload_type,
                self.seq & 0xFFFF,
                timestamp & 0xFFFFFFFF,
                self.ssrc,
            )
            self.seq = (self.seq + 1) & 0xFFFF
            # VP8 payload descriptor: X=0 R=0 N=0 S(start) R=0 PID=0
            descriptor = 0x10 if ci == 0 else 0x00
            packets.append(header + bytes([descriptor]) + chunk)
        return packets


def depacketize(packets: list[bytes]) -> bytes:
    """Reassemble a VP8 frame from its RTP packets (test harness for
    the packetizer — the consumer role browsers play)."""
    chunks = []
    for i, pkt in enumerate(packets):
        descriptor = pkt[RTP_HEADER_LEN]
        if descriptor & 0x80:
            raise ValueError("extended descriptor unexpected (X=0 mode)")
        s_bit = bool(descriptor & 0x10)
        if (i == 0) != s_bit:
            raise ValueError("S bit must mark exactly the first packet")
        chunks.append(pkt[RTP_HEADER_LEN + 1:])
    marker = packets[-1][1] & 0x80
    if not marker:
        raise ValueError("last packet must carry the RTP marker")
    return b"".join(chunks)
