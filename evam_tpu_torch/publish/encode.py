"""Frame encoding for publication, and its inverse for the message-bus
ingest.

Counterpart of ``evam_tpu/publish/encode.py``. The reference encodes
with ``cv2.imencode`` (JPEG or PNG, ``encoding.type`` /
``encoding.level``). The card's machine has no cv2, so:

* ``raw`` is the frame's bytes (numpy);
* ``png`` is written here with ``zlib`` and ``struct`` (8-bit
  truecolour, the rows Sub-filtered), and :func:`decode_frame` reads
  8-bit truecolour PNGs with any of the five row filters, cv2's output
  included; pixels, not bytes, equal cv2's (cv2 picks its own filters);
* ``jpeg`` goes through the port's own codec (``media/jpeg.py``, C++
  in the native library), which writes the bytes ``cv2.imencode`` writes
  and reads what ``cv2.imdecode`` reads, pixel for pixel; the quality
  range and default (95) are the reference's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from evam_tpu_torch.media import jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(data, zlib.crc32(kind)) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _png(frame_bgr: np.ndarray, level: int) -> bytes:
    frame = np.ascontiguousarray(frame_bgr, dtype=np.uint8)
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"png encode wants an H×W×3 frame, got {frame.shape}")
    h, w, _ = frame.shape
    rgb = frame[:, :, ::-1].reshape(h, w * 3)
    # filter 1 (Sub): each byte less the byte one pixel to its left,
    # modulo 256 (uint8 arithmetic wraps)
    rows = np.empty((h, w * 3 + 1), np.uint8)
    rows[:, 0] = 1
    rows[:, 1:4] = rgb[:, :3]
    np.subtract(rgb[:, 3:], rgb[:, :-3], out=rows[:, 4:])
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def encode_frame(
    frame_bgr: np.ndarray,
    enc_type: str | None,
    level: int | None = None,
) -> bytes:
    """Encode BGR uint8 → bytes. enc_type: None/raw, jpeg, png.

    level: jpeg quality 0-100 (default 95) or png compression 0-9
    (default 3), the reference's validation ranges and messages.
    """
    if not enc_type or enc_type == "raw":
        return np.ascontiguousarray(frame_bgr).tobytes()
    if enc_type == "png":
        c = 3 if level is None else int(level)
        if not 0 <= c <= 9:
            raise ValueError(f"png compression {c} outside [0, 9]")
        return _png(frame_bgr, c)
    if enc_type == "jpeg":
        q = 95 if level is None else int(level)
        if not 0 <= q <= 100:
            raise ValueError(f"jpeg quality {q} outside [0, 100]")
        return jpeg.encode(frame_bgr, q)
    raise ValueError(f"unsupported encoding type '{enc_type}'")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(ftype: int, line: np.ndarray, prior: np.ndarray,
              bpp: int) -> np.ndarray:
    """One scanline's bytes before filtering (PNG spec §9.2)."""
    if ftype == 0:
        return line
    if ftype == 1:  # Sub: a running sum per channel, modulo 256
        return (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64)
                % 256).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return line + prior
    if ftype not in (3, 4):
        raise ValueError(f"png: unknown row filter {ftype}")
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    n = len(out)
    if ftype == 3:  # Average
        for i in range(n):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    else:  # Paeth
        for i in range(n):
            if i >= bpp:
                out[i] = (out[i] + _paeth(out[i - bpp], up[i],
                                          up[i - bpp])) & 0xFF
            else:
                out[i] = (out[i] + up[i]) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unpng(blob: bytes) -> np.ndarray:
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(blob):
        size, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + size]
        if len(data) != size:
            raise ValueError("png: truncated chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + size
    if header is None or not idat:
        raise ValueError("png: no IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color != 2 or interlace != 0:
        raise ValueError(f"png: only 8-bit truecolour without interlace is "
                         f"read (depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    stride = w * 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("png: image data does not match its header")
    raw = raw.reshape(h, stride + 1)
    rgb = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = rgb[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prior, 3)
    return np.ascontiguousarray(rgb.reshape(h, w, 3)[:, :, ::-1])


def decode_frame(blob: bytes, enc_type: str) -> np.ndarray:
    """Encoded bytes → BGR uint8 frame (``cv2.imdecode``'s
    ``IMREAD_COLOR`` result): ``png`` here, ``jpeg`` through the port's
    codec. An undecodable blob raises ``ValueError``."""
    if enc_type == "png":
        return _unpng(bytes(blob))
    if enc_type == "jpeg":
        return jpeg.decode(bytes(blob))
    raise ValueError(f"unsupported encoding type '{enc_type}'")
