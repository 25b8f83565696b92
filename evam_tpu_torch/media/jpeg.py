"""Baseline JPEG decode and encode without cv2.

The reference decodes JPEG with ``cv2.imdecode`` (its RTSP demux) and
encodes it with ``cv2.imencode`` (its RTSP re-stream, its publisher).
The card's machine has no cv2, so the port calls its own codec,
``csrc/evam_codec.cpp``, built into the port's native library
(``native.py``) and called through ctypes with the interpreter lock
released. It gives cv2's pixels and bytes: libjpeg's islow DCTs, fancy
upsampling and fixed-point colour tables (``tests/test_torch_jpeg.py``
holds it to cv2).

There is no numpy or cv2 stand-in: where the library cannot be built, a
call raises with the compiler's output.
"""

from __future__ import annotations

import ctypes

import numpy as np

from evam_tpu_torch import native

_ERR_LEN = 256
#: cv2.imdecode's CV_IO_MAX_IMAGE_PIXELS (the codec's ``kMaxPixels``):
#: a header of a few bytes cannot make a decode reserve gigabytes
MAX_PIXELS = 1 << 30


def _check(rc: int, err) -> None:
    if rc < 0:
        raise ValueError(err.value.decode("utf-8", "replace"))


def info(data: bytes) -> tuple[int, int]:
    """``(height, width)`` from a JPEG's frame header; raises
    ``ValueError`` naming what it refuses (progressive, arithmetic,
    lossless, 12-bit, ...)."""
    lib = native.jpeg_library()
    data = bytes(data)
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.evam_jpeg_info(data, len(data), ctypes.byref(w),
                              ctypes.byref(h), err, _ERR_LEN), err)
    return h.value, w.value


def _frame_size(data: bytes) -> tuple[int, int] | None:
    """``(height, width)`` read from the frame header here, so a decode
    is one native call (each call releases and takes back the
    interpreter lock, which the demux's decode workers share with every
    stream thread); None where the walk finds no plain frame header."""
    pos, n = 2, len(data)
    while pos + 9 <= n and data[pos] == 0xFF:
        marker = data[pos + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return (int.from_bytes(data[pos + 5:pos + 7], "big"),
                    int.from_bytes(data[pos + 7:pos + 9], "big"))
        if marker == 0xFF:  # fill byte
            pos += 1
        elif marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            pos += 2
        else:
            pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    return None


def decode(data: bytes) -> np.ndarray:
    """JPEG bytes → BGR uint8 ``[H, W, 3]``, the pixels of
    ``cv2.imdecode(..., IMREAD_COLOR)``. Raises ``ValueError``."""
    lib = native.jpeg_library()
    data = bytes(data)
    size = _frame_size(data) if data[:2] == b"\xff\xd8" else None
    h, w = size if size and all(size) else info(data)
    if h * w > MAX_PIXELS:
        raise ValueError(f"jpeg: {w}x{h} is more than 2^30 pixels, "
                         "cv2's limit")
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.evam_jpeg_decode(data, len(data), native._ptr(out), w, h,
                                err, _ERR_LEN), err)
    return out


def encode(frame_bgr: np.ndarray, quality: int = 95) -> bytes:
    """BGR uint8 ``[H, W, 3]`` → baseline 4:2:0 JFIF at ``quality``
    (0–100; 0 acts as 1, as in libjpeg): the bytes of
    ``cv2.imencode(".jpg", frame, [IMWRITE_JPEG_QUALITY, quality])``."""
    frame = np.ascontiguousarray(frame_bgr)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"jpeg encode wants a BGR uint8 [H, W, 3] frame, "
                         f"got {frame.dtype} {frame.shape}")
    lib = native.jpeg_library()
    h, w = frame.shape[:2]
    # 6 bytes a pixel holds any frame short of one built to defeat the
    # coder (every coefficient at its longest code and every byte 0xFF);
    # that one gets twice the room. Untouched pages cost nothing.
    for per_pixel in (6, 12):
        cap = h * w * per_pixel + 4096
        out = np.empty(cap, np.uint8)
        err = ctypes.create_string_buffer(_ERR_LEN)
        n = lib.evam_jpeg_encode(native._ptr(frame), h, w, int(quality),
                                 native._ptr(out), cap, err, _ERR_LEN)
        if n >= 0 or b"too small" not in err.value:
            break
    _check(n, err)
    return out[:n].tobytes()
