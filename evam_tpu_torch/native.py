"""ctypes bindings for the port's host media kernels (``csrc/evam_media.cpp``,
the codecs of ``csrc/evam_codec.cpp`` and the VP8 encoder of
``csrc/evam_vp8.cpp``).

Counterpart of ``evam_tpu/native.py``. The per-frame host work of a
stream thread — the fused bilinear resize + BGR→I420 wire encode, the
plain conversions, and the motion gate's luma grid — runs in a shared
library built with OpenMP and called through ``ctypes``, which releases
the interpreter lock for the length of each call: the stream threads
encode in parallel, and each encode spreads its rows over the cores.

The library is built from the port's own copy of the reference's
source and the port's codecs (one library, both sources), the first
time it is used: ``g++ -O3 -fPIC -fopenmp -Wall -std=c++17 -shared``
(the flags of ``native/Makefile``) into ``build/native/`` at the root
of the checkout, named by a digest of the sources and the flags,
written to a temporary name and renamed (parallel processes may build
it at once). :func:`build` builds it ahead of use.

The codecs (``media/jpeg.py``, :func:`i420_to_bgr` for the I_PCM
reader, and the VP8 encoder of ``publish/rtc/vp8.py``) have no numpy or
cv2 copy: they load the library whatever the policy below says, and a
failed build raises.

The policy is the reference's (``evam_tpu/native.py:42, :98-106``),
read on every call:

- ``EVAM_NO_NATIVE`` set to any non-empty value, ``"0"`` included,
  turns the library off;
- else ``EVAM_NATIVE`` (non-empty) turns it on;
- else it is on when ``os.cpu_count() >= 4``;
- ``EVAM_NATIVE_LIB`` names a prebuilt library to load instead of
  building one.

With the library off, each function runs its numpy copy
(``ops/color.py``, ``media/luma.py``), which gives the same bytes.

**One difference from the reference.** Where its library is absent,
the reference quietly falls back to cv2 or numpy. The port builds its
library from its own source, so "absent" can only mean that the build
or the load failed, and then it raises, with the compiler's output. It
never falls back: only the policy leads onto the numpy copies.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from evam_tpu_torch.media.luma import luma_grid as luma_grid_host
from evam_tpu_torch.ops.color import (
    bgr_to_i420_host,
    i420_shape,
    resize_bgr_host,
    resize_bgr_to_i420_host,
)

log = logging.getLogger("evam_tpu_torch.native")

SOURCE = Path(__file__).resolve().parent / "csrc" / "evam_media.cpp"
#: the codecs (JPEG, I420 → BGR), compiled into the same library
CODEC_SOURCE = SOURCE.with_name("evam_codec.cpp")
#: the VP8 encoder (WebRTC egress), compiled into the same library
VP8_SOURCE = SOURCE.with_name("evam_vp8.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
#: the compiler (tests point it elsewhere to see a failed build raise)
CXX = "g++"
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-Wall", "-std=c++17", "-shared")
#: the source's ``evam_native_version()``
VERSION = 2
#: the codecs' ``evam_codec_version()``
CODEC_VERSION = 1
#: the VP8 encoder's ``evam_vp8_version()``
VP8_VERSION = 1

_U8P = ctypes.POINTER(ctypes.c_uint8)
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def native_mode(env) -> str:
    """The policy as the reference's module reads it (``:42``,
    ``:98-106``): "off" when EVAM_NO_NATIVE holds anything non-empty
    ("0" included), else "on" when EVAM_NATIVE does, else "auto" (on
    with 4 or more cores)."""
    if env.get("EVAM_NO_NATIVE"):
        return "off"
    if env.get("EVAM_NATIVE"):
        return "on"
    return "auto"


def _sources() -> tuple[Path, ...]:
    """Every source of the library (the digest covers them all)."""
    return (SOURCE, CODEC_SOURCE, VP8_SOURCE)


def library_path() -> Path:
    """Where the library of these sources and these flags is built."""
    digest = hashlib.sha256(
        b"".join(src.read_bytes() for src in _sources())
        + " ".join((CXX, *CXX_FLAGS)).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libevam_media_{digest}.so"


def build() -> dict:
    """Compile the library unless it is built. Returns ``{"path",
    "seconds", "log"}`` (``seconds`` 0 when it was built already).
    Raises ``RuntimeError`` with the compiler's output when the build
    fails, or when the compiler is not found."""
    target = library_path()
    if target.exists():
        return {"path": str(target), "seconds": 0.0, "log": ""}
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [CXX, *CXX_FLAGS, "-o", str(tmp), *map(str, _sources())],
            capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(
            f"native build: compiler {CXX!r} not found ({exc}); the host "
            "encode needs g++ with OpenMP, or EVAM_NO_NATIVE=1 for the "
            "numpy copies") from exc
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build of {', '.join(map(str, _sources()))} "
                           f"failed:\n{output}")
    os.replace(tmp, target)
    return {"path": str(target), "seconds": time.perf_counter() - t0,
            "log": output}


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name in ("resize_bgr_to_i420", "resize_bgr", "luma_grid"):
        fn = getattr(lib, name)
        fn.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                       _U8P, ctypes.c_int, ctypes.c_int]
        fn.restype = None
    lib.bgr_to_i420.argtypes = [_U8P, _U8P, ctypes.c_int, ctypes.c_int]
    lib.bgr_to_i420.restype = None
    lib.evam_native_version.restype = ctypes.c_int
    version = lib.evam_native_version()
    if version != VERSION:
        raise RuntimeError(f"native library {path} is version {version}, "
                           f"the bindings need {VERSION}")
    if not hasattr(lib, "evam_codec_version"):
        return lib  # a prebuilt library without the codecs (EVAM_NATIVE_LIB)
    lib.evam_i420_to_bgr.argtypes = [_U8P, _U8P, _U8P, _U8P, ctypes.c_int,
                                     ctypes.c_int]
    lib.evam_i420_to_bgr.restype = None
    lib.evam_jpeg_info.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
    lib.evam_jpeg_info.restype = ctypes.c_int
    lib.evam_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, _U8P, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    lib.evam_jpeg_decode.restype = ctypes.c_int
    lib.evam_jpeg_encode.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_int]
    lib.evam_jpeg_encode.restype = ctypes.c_long
    lib.evam_codec_version.restype = ctypes.c_int
    version = lib.evam_codec_version()
    if version != CODEC_VERSION:
        raise RuntimeError(f"native library {path}: its codecs are "
                           f"version {version}, the bindings need "
                           f"{CODEC_VERSION}")
    if not hasattr(lib, "evam_vp8_version"):
        return lib  # a prebuilt library without the VP8 encoder
    lib.evam_vp8_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.evam_vp8_new.restype = ctypes.c_void_p
    lib.evam_vp8_free.argtypes = [ctypes.c_void_p]
    lib.evam_vp8_free.restype = None
    lib.evam_vp8_encode.argtypes = [ctypes.c_void_p, _U8P, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.evam_vp8_encode.restype = ctypes.c_long
    lib.evam_vp8_payload.argtypes = [ctypes.c_void_p, _U8P]
    lib.evam_vp8_payload.restype = None
    lib.evam_vp8_reconstruction.argtypes = [ctypes.c_void_p, _U8P]
    lib.evam_vp8_reconstruction.restype = None
    lib.evam_vp8_version.restype = ctypes.c_int
    version = lib.evam_vp8_version()
    if version != VP8_VERSION:
        raise RuntimeError(f"native library {path}: its VP8 encoder is "
                           f"version {version}, the bindings need "
                           f"{VP8_VERSION}")
    return lib


def jpeg_library() -> ctypes.CDLL:
    """The loaded library whatever the policy (the codecs' entry):
    built now on first use; a failed build or load raises, and so does
    a prebuilt ``EVAM_NATIVE_LIB`` without the codec."""
    lib = _load()
    if not hasattr(lib, "evam_codec_version"):
        raise RuntimeError(
            f"native library {os.environ.get('EVAM_NATIVE_LIB', '')} has no "
            "JPEG codec (csrc/evam_codec.cpp); unset EVAM_NATIVE_LIB to "
            "build the port's own")
    return lib


def vp8_library() -> ctypes.CDLL:
    """The loaded library whatever the policy (the VP8 encoder's entry),
    as :func:`jpeg_library`; a prebuilt ``EVAM_NATIVE_LIB`` without the
    encoder raises."""
    lib = jpeg_library()
    if not hasattr(lib, "evam_vp8_version"):
        raise RuntimeError(
            f"native library {os.environ.get('EVAM_NATIVE_LIB', '')} has no "
            "VP8 encoder (csrc/evam_vp8.cpp); unset EVAM_NATIVE_LIB to "
            "build the port's own")
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library: ``EVAM_NATIVE_LIB`` where it names one, else
    this source's build (built now on first use). Raises when the build
    or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            prebuilt = os.environ.get("EVAM_NATIVE_LIB", "")
            path = prebuilt or build()["path"]
            try:
                _lib = _bind(path)
            except OSError as exc:
                raise RuntimeError(
                    f"native library {path} failed to load: {exc}") from exc
            log.info("native media kernels loaded (%s, v%d)", path, VERSION)
        return _lib


def available() -> bool:
    """True when the library is loaded or loads now (building it);
    False when ``EVAM_NO_NATIVE`` turns it off. A failed build raises."""
    if native_mode(os.environ) == "off":
        return False
    _load()
    return True


def _use_native() -> bool:
    """The policy, read on every call (the reference's: the OpenMP
    kernels win on a host of 4 or more cores). On means the library is
    loaded: it is built now if it is not, and a failure raises."""
    mode = native_mode(os.environ)
    if mode == "off" or (mode == "auto" and (os.cpu_count() or 1) < 4):
        return False
    _load()
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _native_ok(frame: np.ndarray, *sizes: int) -> bool:
    """Whether this call goes to the library. Checks first what the
    C code assumes and cannot check: a BGR uint8 ``[H, W, 3]`` frame and
    positive sizes."""
    if (frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3
            or 0 in frame.shape or min(sizes, default=1) < 1):
        raise ValueError(f"expected a BGR uint8 [H, W, 3] frame and "
                         f"positive sizes, got {frame.dtype} "
                         f"{frame.shape} → {sizes}")
    return frame.flags.c_contiguous and _use_native()


# ------------------------------------------------------------- kernels

def resize_bgr_to_i420(frame: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Fused bilinear resize + I420 wire encode of a BGR uint8 frame
    (one pass; the per-frame host op of every video stage):
    ``[dh * 3 / 2, dw]`` uint8."""
    i420_shape(dh, dw)  # the planes' layout: height % 4, width % 2
    if not _native_ok(frame, dh, dw):
        return resize_bgr_to_i420_host(frame, dh, dw)
    sh, sw = frame.shape[:2]
    out = np.empty((dh * 3 // 2, dw), np.uint8)
    _lib.resize_bgr_to_i420(_ptr(frame), sh, sw, _ptr(out), dh, dw)
    return out


def bgr_to_i420(frame: np.ndarray) -> np.ndarray:
    """BGR uint8 ``[H, W, 3]`` → I420 ``[H * 3 / 2, W]``, no resize."""
    i420_shape(*frame.shape[:2])
    if not _native_ok(frame):
        return bgr_to_i420_host(frame)
    h, w = frame.shape[:2]
    out = np.empty((h * 3 // 2, w), np.uint8)
    _lib.bgr_to_i420(_ptr(frame), _ptr(out), h, w)
    return out


def resize_bgr(frame: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """Bilinear BGR uint8 resize (float32 weights, half-pixel
    centers): ``[dh, dw, 3]`` uint8."""
    if not _native_ok(frame, dh, dw):
        return resize_bgr_host(frame, dh, dw)
    sh, sw = frame.shape[:2]
    out = np.empty((dh, dw, 3), np.uint8)
    _lib.resize_bgr(_ptr(frame), sh, sw, _ptr(out), dh, dw)
    return out


def i420_to_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """I420 planes (uint8 ``[H, W]``, ``[H/2, W/2]`` twice; H and W even)
    → BGR uint8 ``[H, W, 3]``, the pixels of ``cv2.cvtColor(planar,
    COLOR_YUV2BGR_I420)``. One thread; a codec, so no numpy copy."""
    h, w = y.shape
    if (h % 2 or w % 2 or u.shape != (h // 2, w // 2) or v.shape != u.shape
            or not all(p.dtype == np.uint8 for p in (y, u, v))):
        raise ValueError(f"expected uint8 I420 planes, got {y.shape} "
                         f"{u.shape} {v.shape}")
    lib = jpeg_library()
    y, u, v = (np.ascontiguousarray(p) for p in (y, u, v))
    out = np.empty((h, w, 3), np.uint8)
    lib.evam_i420_to_bgr(_ptr(y), _ptr(u), _ptr(v), _ptr(out), h, w)
    return out


def luma_grid(frame: np.ndarray, gh: int = 16, gw: int = 16) -> np.ndarray:
    """The motion gate's downsampled BT.601 luma grid: uint8
    ``[gh, gw]``, O(gh·gw·16) point samples whatever the frame's size
    (``media/luma.py`` has the lattice)."""
    if not _native_ok(frame, gh, gw):
        return luma_grid_host(frame, gh, gw)
    h, w = frame.shape[:2]
    out = np.empty((gh, gw), np.uint8)
    _lib.luma_grid(_ptr(frame), h, w, _ptr(out), gh, gw)
    return out


if __name__ == "__main__":
    print(build())
