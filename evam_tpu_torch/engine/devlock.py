"""Process-wide device-call serialization (counterpart of ``evam_tpu/engine/devlock.py``).

With ``EVAM_SERIALIZE_COMPILE=1`` every device interaction of every
engine — graph capture, host→device upload, launch or replay, readback
— runs under ONE process-wide lock, so no two overlap whatever threads
exist; the engine then also runs its transfer inline (a pipelined
upload overlapping a launch is exactly what the mode forbids). The
cost is the pipeline: batch N+1 cannot be issued while batch N's
device call is being made. It is a measurement mode, not the serving
default.

``max_concurrent()`` is an always-on gauge of the most device calls
that overlapped since ``reset_stats()``: 1 proves the lock held.
"""

from __future__ import annotations

import contextlib
import os
import threading

_lock = threading.RLock()
_stats_lock = threading.Lock()
_active = 0
_max_concurrent = 0
_depth = threading.local()  # nested spans on one thread count once


def enabled() -> bool:
    """``EVAM_SERIALIZE_COMPILE=1``: serialize every engine device call
    process-wide. Read per call, as the reference reads it."""
    return os.environ.get("EVAM_SERIALIZE_COMPILE", "0").lower() in (
        "1", "true", "yes")


def reset_stats() -> None:
    global _max_concurrent
    with _stats_lock:
        _max_concurrent = 0


def max_concurrent() -> int:
    """High-water mark of concurrent device calls since the last
    ``reset_stats()`` — 1 proves serialization held."""
    with _stats_lock:
        return _max_concurrent


@contextlib.contextmanager
def _track():
    global _active, _max_concurrent
    depth = getattr(_depth, "n", 0)
    _depth.n = depth + 1
    if depth == 0:
        with _stats_lock:
            _active += 1
            _max_concurrent = max(_max_concurrent, _active)
    try:
        yield
    finally:
        _depth.n = depth
        if depth == 0:
            with _stats_lock:
                _active -= 1


@contextlib.contextmanager
def device_call(tag: str = ""):
    """Wrap one device interaction (capture / upload / launch /
    readback). Tracking only, unless serialization is enabled."""
    if enabled():
        with _lock, _track():
            yield
    else:
        with _track():
            yield
