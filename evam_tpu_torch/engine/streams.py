"""What a CUDA engine owns on the device side: its streams, created by
the engine and destroyed when it stops, and the page-locked host memory
it stages batches in.

``torch.cuda.Stream()`` draws from a pool of 32 streams per device,
handed out round robin, so the 33rd stream a process asks for is the
first one again. Each CUDA engine needs three (the compute stream, the
copy stream and the graph-capture stream): with eleven engines alive two
of them would share a stream, and a capture on a shared stream records
the other engine's work. So no engine takes a pooled stream: each one
creates its own through ``csrc/engine_cuda.cu``
(``cudaStreamCreateWithPriority(..., cudaStreamNonBlocking, 0)``, the
pool's flags) and wraps the handle as ``torch.cuda.ExternalStream``.

:func:`destroy` is called once nothing of the engine can touch the
stream any more (its threads have exited, its graphs are freed and the
stream has drained); :func:`live` counts the streams created and not
yet destroyed, per device, and :func:`live_handles` names them.

A destroyed stream must never be named again, and torch's caching host
allocator names, when it frees a pinned block, every stream the block
was copied on (it records an event there): a block of it freed after
the engine stopped would record on a dead stream. So the engine's
staging and readback buffers are not torch's pinned memory but numpy
memory page-locked by :func:`pinned_array` (``cudaHostRegister``),
which the host allocator does not track; the registration ends when the
array is collected.
"""

from __future__ import annotations

import ctypes
import math
import threading
import weakref

import numpy as np
import torch

from evam_tpu_torch.ops import kernels

_lock = threading.Lock()
#: device index → handles created and not destroyed
_live: dict[int, set[int]] = {}


#: page size the registered ranges are aligned to
_PAGE = 4096


def _lib() -> ctypes.CDLL:
    lib = kernels.load("engine_cuda")
    lib.evam_stream_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
    lib.evam_stream_destroy.argtypes = [ctypes.c_int, ctypes.c_uint64]
    lib.evam_host_register.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.evam_host_unregister.argtypes = [ctypes.c_uint64]
    return lib


def create(device: str | torch.device) -> torch.cuda.ExternalStream:
    """A new non-blocking stream on ``device`` (a CUDA device)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"streams are CUDA streams, not {dev}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    lib = _lib()
    handle = ctypes.c_uint64()
    kernels.check(lib, lib.evam_stream_create(index, 0, ctypes.byref(handle)),
                  "cudaStreamCreateWithPriority")
    with _lock:
        _live.setdefault(index, set()).add(handle.value)
    return torch.cuda.ExternalStream(handle.value,
                                     device=torch.device("cuda", index))


def destroy(stream: torch.cuda.ExternalStream) -> None:
    """Destroy a stream :func:`create` made, once: work still queued on
    it completes first. A second call does nothing."""
    index, handle = stream.device.index, stream.cuda_stream
    with _lock:
        owned = _live.get(index, set())
        if handle not in owned:
            return
        owned.discard(handle)
    lib = _lib()
    kernels.check(lib, lib.evam_stream_destroy(index, handle),
                  "cudaStreamDestroy")


def live_handles(device: str | torch.device = "cuda") -> frozenset[int]:
    """The handles of the streams :func:`create` made on ``device`` and
    not yet destroyed."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    with _lock:
        return frozenset(_live.get(index, ()))


def live(device: str | torch.device = "cuda") -> int:
    """Streams :func:`create` made on ``device`` and not yet destroyed."""
    return len(live_handles(device))


def is_live(stream: torch.cuda.ExternalStream) -> bool:
    with _lock:
        return stream.cuda_stream in _live.get(stream.device.index, ())


def _unregister(ptr: int) -> None:
    lib = _lib()
    kernels.check(lib, lib.evam_host_unregister(ptr), "cudaHostUnregister")


def pinned_array(shape: tuple[int, ...], dtype) -> np.ndarray:
    """A zeroed numpy array in page-locked host memory that torch's
    caching host allocator does not own (so it never records a stream
    on it). The pages stay locked until the array and every view of it
    are collected."""
    dtype = np.dtype(dtype)
    nbytes = math.prod(shape) * dtype.itemsize
    raw = np.zeros(nbytes + _PAGE, np.uint8)
    off = (-raw.ctypes.data) % _PAGE
    buf = raw[off:off + nbytes]
    if nbytes:
        lib = _lib()
        ptr = buf.ctypes.data
        kernels.check(lib, lib.evam_host_register(ptr, nbytes),
                      "cudaHostRegister")
        weakref.finalize(raw, _unregister, ptr)
    return buf.view(dtype).reshape(shape)


def pinned_tensor(shape: tuple[int, ...], dtype: torch.dtype
                  ) -> torch.Tensor:
    """:func:`pinned_array` as a CPU tensor of any torch dtype."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    raw = pinned_array((math.prod(shape) * itemsize,), np.uint8)
    return torch.from_numpy(raw).view(dtype).reshape(shape)
