"""Device-synth wire batches: per-item uint32 seeds → uint8 wire frames.

Counterpart of the generator inside ``evam_tpu/engine/steps.py``
(``weyl_bits``, ``wrap_device_synth``), which XLA fuses into one pass
that writes one byte an element. Here it is a hand CUDA kernel for
``sm_90a`` (``evam_tpu_torch/csrc/synth.cu``, built by
``ops/kernels.py``); this module holds its wrapper :func:`synth_wire`,
its plain version :func:`synth_wire_reference`, the recipe
:func:`weyl_bits`, the library's :func:`self_test` for the AOT store,
and the launch count :data:`launches`.

Byte ``j`` of item ``b``'s flattened wire frame is::

    mix_b = seed_b · 0x9E3779B9            mod 2³²
    out   = ((j · 2654435761 + mix_b)      mod 2³²) >> 13   mod 256

torch's uint32 cannot add, shift or ``arange``, so the plain version
works in int64 with explicit reductions mod 2³². Seeds may come as
uint32 or as an int32 view of the same bytes; the kernel reads them as
unsigned either way.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import numpy as np
import torch

from evam_tpu_torch.ops import kernels

#: the Weyl sequence's step and the seeds' mixing constant (the
#: reference's: 2654435761 = ⌊2³² / φ⌋ rounded to odd, 0x9E3779B9)
WEYL = 2654435761
MIX = 0x9E3779B9
_MASK = 0xFFFFFFFF

#: launches of the CUDA kernel; the wrapper adds one per launch, and a
#: replay of a CUDA graph the launches its capture recorded
#: (:func:`count_replay`), nowhere else (plain-version calls and the
#: self-test do not count). Callers reset it to 0 before a run whose
#: launches they want to count.
launches = 0
_count_lock = threading.Lock()
#: per thread: the launches a CUDA-graph capture records instead of the
#: global count (a captured call launches nothing)
_capture = threading.local()


@contextlib.contextmanager
def recording():
    """Record this thread's launches into a fresh ``{"launches": n}``
    instead of :data:`launches`: a call made while a CUDA graph is
    being captured launches nothing then, but once per replay."""
    counts = {"launches": 0}
    prev = getattr(_capture, "counts", None)
    _capture.counts = counts
    try:
        yield counts
    finally:
        _capture.counts = prev


def count_replay(n: int) -> None:
    """One replay of a graph whose capture recorded ``n`` launches."""
    global launches
    with _count_lock:
        launches += n


def _count() -> None:
    counts = getattr(_capture, "counts", None)
    if counts is not None:
        counts["launches"] += 1
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("synth captured into a CUDA graph outside "
                           "synth.recording(): its replays would go "
                           "uncounted")
    count_replay(1)


def _unsigned(seeds: torch.Tensor) -> torch.Tensor:
    """uint32 or int32 seeds → int64 in [0, 2³²), through an int32 view
    (no arithmetic on torch's uint32, which has almost none)."""
    if seeds.dtype == torch.uint32:
        seeds = seeds.view(torch.int32)
    return seeds.to(torch.int64) & _MASK


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a · c mod 2³² for int64 ``a`` in [0, 2³²) and a 32-bit constant,
    without leaving int64: c is split in 16-bit halves."""
    lo = (a * (c & 0xFFFF)) & _MASK
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def weyl_bits(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """[...]-shaped seeds → [..., n] Weyl-sequence bits
    ``(i · 2654435761 + seed) mod 2³²``, the reference's recipe.

    Returns int64 holding values in [0, 2³²) (the reference returns
    uint32): torch's uint32 cannot add or shift. Seeds: any integer
    tensor whose values lie in [0, 2³²), or uint32/int32 (read as
    unsigned)."""
    seeds = torch.as_tensor(seeds)
    if seeds.dtype in (torch.uint32, torch.int32):
        seeds = _unsigned(seeds)
    i = torch.arange(n, dtype=torch.int64, device=seeds.device)
    return (_mul32(i, WEYL) + seeds.to(torch.int64)[..., None]) & _MASK


def _check(seeds: torch.Tensor, wire_shape) -> tuple[int, ...]:
    if seeds.dim() != 1:
        raise ValueError(f"synth seeds must be [B], got {tuple(seeds.shape)}")
    if seeds.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"synth seeds must be uint32 or int32, got "
                        f"{seeds.dtype}")
    shape = tuple(int(d) for d in wire_shape)
    if not shape or min(shape) < 1:
        raise ValueError(f"synth wire shape must be positive, got {shape}")
    return shape


def synth_wire_reference(seeds: torch.Tensor, wire_shape) -> torch.Tensor:
    """Plain torch version of the kernel: seeds [B] (uint32, or int32
    read as unsigned) → uint8 [B, *wire_shape]."""
    shape = _check(seeds, wire_shape)
    mix = _mul32(_unsigned(seeds), MIX)
    bits = weyl_bits(mix, math.prod(shape))
    return ((bits >> 13) & 0xFF).to(torch.uint8).reshape(
        (seeds.shape[0],) + shape)


def _bind(lib):
    """Declare the kernel's C entry point on ``lib`` (once)."""
    if lib.evam_synth_wire.argtypes is None:
        p = ctypes.c_void_p
        lib.evam_synth_wire.argtypes = [p, ctypes.c_longlong,
                                        ctypes.c_longlong, p, p]
        lib.evam_synth_wire.restype = ctypes.c_int
    return lib


def _lib():
    return _bind(kernels.load("synth"))


def _launch(lib, seeds: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """One launch on the current stream (a checked contiguous CUDA seed
    vector, B ≥ 1). Counts nothing."""
    out = torch.empty((seeds.shape[0],) + shape, dtype=torch.uint8,
                      device=seeds.device)
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.evam_synth_wire(seeds.data_ptr(), seeds.shape[0],
                                 math.prod(shape), out.data_ptr(), stream)
    kernels.check(lib, rc, "synth")
    return out


def synth_wire(seeds: torch.Tensor, wire_shape) -> torch.Tensor:
    """seeds [B] (uint32, or int32 read as unsigned) → the wire batch,
    uint8 [B, *wire_shape], each byte as :func:`synth_wire_reference`
    makes it."""
    shape = _check(seeds, wire_shape)
    if seeds.device.type == "cpu":
        return synth_wire_reference(seeds, shape)
    if seeds.device.type != "cuda":
        raise ValueError(f"synth runs on cpu or cuda, not {seeds.device}")
    if not seeds.is_contiguous():
        raise ValueError("synth seeds must be contiguous")
    if seeds.shape[0] == 0:
        return torch.empty((0,) + shape, dtype=torch.uint8,
                           device=seeds.device)
    out = _launch(_lib(), seeds, shape)
    _count()
    return out


#: (seeds, wire shape) of the self-test's launches: a row length that is
#: a multiple of 16 bytes, and one that is not (rows straddle the
#: kernel's 16-byte stores, and a masked tail)
SELF_TEST_CASES = (((0, 1, 2**31, 2**32 - 1), (24, 16)),
                   ((7, 2**32 - 1, 12345), (7, 13)))


def self_test(lib) -> None:
    """The kernel of ``lib`` (a library the AOT store served) on the
    current CUDA device, equal byte for byte to
    :func:`synth_wire_reference`; raises otherwise. Its launches are
    comparisons: they do not count."""
    _bind(lib)
    dev = torch.device("cuda", torch.cuda.current_device())
    for values, shape in SELF_TEST_CASES:
        seeds = torch.from_numpy(np.array(values, np.uint32)).to(dev)
        out = _launch(lib, seeds, shape)
        want = synth_wire_reference(seeds, shape)
        # this stream only: another engine may be capturing a graph
        torch.cuda.current_stream(dev).synchronize()
        if not torch.equal(out, want):
            raise RuntimeError(
                f"synth self-test failed at {len(values)} × {shape}: "
                f"{int((out != want).sum())} bytes differ")
