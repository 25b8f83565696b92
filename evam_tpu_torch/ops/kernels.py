"""Build and load the port's CUDA C++ kernels (``evam_tpu_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Builds land in
the compile cache directory, ``EVAM_COMPILE_CACHE_DIR`` (the
reference's compile cache, whose analogue it names as the OpenCL
``cl_cache``), or else ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), named by a hash of the source and flags, so
a changed source rebuilds and an unchanged one loads. Nothing is built
when a module is imported: the first call on the card builds, or
:func:`build` builds every kernel at once, one ``nvcc`` per source, all
started together.

With the AOT cache on (``EVAM_AOT``, ``evam_tpu_torch/aot/``),
:func:`load` goes through its store first. The key is the library's
name, the sha256 of its source and the flags, the device's name and
arch; the header holds the versions it is valid under. A hit writes
the payload to a path of its own named by the key and the payload's
digest (``dlopen`` caches by path, and a mapped file must never be
rewritten), loads it, and runs the library's self-test (launches of
K1 and of the synth kernel against their plain versions; one stream and
one page-locked block of the engines' library): a self-test that fails
is an ``execute`` miss, and the library is discarded, rebuilt and never
served. A miss runs
``nvcc`` as without the cache, then stores the library. A failed
``nvcc`` raises: there is no plain fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from evam_tpu_torch import aot
from evam_tpu_torch.config.settings import get_settings

log = logging.getLogger("evam_tpu_torch.ops.kernels")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: library name → CUDA source under csrc/: the int8 GEMM kernel, the
#: device-synth wire generator (``ops/synth.py``), and the engines'
#: streams and page-locked memory (no kernel: ``engine/streams.py``)
SOURCES = {"qgemm": "qgemm.cu", "synth": "synth.cu",
           "engine_cuda": "engine_cuda.cu"}

#: library name → "module:function" of its self-test, run on a library
#: the AOT store served before it is used
SELF_TESTS = {"qgemm": "evam_tpu_torch.ops.qgemm:self_test",
              "synth": "evam_tpu_torch.ops.synth:self_test",
              "engine_cuda": "evam_tpu_torch.engine.streams:self_test"}

#: no --use_fast_math, and IEEE arithmetic spelled out: the int8 codes
#: match the plain version only with IEEE division and denormals kept,
#: the epilogue only without multiply-add contraction
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--prec-div=true", "--ftz=false", "--fmad=false",
)

#: held while a library is opened (a build included)
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: guards the two records below, which a warming engine reads while
#: another thread may hold _lock through a build
_record_lock = threading.Lock()
#: library name → whether the library loaded in this process has an
#: entry in the AOT store (served by it, or stored after its build)
_stored: dict[str, bool] = {}
#: libraries this process compiled or took from the compile directory
#: (each one a store miss with the cache on), for the engines' warmup
#: attribution
_builds = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build evam_tpu_torch/csrc")


def build_dir() -> Path:
    """The compile cache directory: ``EVAM_COMPILE_CACHE_DIR``, else
    the checkout's build/kernels."""
    cache_dir = get_settings().engine.compile_cache_dir
    return Path(cache_dir) if cache_dir else BUILD_DIR


def _program(name: str) -> str:
    src = (CSRC / SOURCES[name]).read_bytes()
    return (f"{name}|{hashlib.sha256(src).hexdigest()}|"
            f"{' '.join(NVCC_FLAGS)}")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}_{digest}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all in parallel. Returns per kernel
    ``{"path", "seconds", "log"}`` (``seconds`` 0 for a cached build).
    Raises with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else names
    build_dir().mkdir(parents=True, exist_ok=True)
    procs, result = {}, {}
    for name in names:
        target = library_path(name)
        if target.exists():
            result[name] = {"path": str(target), "seconds": 0.0, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, target, time.perf_counter())
    for name, (proc, tmp, target, t0) in procs.items():
        log_text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log_text}")
        os.replace(tmp, target)
        result[name] = {"path": str(target),
                        "seconds": time.perf_counter() - t0, "log": log_text}
        log.info("built %s in %.2f s", target.name, result[name]["seconds"])
    return result


def _nvcc_release() -> str:
    """The ``release`` line of ``nvcc --version`` (recorded in a stored
    entry's header, never compared), or "" without a toolkit."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return ""
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[0] if lines else ""


def aot_key(name: str) -> str:
    """The AOT store's key of library ``name`` on the current device."""
    import torch

    index = torch.cuda.current_device()
    arch = "sm_%d%d" % torch.cuda.get_device_capability(index)
    return aot.cache_key(
        program=_program(name), bucket=0, inputs=(), params_sig=(),
        devices=(f"{torch.cuda.get_device_name(index)}|{arch}",),
        donate=(), backend="cuda")


def _dlopen_payload(root: Path, name: str, key: str,
                    payload: bytes) -> ctypes.CDLL:
    """Load a stored library: written to a path named by its key, the
    payload's digest and this process (no process rewrites a file
    another has mapped; ``dlopen``, which caches by path, hands back an
    earlier library of the path only for the same bytes), loaded, and
    unlinked (the mapping stays)."""
    digest = hashlib.sha256(payload).hexdigest()[:12]
    path = root / f".lib{name}_{key[:16]}_{digest}_{os.getpid()}.so"
    tmp = path.with_suffix(".tmp")
    tmp.write_bytes(payload)
    os.replace(tmp, path)
    try:
        return ctypes.CDLL(str(path))
    finally:
        path.unlink()


def _self_test(name: str, lib: ctypes.CDLL) -> None:
    module, func = SELF_TESTS[name].split(":")
    getattr(importlib.import_module(module), func)(lib)


def _through_store(cache, name: str, key: str, build_fn,
                   self_test) -> tuple[ctypes.CDLL, bool]:
    """Library ``name`` through the AOT store: a hit that passes
    ``self_test(lib)``, else ``build_fn()`` (the built library's path),
    stored. Returns the library and whether the store holds it."""
    global _builds
    lib = cache.load(key, engine=name, loader=lambda payload: _dlopen_payload(
        cache.root, name, key, payload))
    if lib is not None:
        try:
            self_test(lib)
        except Exception as exc:  # noqa: BLE001 — never serve it
            log.warning("aot: stored %s failed its self-test (%s) — "
                        "discarded, rebuilding", name, exc)
            cache.execute_miss(key, engine=name)
        else:
            cache.hit(engine=name)
            return lib, True
    _count_build()
    path = Path(build_fn())
    stored = cache.store(key, path.read_bytes(), engine=name,
                         extra={"nvcc": _nvcc_release()})
    return ctypes.CDLL(str(path)), stored


def _count_build() -> None:
    global _builds
    with _record_lock:
        _builds += 1


def _build_one(name: str) -> str:
    path = library_path(name)
    if not path.exists():
        build([name])
    return str(path)


def open_library(name: str) -> ctypes.CDLL:
    """Library ``name``, newly opened: through the AOT store when it is
    on, else the compile directory's build (made first if absent)."""
    cache = aot.active()
    if cache is None:
        _count_build()
        lib, stored = ctypes.CDLL(_build_one(name)), False
    else:
        lib, stored = _through_store(
            cache, name, aot_key(name), lambda: _build_one(name),
            lambda lib: _self_test(name, lib))
    with _record_lock:
        _stored[name] = stored
    lib.evam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.evam_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, opened on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = open_library(name)
            _libs[name] = lib
        return lib


def builds() -> int:
    """Libraries this process has built or taken from the compile
    directory so far (store hits do not count)."""
    with _record_lock:
        return _builds


def from_store(names) -> bool:
    """Whether every library of ``names`` is loaded and held by the AOT
    store (served by it, or stored after its build)."""
    with _record_lock:
        return all(_stored.get(n, False) for n in names)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if code != 0:
        msg = lib.evam_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
