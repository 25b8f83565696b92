"""Build and load the port's CUDA C++ kernels (``evam_tpu_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Builds land in
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``), named by a hash of the source and flags, so a changed
source rebuilds and an unchanged one loads. Nothing is built when a
module is imported: the first call on the card builds, or
:func:`build` builds every kernel at once, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: library name → CUDA source under csrc/: the int8 GEMM kernel, and the
#: engines' streams and page-locked memory (no kernel:
#: ``engine/streams.py``)
SOURCES = {"qgemm": "qgemm.cu", "engine_cuda": "engine_cuda.cu"}

#: no --use_fast_math, and IEEE arithmetic spelled out: the int8 codes
#: match the plain version only with IEEE division and denormals kept,
#: the epilogue only without multiply-add contraction
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--prec-div=true", "--ftz=false", "--fmad=false",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build evam_tpu_torch/csrc")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` process per source, all in parallel. Returns per kernel
    ``{"path", "seconds", "log"}`` (``seconds`` 0 for a cached build).
    Raises with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, target)
        result[name] = {"path": str(target),
                        "seconds": time.perf_counter() - t0, "log": log}
    return result


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.evam_cuda_error_string.argtypes = [ctypes.c_int]
            lib.evam_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if code != 0:
        msg = lib.evam_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
