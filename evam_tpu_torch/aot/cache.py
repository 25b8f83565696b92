"""Content-addressed on-disk cache of compiled device code.

Counterpart of ``evam_tpu/aot/cache.py``. The reference stores
serialized XLA executables; the port's payload is the bytes of a hand
kernel's shared library plus a loader (``ops/kernels.py``), so that a
restart, a supervisor rebuild or a fleet scale-up loads the library
instead of running ``nvcc``. Every other part of the contract is the
reference's:

- **Keyed on everything that changes the program.** The cache key
  (:func:`cache_key`) hashes the program (for a library: its name, the
  sha256 of its source and the compiler flags), the bucket rung, the
  input shapes, the parameter signature, the device set, the donation
  tuple and the backend — JSON with sorted keys, sha256, the
  reference's hex for the same fields. The versions the payload is
  valid under live in the entry HEADER, not the key, so an upgrade
  reads as a distinguishable ``version`` miss instead of a silent
  absent one.
- **Never a crash, always a counter.** Every rung of the fallback
  ladder — ``absent``, ``version``, ``crc``, ``deserialize``,
  ``execute`` — lands on ``evam_aot_cache_misses_total{engine,reason}``
  and the caller falls back to building loudly. ``crc``, ``deserialize``
  and ``execute`` discard the entry; ``version`` keeps it (another
  process may still be valid for it).
- **CRC-guarded, size-capped LRU.** Entries are MAGIC + header JSON +
  CRC32 + length + payload; writes are atomic (tmp + rename); hits
  touch mtime and eviction removes oldest-by-mtime entries past
  ``EVAM_AOT_MAX_BYTES``; the newest entry always survives.

The header records what a CUDA library is valid under
(:func:`env_fingerprint`: torch, its CUDA runtime, the driver, the
device's name and compute capability) and, beside it, what built it
(the ``nvcc`` release); a load compares only the fields the running
process reads without ``nvcc``, so a hit never needs the toolkit.

No environment reads here (evamlint knobs pass): configuration
arrives through ``config/settings.py`` (EVAM_AOT / EVAM_AOT_DIR /
EVAM_AOT_MAX_BYTES) only.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import struct
import tempfile
import threading
import zlib
from pathlib import Path
from typing import Callable

from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.aot.cache")

#: entry-format magic (the reference's: the layout is the same); bump
#: when the on-disk layout changes (an old layout then reads as a
#: ``crc``-class miss, never a crash)
MAGIC = b"EVAOT001"

#: the fallback ladder, in the order the load path walks it — fixed
#: vocabulary so the /healthz ``aot`` block keeps a stable shape
MISS_REASONS = ("absent", "version", "crc", "deserialize", "execute")

_EXT = ".aotx"


class _EntryError(ValueError):
    """A structurally-bad cache entry, tagged with its miss reason."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(detail or reason)
        self.reason = reason


def cache_key(program: str, bucket: int, inputs, params_sig,
              devices, donate, backend: str) -> str:
    """Content address for one (program, rung, placement) payload.

    Everything that changes the compiled artifact is in here;
    environment versions are in the entry header instead (see module
    docstring). JSON with sorted keys → sha256, so the key is stable
    across processes and hosts."""
    doc = {
        "program": str(program),
        "bucket": int(bucket),
        "inputs": [[str(n), [int(d) for d in shape], str(dt)]
                   for n, shape, dt in inputs],
        "params": [[[int(d) for d in shape], str(dt)]
                   for shape, dt in params_sig],
        "devices": [str(d) for d in devices],
        "donate": [int(i) for i in donate],
        "backend": str(backend),
    }
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _driver_version() -> str:
    """The NVIDIA driver's version string (NVML), else the CUDA driver
    API version (libcuda), else "" (no driver: a CPU process)."""
    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
        if nvml.nvmlInit_v2() == 0:
            try:
                buf = ctypes.create_string_buffer(96)
                if nvml.nvmlSystemGetDriverVersion(buf, 96) == 0:
                    return buf.value.decode()
            finally:
                nvml.nvmlShutdown()
    except (OSError, AttributeError):
        pass
    try:
        cuda = ctypes.CDLL("libcuda.so.1")
        version = ctypes.c_int()
        if cuda.cuDriverGetVersion(ctypes.byref(version)) == 0:
            return f"cuda-api-{version.value}"
    except (OSError, AttributeError):
        pass
    return ""


def env_fingerprint() -> dict:
    """The versions a CUDA library is only valid under — compared
    against the entry header at load, never hashed into the key. Every
    field is read without ``nvcc``; a CPU process has no device fields
    (an entry stored on the card is a ``version`` miss there)."""
    import torch

    fp = {"torch": torch.__version__, "cuda": str(torch.version.cuda or ""),
          "driver": "", "device": "", "capability": ""}
    try:
        if torch.cuda.is_available():
            index = torch.cuda.current_device()
            fp["device"] = torch.cuda.get_device_name(index)
            fp["capability"] = "%d.%d" % torch.cuda.get_device_capability(
                index)
            fp["driver"] = _driver_version()
    except Exception:  # noqa: BLE001 — a device that will not initialize
        pass
    return fp


def _pack_entry(header: dict, payload: bytes) -> bytes:
    hdr = json.dumps(header, sort_keys=True).encode()
    return b"".join([
        MAGIC,
        struct.pack("<I", len(hdr)),
        hdr,
        struct.pack("<I", zlib.crc32(payload) & 0xFFFFFFFF),
        struct.pack("<Q", len(payload)),
        payload,
    ])


def _unpack_entry(blob: bytes) -> tuple[dict, bytes]:
    """Inverse of :func:`_pack_entry`; raises :class:`_EntryError`
    tagged ``crc`` for any structural damage (truncation, bad magic,
    bad checksum, unparseable header)."""
    if len(blob) < len(MAGIC) + 4 or blob[:len(MAGIC)] != MAGIC:
        raise _EntryError("crc", "bad magic")
    off = len(MAGIC)
    (hdr_len,) = struct.unpack_from("<I", blob, off)
    off += 4
    if len(blob) < off + hdr_len + 12:
        raise _EntryError("crc", "truncated header")
    try:
        header = json.loads(blob[off:off + hdr_len].decode())
    except Exception as exc:  # noqa: BLE001
        raise _EntryError("crc", f"header unparseable: {exc}") from exc
    off += hdr_len
    (crc,) = struct.unpack_from("<I", blob, off)
    off += 4
    (n,) = struct.unpack_from("<Q", blob, off)
    off += 8
    payload = blob[off:off + n]
    if len(payload) != n:
        raise _EntryError("crc", "truncated payload")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise _EntryError("crc", "checksum mismatch")
    return header, payload


class AotCache:
    """One directory of ``.aotx`` entries + the hit/miss bookkeeping.

    The metrics registry can be reset by tests mid-flight, so the
    cache keeps its own counters for the fixed-shape /healthz
    ``aot`` summary and mirrors every event onto the evam_aot_cache_*
    series."""

    #: counters are bumped from every thread that loads a library
    SHARED_UNDER = {
        "_hits": "_lock",
        "_misses": "_lock",
        "_evictions": "_lock",
    }

    def __init__(self, root: str | os.PathLike, max_bytes: int):
        self.root = Path(root)
        self.max_bytes = max(0, int(max_bytes))
        self.root.mkdir(parents=True, exist_ok=True)
        self._fingerprint = env_fingerprint()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = {r: 0 for r in MISS_REASONS}
        self._evictions = 0

    # ------------------------------------------------------------- API

    def _path(self, key: str) -> Path:
        return self.root / f"{key}{_EXT}"

    def load(self, key: str, engine: str = "",
             loader: Callable[[bytes], object] | None = None):
        """``loader(payload)`` for ``key`` (the payload itself without
        a loader), or None after counting the miss reason
        (``absent``/``version``/``crc``/``deserialize`` — a loader that
        raises is a ``deserialize`` miss). The caller validates what it
        loaded and then confirms via :meth:`hit` (or
        :meth:`execute_miss`): loading a library proves only that it
        maps, and the only honest validation is running it."""
        path = self._path(key)
        try:
            blob = path.read_bytes()
        except OSError:
            self._miss("absent", engine)
            return None
        try:
            header, payload = _unpack_entry(blob)
        except _EntryError as exc:
            log.warning("aot entry %s unreadable (%s) — falling back "
                        "to a build", path.name, exc)
            self._miss(exc.reason, engine)
            self._discard(path)
            return None
        if {k: header.get(k) for k in self._fingerprint} \
                != self._fingerprint:
            log.warning(
                "aot entry %s built under %s, running %s — version "
                "miss, falling back to a build", path.name, header,
                self._fingerprint)
            self._miss("version", engine)
            return None
        try:
            loaded = payload if loader is None else loader(payload)
        except Exception as exc:  # noqa: BLE001 — any payload rot
            log.warning("aot entry %s failed to load (%s) — falling "
                        "back to a build", path.name, exc)
            self._miss("deserialize", engine)
            self._discard(path)
            return None
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        return loaded

    def hit(self, engine: str = "") -> None:
        """Confirm one load as served (after its validation)."""
        with self._lock:
            self._hits += 1
        metrics.inc("evam_aot_cache_hits", labels={"engine": engine})

    def execute_miss(self, key: str, engine: str = "") -> None:
        """A loaded entry that failed its validation — counted and
        removed so it can't churn."""
        self._miss("execute", engine)
        self._discard(self._path(key))

    def store(self, key: str, payload: bytes, engine: str = "",
              extra: dict | None = None) -> bool:
        """Write ``payload`` under ``key`` (atomic tmp + rename) with
        the fingerprint in its header, ``extra`` beside it (what built
        the payload: recorded, never compared), then evict past the
        size cap. Failures are a warning, never an error — the caller's
        build still serves."""
        blob = _pack_entry({**(extra or {}), **self._fingerprint},
                           bytes(payload))
        path = self._path(key)
        try:
            fd, tmp = tempfile.mkstemp(dir=str(self.root),
                                       suffix=".tmp")
            with os.fdopen(fd, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        except OSError as exc:
            log.warning("aot store failed for %s (%s)", path.name, exc)
            return False
        self._evict()
        return True

    # -------------------------------------------------------- internals

    def _miss(self, reason: str, engine: str) -> None:
        with self._lock:
            self._misses[reason] = self._misses.get(reason, 0) + 1
        metrics.inc("evam_aot_cache_misses",
                    labels={"engine": engine, "reason": reason})

    @staticmethod
    def _discard(path: Path) -> None:
        try:
            path.unlink()
        except OSError:
            pass

    def _entries(self) -> list[tuple[Path, float, int]]:
        out = []
        try:
            for p in self.root.iterdir():
                if p.suffix != _EXT:
                    continue
                try:
                    st = p.stat()
                except OSError:
                    continue
                out.append((p, st.st_mtime, st.st_size))
        except OSError:
            pass
        return out

    def _evict(self) -> None:
        """Oldest-mtime-first eviction past ``max_bytes``. The newest
        entry always survives — a single over-cap payload must not
        thrash store/evict forever."""
        entries = sorted(self._entries(), key=lambda e: e[1])
        total = sum(sz for _, _, sz in entries)
        if self.max_bytes:
            while total > self.max_bytes and len(entries) > 1:
                path, _, sz = entries.pop(0)
                self._discard(path)
                total -= sz
                with self._lock:
                    self._evictions += 1
                log.info("aot cache evicted %s (%d B over cap)",
                         path.name, sz)
        metrics.set("evam_aot_cache_bytes", float(total))

    def summary(self) -> dict:
        """Fixed-shape /healthz block (golden contract — keys stable
        whether the cache is on or off, see :func:`disabled_summary`)."""
        entries = self._entries()
        with self._lock:
            hits = self._hits
            misses = {r: self._misses.get(r, 0) for r in MISS_REASONS}
            evictions = self._evictions
        return {
            "enabled": True,
            "entries": len(entries),
            "bytes": sum(sz for _, _, sz in entries),
            "max_bytes": self.max_bytes,
            "hits": hits,
            "misses": misses,
            "evictions": evictions,
        }


def disabled_summary() -> dict:
    """The same /healthz shape with EVAM_AOT=off."""
    return {
        "enabled": False,
        "entries": 0,
        "bytes": 0,
        "max_bytes": 0,
        "hits": 0,
        "misses": {r: 0 for r in MISS_REASONS},
        "evictions": 0,
    }


#: memoized EVAM_AOT decision — (cache,) once resolved, None before.
#: The tuple wrapper distinguishes "resolved to disabled" from "not yet
#: resolved".
_resolved: tuple[AotCache | None] | None = None


def active() -> AotCache | None:
    """The process AotCache, or None with EVAM_AOT=off (default).
    Memoized: the off path costs one global load per consult."""
    if _resolved is not None:
        return _resolved[0]
    return _resolve()


def _resolve() -> AotCache | None:
    global _resolved
    from evam_tpu_torch.config.settings import get_settings

    cfg = get_settings().aot
    cache: AotCache | None = None
    if cfg.enabled:
        root = cfg.dir or os.path.join(tempfile.gettempdir(), "evam_aot")
        try:
            cache = AotCache(root, cfg.max_bytes)
        except OSError as exc:
            log.warning("EVAM_AOT dir %s unusable (%s) — AOT "
                        "cache disabled", root, exc)
    _resolved = (cache,)
    return cache


def summary() -> dict:
    """The /healthz ``aot`` block: live cache summary or the disabled
    same-shape zeros."""
    cache = active()
    return disabled_summary() if cache is None else cache.summary()


def reset_cache() -> None:
    """Drop the memo (tests / A-B flips)."""
    global _resolved
    _resolved = None
