"""File / stdout metadata destinations (gvametapublish method=file
counterpart — the reference's default file format is one JSON object
per line).

Counterpart of ``evam_tpu/publish/file_dest.py`` (a copy).

Failure discipline (same contract as publish/mqtt.py):
a publisher must never take down its stream. A write/open failure
(disk full, volume unmounted, permissions flipped) closes the handle,
drops the record — counted in ``evam_publish_dropped{dest="file"}`` —
and retries the open with bounded backoff; recovery re-opens in append
mode so already-written lines survive."""

from __future__ import annotations

import json
import logging
import sys
import threading
import time

from evam_tpu_torch.analysis.annotations import locked_by
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.publish.file")


class FileDestination:
    """JSON-lines (default) or JSON-array metadata file."""

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {"_dropped": "_lock"}

    def __init__(self, path: str, fmt: str = "json-lines",
                 retry_backoff_s: float = 0.5, max_backoff_s: float = 10.0):
        self.path = path
        self.fmt = fmt
        self.max_backoff_s = max_backoff_s
        self._lock = threading.Lock()
        # Lazy open: the file is created/truncated on the first
        # publish, not at construction, so a start request that fails
        # later in build_stages (unknown model, bad stage) can't
        # truncate an operator's existing output file. Parameter
        # errors are caught even earlier (resolve_parameters runs
        # before the destination is created).
        self._fh = None
        self._first = True
        self._closed = False
        self._opened_once = False
        #: guarded by ``_lock``: the publishing stream thread increments
        self._dropped = 0
        self._backoff = retry_backoff_s
        self._base_backoff = retry_backoff_s
        self._next_retry = 0.0

    def _ensure_open(self):
        if self._fh is None:
            # "w" only on the very first open; a reconnect after a
            # write failure must append, not truncate what survived
            mode = "a" if self._opened_once else "w"
            self._fh = open(self.path, mode, encoding="utf-8")
            if self.fmt == "json" and not self._opened_once:
                self._fh.write("[")
            self._opened_once = True
        return self._fh

    @locked_by("_lock")
    def _drop(self, exc: OSError | None = None) -> None:
        self._dropped += 1
        metrics.inc("evam_publish_dropped", labels={"dest": "file"})
        if exc is not None:
            self._next_retry = time.monotonic() + self._backoff
            log.warning("file destination %s failed (%s); dropping and "
                        "retrying in %.1fs", self.path, exc, self._backoff)
            self._backoff = min(self._backoff * 2, self.max_backoff_s)

    def publish(self, meta: dict, frame: bytes | None = None) -> None:
        line = json.dumps(meta, separators=(",", ":"))
        with self._lock:
            if self._closed:
                # a late frame completing during teardown must not
                # re-open (and truncate) the finished output file
                return
            if self._fh is None and time.monotonic() < self._next_retry:
                self._drop()
                return
            try:
                fh = self._ensure_open()
                if self.fmt == "json":
                    if not self._first:
                        fh.write(",\n")
                    self._first = False
                    fh.write(line)
                else:
                    fh.write(line + "\n")
                fh.flush()
                self._backoff = self._base_backoff
            except OSError as exc:
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
                self._drop(exc)

    @property
    def dropped(self) -> int:
        return self._dropped

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._fh is None:
                return
            try:
                if self.fmt == "json":
                    self._fh.write("]\n")
                self._fh.close()
            except OSError as exc:
                log.warning("file destination %s close failed: %s",
                            self.path, exc)
            self._fh = None


class StdoutDestination:
    """Print metadata lines (sample-verification flow: the reference
    docs verify pipelines by eyeballing published JSON,
    charts/README.md:112-119)."""

    def publish(self, meta: dict, frame: bytes | None = None) -> None:
        sys.stdout.write(json.dumps(meta, separators=(",", ":")) + "\n")
        sys.stdout.flush()

    def close(self) -> None:
        pass
