"""Versioned, CRC-guarded per-stream serving-state checkpoints
(counterpart of ``evam_tpu/state/checkpoint.py``).

The fleet (``fleet/``) survives a shard loss by re-placing streams and
the supervisor (``engine/supervisor.py``) survives wedges by rebuilding
engines — but both cold-start the per-stream serving state: the
MotionGate re-learns its luma reference, the RegionCoaster forgets its
velocities, and a restarted process would re-issue tracker ids. This
module externalizes that state:

* ``StreamCheckpoint`` — a frozen-schema dataclass of everything a
  stream needs to resume mid-scene: gate grid, hysteresis phase and
  skip counter, coaster regions and velocities, tracker identities, the
  sched class, and a trace-continuity marker. ``SCHEMA_VERSION`` guards
  the wire shape, ``SCHEMA_V1_FIELDS`` pins the field tuple.
* ``encode()``/``decode()`` — the JSON-dict wire form ``{"v", "crc",
  "payload"}`` with a CRC32 over the canonical payload encoding, the
  reference's byte for byte (a blob written by either package decodes
  in the other); a mismatch raises ``CheckpointCorrupt`` and the store
  degrades to a loud cold start (counter and error log), never a wedge.
* ``CheckpointStore`` — the process-global capture/restore plane,
  wired at two barriers: post-resolve (``stages/runner.py``, every
  ``EVAM_CKPT_INTERVAL`` resolved frames) and pre-rebalance (fleet
  retire and scale moves, supervisor quarantine → rebuild, the
  registry's ``stop_all`` drain). Restores run before the stream's
  first frame; a checkpoint staler than the gate's max-skip bound is
  discarded (tracker identities excepted) with a forced refresh.

Degradation ladder (weakest guarantee first): corrupted checkpoint →
cold start + ``evam_ckpt_restore_failures_total{reason="crc"}``;
unknown schema → cold start (``reason="version"``); restore slower
than ``EVAM_CKPT_RESTORE_TIMEOUT_S`` → cold start
(``reason="timeout"``); stale checkpoint → identities restored, gate
forced to refresh (``evam_stream_migrations_total{reason=
"stale_refresh"}``); fresh checkpoint → full restore.

``EVAM_CKPT=off`` (the default): ``active()`` memoizes to None and
every call site is one None check.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import weakref
import zlib
from dataclasses import asdict, dataclass, field

from evam_tpu_torch.obs import faults
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.sched.classes import coerce_priority

log = logging.getLogger("evam_tpu_torch.state.checkpoint")

#: wire-schema version: bumps whenever StreamCheckpoint's fields change
#: (``tests/test_torch_state.py`` pins the fields against
#: SCHEMA_V1_FIELDS)
SCHEMA_VERSION = 1

#: pinned field tuple for SCHEMA_VERSION=1. When fields change: bump
#: SCHEMA_VERSION, add a new pinned tuple, and teach decode() to
#: migrate the old payload.
SCHEMA_V1_FIELDS = (
    "stream_id",
    "sched_class",
    "trace_marker",
    "frame_seq",
    "captured_at",
    "barrier",
    "max_skip",
    "skips_at_capture",
    "fps",
    "stages",
)


class CheckpointError(Exception):
    """Base: a checkpoint could not be decoded/applied."""


class CheckpointCorrupt(CheckpointError):
    """CRC mismatch or undecodable payload — degrade to cold start."""


class CheckpointVersionError(CheckpointError):
    """Unknown SCHEMA_VERSION — degrade to cold start."""


@dataclass
class StreamCheckpoint:
    """One stream's serving state at a capture barrier.

    ``stages`` maps stage name → that stage's rich ``snapshot()``
    (gate grid/phase, coaster regions+velocities, tracker identities)
    — the per-stage schema is owned by the stage, this envelope only
    guarantees versioning, integrity and staleness metadata.
    """

    stream_id: str
    sched_class: str = "standard"
    #: trace-id continuity: the last resolved frame's trace id, so a
    #: migrated stream's first span tree can point back at the source
    #: shard's timeline
    trace_marker: str = ""
    frame_seq: int = 0
    #: wall-clock capture time (time.time) — staleness is judged in
    #: frames-at-fps against the gate's max-skip bound
    captured_at: float = 0.0
    barrier: str = "post_resolve"
    #: the gate's consecutive-skip bound at capture (0 = no gate: the
    #: checkpoint never goes stale on gate grounds)
    max_skip: int = 0
    skips_at_capture: int = 0
    fps: float = 30.0
    stages: dict = field(default_factory=dict)

    def age_s(self, now: float | None = None) -> float:
        return max(0.0, (time.time() if now is None else now)
                   - self.captured_at)

    def is_stale(self, now: float | None = None) -> bool:
        """Staler than the gate's max-skip staleness bound?

        The gate guarantees every object is re-validated by a real
        inference within ``max_skip`` frames; a checkpoint whose
        capture-time skips plus the frames elapsed since capture
        exceed that bound would resume with detections older than the
        gate ever allows — so it is discarded with a forced refresh
        (correctness never depends on restore).
        """
        if self.max_skip <= 0:
            return False
        elapsed_frames = self.age_s(now) * max(self.fps, 0.0)
        return self.skips_at_capture + elapsed_frames > self.max_skip


def _crc(payload: dict) -> int:
    canonical = json.dumps(
        payload, sort_keys=True, separators=(",", ":"), default=float)
    return zlib.crc32(canonical.encode("utf-8")) & 0xFFFFFFFF


def encode(ck: StreamCheckpoint) -> dict:
    """JSON-safe wire form: ``{"v", "crc", "payload"}``."""
    payload = asdict(ck)
    return {"v": SCHEMA_VERSION, "crc": _crc(payload), "payload": payload}


def is_checkpoint_blob(obj) -> bool:
    """Shape test: does ``obj`` look like an encode() product? (The
    registry's streams.json carries either a legacy per-stage state
    dict or this envelope.)"""
    return (isinstance(obj, dict)
            and isinstance(obj.get("payload"), dict)
            and "v" in obj and "crc" in obj)


def decode(blob: dict) -> StreamCheckpoint:
    """Verify version + CRC and rebuild the dataclass.

    Raises ``CheckpointVersionError`` on an unknown schema and
    ``CheckpointCorrupt`` on CRC mismatch or a malformed payload —
    callers degrade to a loud cold start, never a wedge.
    """
    if not is_checkpoint_blob(blob):
        raise CheckpointCorrupt("not a checkpoint envelope")
    if blob["v"] != SCHEMA_VERSION:
        raise CheckpointVersionError(
            f"checkpoint schema v{blob['v']} (this build speaks "
            f"v{SCHEMA_VERSION})")
    payload = blob["payload"]
    if _crc(payload) != blob["crc"]:
        raise CheckpointCorrupt("CRC mismatch")
    try:
        return StreamCheckpoint(
            stream_id=str(payload["stream_id"]),
            sched_class=coerce_priority(payload.get("sched_class")),
            trace_marker=str(payload.get("trace_marker", "")),
            frame_seq=int(payload.get("frame_seq", 0)),
            captured_at=float(payload.get("captured_at", 0.0)),
            barrier=str(payload.get("barrier", "post_resolve")),
            max_skip=int(payload.get("max_skip", 0)),
            skips_at_capture=int(payload.get("skips_at_capture", 0)),
            fps=float(payload.get("fps", 30.0)),
            stages=dict(payload.get("stages") or {}),
        )
    except (KeyError, TypeError, ValueError) as exc:
        raise CheckpointCorrupt(f"malformed payload: {exc}") from exc


class CheckpointStore:
    """Process-global capture/restore plane for stream checkpoints.

    Instances register themselves (weakly — a stream that dies takes
    its registration with it); capture sites name a barrier and, for
    migration-class events, a reason that lands on
    ``evam_stream_migrations_total{reason}``. Checkpoints live in
    memory keyed by stream id and ride the registry's streams.json
    for cross-process crash consistency. Capture runs on stream,
    supervisor and fleet threads, restore on the registry's, summaries
    on the server's: every mutation holds ``_lock``.
    """

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {
        "_ckpts": "_lock",
        "_instances": "_lock",
        "_captured": "_lock",
        "_restored": "_lock",
        "_failures": "_lock",
        "_migrations": "_lock",
        "_last_restore_ms": "_lock",
    }

    def __init__(self, interval: int = 30,
                 restore_timeout_s: float = 2.0) -> None:
        self.interval = max(1, int(interval))
        self.restore_timeout_s = float(restore_timeout_s)
        self._lock = threading.Lock()
        self._ckpts: dict[str, dict] = {}
        self._instances: "weakref.WeakValueDictionary[str, object]" = (
            weakref.WeakValueDictionary())
        self._captured = 0
        self._restored = 0
        self._failures: dict[str, int] = {}
        self._migrations: dict[str, int] = {}
        self._last_restore_ms = 0.0

    # ------------------------------------------------------- registry

    def register(self, stream_id: str, instance) -> None:
        with self._lock:
            self._instances[stream_id] = instance

    def unregister(self, stream_id: str) -> None:
        with self._lock:
            self._instances.pop(stream_id, None)
            self._ckpts.pop(stream_id, None)

    # -------------------------------------------------------- capture

    def capture(self, stream_id: str, barrier: str = "post_resolve",
                reason: str | None = None) -> dict | None:
        """Snapshot one stream's serving state.

        ``reason`` marks a migration-class capture (pre-rebalance
        barrier: shard loss, rebuild, scale-down, drain) and counts
        on ``evam_stream_migrations_total{reason}``; the steady-state
        post-resolve refresh passes reason=None and counts nothing.
        Returns the encoded blob, or None when the stream is unknown
        or a fault stops the capture (the stream then cold-starts —
        loud, never fatal).
        """
        with self._lock:
            instance = self._instances.get(stream_id)
        if instance is None:
            return None
        inj = faults.current()
        if (inj is not None and reason is not None
                and inj.maybe_double_fault()):
            # the drill's "second failure mid-migration": the capture
            # itself dies. Count it where the restore side would have
            # — the stream cold-starts on the destination.
            log.error(
                "checkpoint capture for %s lost to double fault during "
                "%s; stream will cold-start", stream_id, reason)
            self._count_failure("double_fault")
            self._count_migration(reason)
            return None
        try:
            payload = instance.checkpoint_payload()
        except Exception:
            log.exception("checkpoint capture failed for %s", stream_id)
            self._count_failure("capture")
            return None
        if payload is None:
            return None
        ck = StreamCheckpoint(
            stream_id=stream_id,
            captured_at=time.time(),
            barrier=barrier,
            **payload,
        )
        blob = encode(ck)
        if inj is not None and inj.maybe_ckpt_corrupt():
            # deterministic corruption drill: flip the CRC so the
            # restore side exercises the loud-cold-start rung
            blob = dict(blob, crc=blob["crc"] ^ 0xDEADBEEF)
        with self._lock:
            self._ckpts[stream_id] = blob
            self._captured += 1
        if reason is not None:
            self._count_migration(reason)
        return blob

    def capture_all(self, barrier: str = "pre_rebalance",
                    reason: str | None = None) -> int:
        """Pre-rebalance barrier over every registered stream (the
        supervisor's quarantine→rebuild swap checkpoints everything —
        any stream may have in-flight work on the dying engine)."""
        with self._lock:
            ids = list(self._instances.keys())
        return sum(
            1 for sid in ids
            if self.capture(sid, barrier=barrier, reason=reason) is not None)

    # -------------------------------------------------------- restore

    def restore_into(self, blob: dict, instance) -> bool:
        """Apply an encoded checkpoint to a freshly built instance,
        BEFORE its first frame. Returns True on (possibly partial —
        stale keeps identities only) restore; False means cold start.
        Every failure is counted and logged; none raises.
        """
        t0 = time.monotonic()
        inj = faults.current()
        if inj is not None:
            inj.maybe_restore_stall()
        try:
            ck = decode(blob)
        except CheckpointCorrupt as exc:
            log.error(
                "checkpoint CORRUPT (%s) — cold start, state discarded",
                exc)
            self._count_failure("crc")
            return False
        except CheckpointVersionError as exc:
            log.error("checkpoint version mismatch (%s) — cold start", exc)
            self._count_failure("version")
            return False
        elapsed = time.monotonic() - t0
        if (self.restore_timeout_s > 0
                and elapsed > self.restore_timeout_s):
            log.error(
                "checkpoint restore for %s exceeded %.1fs budget "
                "(%.2fs) — cold start", ck.stream_id,
                self.restore_timeout_s, elapsed)
            self._count_failure("timeout")
            return False
        stale = ck.is_stale()
        try:
            instance.restore_checkpoint(ck, stale=stale)
        except Exception:
            log.exception(
                "checkpoint apply failed for %s — cold start",
                ck.stream_id)
            self._count_failure("apply")
            return False
        if stale:
            # identities survived; detections/gate state were dropped
            # with a forced refresh — count the degraded rung
            log.warning(
                "checkpoint for %s staler than the gate bound "
                "(age %.1fs, %d skips at capture, max_skip %d): "
                "identities restored, forced refresh",
                ck.stream_id, ck.age_s(), ck.skips_at_capture,
                ck.max_skip)
            self._count_migration("stale_refresh")
        with self._lock:
            self._restored += 1
            self._last_restore_ms = round(
                (time.monotonic() - t0) * 1e3, 3)
        return True

    def export(self, stream_id: str) -> dict | None:
        with self._lock:
            return self._ckpts.get(stream_id)

    # -------------------------------------------------------- metrics

    def _count_failure(self, reason: str) -> None:
        metrics.inc("evam_ckpt_restore_failures",
                    labels={"reason": reason})
        with self._lock:
            self._failures[reason] = self._failures.get(reason, 0) + 1

    def _count_migration(self, reason: str) -> None:
        metrics.inc("evam_stream_migrations", labels={"reason": reason})
        with self._lock:
            self._migrations[reason] = (
                self._migrations.get(reason, 0) + 1)

    # -------------------------------------------------- introspection

    def summary(self) -> dict:
        """Fixed-shape block for /engines and the soak tools."""
        with self._lock:
            return {
                "enabled": True,
                "streams": len(self._instances),
                "held": len(self._ckpts),
                "captured": self._captured,
                "restored": self._restored,
                "migrations": dict(self._migrations),
                "restore_failures": dict(self._failures),
                "last_restore_ms": self._last_restore_ms,
            }

    def stream_info(self, stream_id: str) -> dict | None:
        """Per-stream block for the instance /status payload."""
        with self._lock:
            blob = self._ckpts.get(stream_id)
        if blob is None:
            return None
        out = {"held": True, "v": blob.get("v")}
        try:
            ck = decode(blob)
        except CheckpointError:
            out["corrupt"] = True
            return out
        out.update(
            barrier=ck.barrier,
            frame_seq=ck.frame_seq,
            age_s=round(ck.age_s(), 3),
            stale=ck.is_stale(),
        )
        return out


_store: CheckpointStore | None = None
_resolved = False
_resolve_lock = threading.Lock()


def active() -> CheckpointStore | None:
    """The process checkpoint store, or None when EVAM_CKPT=off.

    Memoized like faults.current()/trace.active(): the off path costs
    one None-check per call site, and settings are read once.
    """
    global _store, _resolved
    if not _resolved:
        with _resolve_lock:
            if not _resolved:
                from evam_tpu_torch.config.settings import get_settings

                cfg = get_settings().ckpt
                _store = (CheckpointStore(
                    interval=cfg.interval,
                    restore_timeout_s=cfg.restore_timeout_s)
                    if cfg.enabled else None)
                _resolved = True
    return _store


def reset_cache() -> None:
    """Re-resolve from settings on next active() (tests)."""
    global _store, _resolved
    with _resolve_lock:
        _store = None
        _resolved = False
