"""Fault injection (counterpart of ``evam_tpu/obs/faults.py``).

Enabled only through the ``EVAM_FAULT_INJECT`` environment variable,
e.g.:

    EVAM_FAULT_INJECT="drop=0.01,stall=0.001,stall_ms=200,corrupt=0.005"

Known keys (all probabilities are per consult, 0..1):

* ``drop``     — probability a video frame is dropped before the chain
                 (audio events carry frame=None and are never dropped).
* ``stall``    — probability the stream thread sleeps ``stall_ms``
                 before processing a frame (decode jitter).
* ``stall_ms`` — duration of an injected stall (default 100).
* ``corrupt``  — probability one frame row is overwritten with noise.
* ``error``    — probability a RuntimeError is raised for the frame
                 (exercises the runner's per-frame error isolation).
* ``wedge``    — probability ONE engine batch blocks its launching
                 thread for ``wedge_s`` seconds, holding the engine's
                 device lock, just before the graph replay or the
                 eager step — the hung-device-call failure mode. Long
                 enough wedges trip the stall watchdog and drive the
                 supervisor's quarantine → rebuild path.
* ``wedge_s``  — duration of an injected wedge (seconds, default 30).
* ``wedge_n``  — maximum number of wedge events (default unlimited);
                 ``wedge=1,wedge_n=1`` wedges exactly the first
                 dispatched batch.
* ``shard_loss``   — probability a fleet shard is retired mid-dispatch
                 (``fleet/engine.py`` consults per submit); its streams
                 migrate along the rebalance path.
* ``shard_loss_n`` — maximum shard-loss events (default unlimited).
* ``ckpt_corrupt`` — probability a captured checkpoint is stored with
                 a flipped CRC (the restore side then cold-starts).
* ``double_fault`` — probability a migration-class checkpoint capture
                 fails (the second failure during a migration).
* ``restore_ms``   — injected checkpoint-restore stall in ms; past
                 EVAM_CKPT_RESTORE_TIMEOUT_S the restore is abandoned
                 for a cold start (reason="timeout").

``EVAM_FAULT_SEED`` (integer) seeds the injector's ``random.Random``
so chaos runs are reproducible: one spec and one seed give the same
decisions and the same corrupted rows as the reference's injector.
Unset means a fresh nondeterministic seed per process.

The runner consults the injector per frame and the BatchEngine per
batch dispatch.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time

import numpy as np

from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.obs.faults")


#: the fault-injection environment surface
ENV_KEYS: tuple[str, ...] = ("EVAM_FAULT_INJECT", "EVAM_FAULT_SEED")

#: spec keys accepted inside EVAM_FAULT_INJECT, in doc order
SPEC_KEYS: tuple[str, ...] = ("drop", "stall", "stall_ms", "corrupt",
                              "error", "wedge", "wedge_s", "wedge_n",
                              "shard_loss", "shard_loss_n",
                              "ckpt_corrupt", "double_fault",
                              "restore_ms")

_KNOWN_KEYS = set(SPEC_KEYS)


class FaultInjector:
    def __init__(self, spec: str = "", seed: int | None = None):
        cfg = {}
        for part in (spec or "").split(","):
            if not part.strip():
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            try:
                value = float(v)
            except ValueError:
                log.warning("EVAM_FAULT_INJECT: ignoring malformed entry %r",
                            part)
                continue
            if k not in _KNOWN_KEYS:
                log.warning("EVAM_FAULT_INJECT: unknown key %r (known: %s)",
                            k, sorted(_KNOWN_KEYS))
                continue
            cfg[k] = value
        self.drop_p = cfg.get("drop", 0.0)
        self.stall_p = cfg.get("stall", 0.0)
        self.stall_ms = cfg.get("stall_ms", 100.0)
        self.corrupt_p = cfg.get("corrupt", 0.0)
        self.error_p = cfg.get("error", 0.0)
        self.wedge_p = cfg.get("wedge", 0.0)
        self.wedge_s = cfg.get("wedge_s", 30.0)
        #: remaining wedge events; < 0 means unlimited
        self._wedge_left = int(cfg.get("wedge_n", -1))
        self.shard_loss_p = cfg.get("shard_loss", 0.0)
        #: remaining shard-loss events; < 0 means unlimited
        self._shard_loss_left = int(cfg.get("shard_loss_n", -1))
        self.ckpt_corrupt_p = cfg.get("ckpt_corrupt", 0.0)
        self.double_fault_p = cfg.get("double_fault", 0.0)
        self.restore_ms = cfg.get("restore_ms", 0.0)
        self._rng = random.Random(seed)
        # one injector is shared by every stream thread AND every
        # engine dispatcher (from_env cache) — the wedge countdown
        # must decrement exactly once per event
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return any(
            p > 0 for p in (self.drop_p, self.stall_p, self.corrupt_p,
                            self.error_p, self.wedge_p,
                            self.shard_loss_p, self.ckpt_corrupt_p,
                            self.double_fault_p, self.restore_ms)
        )

    def apply(self, frame: np.ndarray | None):
        """Returns the (possibly corrupted) frame, or None to drop.
        May sleep (stall) or raise (error). Drop applies only to video
        frames (audio events carry frame=None and can't be dropped
        here), so the drop metric counts real drops only."""
        if (
            self.drop_p
            and frame is not None
            and self._rng.random() < self.drop_p
        ):
            metrics.inc("evam_faults_injected", labels={"kind": "drop"})
            return None
        if self.stall_p and self._rng.random() < self.stall_p:
            metrics.inc("evam_faults_injected", labels={"kind": "stall"})
            time.sleep(self.stall_ms / 1e3)
        if self.error_p and self._rng.random() < self.error_p:
            metrics.inc("evam_faults_injected", labels={"kind": "error"})
            raise RuntimeError("injected fault (EVAM_FAULT_INJECT error)")
        if (
            self.corrupt_p
            and frame is not None
            and self._rng.random() < self.corrupt_p
        ):
            metrics.inc("evam_faults_injected", labels={"kind": "corrupt"})
            frame = frame.copy()
            h = frame.shape[0]
            frame[self._rng.randrange(h)] = self._rng.randrange(256)
        return frame

    def maybe_wedge(self, name: str = "") -> None:
        """Engine-side consult (``BatchEngine._execute``, on the
        launching thread, under the engine's device lock): with
        probability ``wedge`` block for ``wedge_s`` seconds —
        indistinguishable, for the watchdog and the supervisor, from a
        hung device call."""
        if not self.wedge_p:
            return
        with self._lock:
            if self._wedge_left == 0:
                return
            if self._rng.random() >= self.wedge_p:
                return
            if self._wedge_left > 0:
                self._wedge_left -= 1
        metrics.inc("evam_faults_injected", labels={"kind": "wedge"})
        log.error("injected wedge: stalling engine %s for %.1fs "
                  "(EVAM_FAULT_INJECT)", name or "?", self.wedge_s)
        time.sleep(self.wedge_s)

    def maybe_shard_loss(self, name: str = "") -> bool:
        """Fleet-side consult (FleetEngine.submit, per dispatch): True
        means "this shard just died" — the caller retires it and the
        rebalance path migrates its streams. The deterministic shape
        ``shard_loss=1,shard_loss_n=1`` kills exactly one shard."""
        if not self.shard_loss_p:
            return False
        with self._lock:
            if self._shard_loss_left == 0:
                return False
            if self._rng.random() >= self.shard_loss_p:
                return False
            if self._shard_loss_left > 0:
                self._shard_loss_left -= 1
        metrics.inc("evam_faults_injected",
                    labels={"kind": "shard_loss"})
        log.error("injected shard loss: retiring shard %s mid-dispatch "
                  "(EVAM_FAULT_INJECT)", name or "?")
        return True

    def maybe_ckpt_corrupt(self) -> bool:
        """Checkpoint-capture consult: True = store the blob with a
        flipped CRC so the restore side must take the loud-cold-start
        rung (never a wedge)."""
        if not self.ckpt_corrupt_p:
            return False
        with self._lock:
            hit = self._rng.random() < self.ckpt_corrupt_p
        if hit:
            metrics.inc("evam_faults_injected",
                        labels={"kind": "ckpt_corrupt"})
            log.error("injected checkpoint corruption "
                      "(EVAM_FAULT_INJECT ckpt_corrupt)")
        return hit

    def maybe_double_fault(self) -> bool:
        """Migration-capture consult: True = the capture itself fails
        (the second failure during a migration) — the stream
        cold-starts on the destination shard."""
        if not self.double_fault_p:
            return False
        with self._lock:
            hit = self._rng.random() < self.double_fault_p
        if hit:
            metrics.inc("evam_faults_injected",
                        labels={"kind": "double_fault"})
        return hit

    def maybe_restore_stall(self) -> None:
        """Checkpoint-restore consult: sleep ``restore_ms`` so the
        restore-timeout degradation rung is drillable."""
        if self.restore_ms <= 0:
            return
        metrics.inc("evam_faults_injected",
                    labels={"kind": "restore_stall"})
        time.sleep(self.restore_ms / 1e3)


_cache: tuple[tuple[str, str], FaultInjector | None] | None = None
#: process-wide memo for the hot path: a 1-tuple holding the resolved
#: injector (or None). ``current()`` reads it without touching the
#: environment — BatchEngine consults per BATCH, and two getenv calls
#: plus a tuple compare per batch is real dispatcher-thread work at
#: the serving rate. Cleared by ``reset_cache()`` (the explicit
#: reconfiguration hook) and refreshed by any ``from_env()`` call.
_resolved: tuple[FaultInjector | None] | None = None


def current() -> FaultInjector | None:
    """Hot-path accessor: the memoized injector, no env reads.

    Resolution happens once — the first call after import or after
    ``reset_cache()`` pays the env read + parse (via ``from_env``);
    every later call is one global load. Code that changes
    ``EVAM_FAULT_INJECT``/``EVAM_FAULT_SEED`` at runtime must call
    ``reset_cache()`` for engines to observe the new spec."""
    if _resolved is not None:
        return _resolved[0]
    return from_env()


def from_env() -> FaultInjector | None:
    """Injector for the current EVAM_FAULT_INJECT value, parsed (and
    its ACTIVE warning logged) once per distinct (spec, seed) — runners
    are created per stream and per reconnect attempt, and the engines
    consult per batch (through the memoized ``current()``); they all
    share one injector so wedge_n and the seeded RNG stream are
    global."""
    global _cache, _resolved
    spec = os.environ.get("EVAM_FAULT_INJECT", "")
    seed_str = os.environ.get("EVAM_FAULT_SEED", "")
    if _cache is not None and _cache[0] == (spec, seed_str):
        _resolved = (_cache[1],)
        return _cache[1]
    seed: int | None = None
    if seed_str:
        try:
            seed = int(seed_str)
        except ValueError:
            log.warning("EVAM_FAULT_SEED %r is not an integer; ignoring",
                        seed_str)
    inj = FaultInjector(spec, seed=seed)
    result = inj if inj.active else None
    if result is not None:
        log.warning("fault injection ACTIVE: %s%s", spec,
                    f" (seed={seed})" if seed is not None else "")
    _cache = ((spec, seed_str), result)
    _resolved = (result,)
    return result


def reset_cache() -> None:
    """Drop the cached injector (tests: a fresh spec must re-parse, a
    reused spec must restart its wedge_n countdown, and the engines'
    memoized ``current()`` view must re-resolve)."""
    global _cache, _resolved
    _cache = None
    _resolved = None
