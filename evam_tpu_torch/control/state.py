"""Live operating point: the control plane's hot-path surface
(counterpart of ``evam_tpu/control/state.py``).

The controller (``control/controller.py``) swaps a frozen
:class:`OperatingPoint` into the process-wide :class:`TuneState` each
tick. Hot paths — the engine's dispatch loops, the motion gate,
admission, the shedder — read it through :func:`current_op`, which
memoizes the ``EVAM_TUNE`` decision: with the controller off (the
default) every consult is one global load and a ``None`` check.

Neutral values (1.0 scales, 0 overrides) mean "use the static setting":
a fresh ``TuneState`` serves the boot configuration until the
controller's first action, and a pinned knob never leaves neutral.
Consumers pull from this one object, so a supervisor rebuild inherits
the current setpoints; the one pushed knob (the upload-queue depth) is
read again when an engine is built and pushed by the controller's next
tick. Configuration comes from ``config/settings.py`` only.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class OperatingPoint:
    """One immutable set of controller setpoints; the default instance
    changes nothing."""

    #: multiplier on batch-formation deadlines (engine and per class)
    deadline_scale: float = 1.0
    #: cap on items collected per batch (0 = the engine's max_batch)
    batch_cap: int = 0
    #: pipelined-transfer upload-queue depth (0 = EVAM_TRANSFER_DEPTH)
    transfer_depth: int = 0
    #: multiplier on motion-gate thresholds
    gate_scale: float = 1.0
    #: admission utilization ceiling (0 = EVAM_SCHED_ADMIT_UTIL)
    admit_util: float = 0.0
    #: per-tick EWMA of live serving capacity in frames/s (0 = let
    #: admission derive it)
    capacity_fps: float = 0.0
    #: multiplier on per-class staleness budgets
    staleness_scale: float = 1.0
    #: target fleet size (0 = no target: the eighth law at rest)
    fleet_shards: int = 0

    def to_dict(self) -> dict:
        return {
            "deadline_scale": self.deadline_scale,
            "batch_cap": self.batch_cap,
            "transfer_depth": self.transfer_depth,
            "gate_scale": self.gate_scale,
            "admit_util": self.admit_util,
            "capacity_fps": self.capacity_fps,
            "staleness_scale": self.staleness_scale,
            "fleet_shards": self.fleet_shards,
        }


#: the signal vocabulary /scheduler reports (golden-pinned): what the
#: controller's last tick acted on
ZERO_SIGNALS = {
    "utilization": 0.0,
    "queue_depth": 0.0,
    "oldest_age_s": 0.0,
    "h2d_wait_ms": 0.0,
    "launch_ms": 0.0,
    "shed_delta": 0.0,
    "skip_fps": 0.0,
    "batch_p95": 0.0,
    "capacity_fps": 0.0,
    "demand_fps": 0.0,
    "fleet_shards": 0.0,
    "fleet_max_shards": 0.0,
}


class TuneState:
    """Process-wide controller state: the live operating point, the
    signals that produced it, and a bounded action log. ``op`` is
    swapped whole (readers take no lock); the rest changes under the
    lock."""

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {
        "op": "_lock",
        "ticks": "_lock",
        "signals": "_lock",
        "_actions": "_lock",
    }

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self._lock = threading.Lock()
        self.op = OperatingPoint()
        self.ticks = 0
        self.signals = dict(ZERO_SIGNALS)
        self._actions: deque = deque(maxlen=max(1, int(cfg.actions)))

    def install(self, op: OperatingPoint, signals: dict) -> None:
        """Publish one tick's outcome (controller thread only)."""
        with self._lock:
            self.op = op
            self.ticks += 1
            self.signals = {k: float(signals.get(k, 0.0))
                            for k in ZERO_SIGNALS}

    def record(self, action: dict) -> None:
        with self._lock:
            self._actions.append(dict(action))

    def snapshot(self) -> dict:
        """The /scheduler ``tuning`` block (fixed keys)."""
        with self._lock:
            op = self.op
            ticks = self.ticks
            signals = dict(self.signals)
            actions = [dict(a) for a in self._actions]
        return {
            "enabled": True,
            "ticks": ticks,
            "operating_point": op.to_dict(),
            "signals": signals,
            "actions": actions,
        }


def disabled_snapshot() -> dict:
    """The same shape with the controller off."""
    return {
        "enabled": False,
        "ticks": 0,
        "operating_point": OperatingPoint().to_dict(),
        "signals": dict(ZERO_SIGNALS),
        "actions": [],
    }


#: the memoized EVAM_TUNE decision — (state,) once resolved, None
#: before (the tuple tells "resolved to off" from "not yet resolved")
_resolved: tuple[TuneState | None] | None = None


def active() -> TuneState | None:
    """The process TuneState, or None with EVAM_TUNE off."""
    if _resolved is not None:
        return _resolved[0]
    return _resolve()


def _resolve() -> TuneState | None:
    global _resolved
    from evam_tpu_torch.config.settings import get_settings

    cfg = get_settings().tune
    state = TuneState(cfg) if cfg.enabled else None
    _resolved = (state,)
    return state


def current_op() -> OperatingPoint | None:
    """The live operating point, or None with EVAM_TUNE off."""
    state = active()
    return None if state is None else state.op


def reset_cache() -> None:
    """Drop the memo (tests, A/B flips)."""
    global _resolved
    _resolved = None
