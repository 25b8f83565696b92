"""Content-adaptive inference gating: skip engine round trips on
temporally redundant frames.

Counterpart of ``evam_tpu/stages/gate.py`` (a copy, numpy only). A
detect stage asks its gate, before ``submit()``, whether a frame needs
inference: a downsampled luma grid (``native.luma_grid``: the native
library, or its numpy copy in ``media/luma.py``) is diffed
against the grid of the last *inferred* frame, and a small controller
with hysteresis, a max-skip bound and a forced-refresh period turns
the score into a run/skip decision. Skipped frames reuse the last
detections through ``stages/track.py`` ``RegionCoaster.coast``.

Activation (per stage, at construction): ``EVAM_GATE=off`` beats
everything; ``inference-interval: "adaptive"`` enables the gate for
that stage; ``EVAM_GATE=on`` enables it for every detect stage.

Knobs (property beats env beats default): ``gate-threshold`` /
``EVAM_GATE_THRESHOLD`` (mean |Δluma| per cell, 0-255, at or above
which the scene counts as moving), ``gate-threshold-lo`` /
``EVAM_GATE_THRESHOLD_LO`` (hysteresis exit, default threshold/2),
``gate-max-skip`` / ``EVAM_GATE_MAX_SKIP`` (bound on consecutive
skips), ``gate-refresh`` / ``EVAM_GATE_REFRESH`` (forced re-inference
period in frames, 0 = off). With the control plane on (``EVAM_TUNE``)
its ``gate_scale`` stretches both thresholds, unless this gate's were
set explicitly (``pinned``).

Observability: ``evam_gate_ran_total{engine}`` and
``evam_gate_skipped_total{engine}``, per-stream state on
``/pipelines/.../{id}/status``, and the process-wide ``registry``
behind the ``gate`` block of ``/healthz``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass

import numpy as np

from evam_tpu_torch import native
from evam_tpu_torch.control.state import current_op
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.stages.gate")

#: luma-grid resolution: coarse enough to be free per frame, fine
#: enough that an object crossing 1/16th of the frame moves the score
GRID_H = 16
GRID_W = 16

#: window over which a gate's recent skipped-frames/s is computed
RATE_WINDOW_S = 5.0


def _env_float(key: str, default: float) -> float:
    try:
        return float(os.environ.get(key, "") or default)
    except ValueError:
        return default


def _env_int(key: str, default: int) -> int:
    try:
        return int(os.environ.get(key, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class GateConfig:
    """Resolved gate knobs for one stage."""

    enabled: bool = False
    #: mean |Δluma| (0-255) at or above which the scene is "moving"
    threshold: float = 2.0
    #: hysteresis exit: once moving, stay moving until the score drops
    #: to this (default threshold/2)
    threshold_lo: float = 1.0
    #: hard bound on consecutive skipped frames
    max_skip: int = 8
    #: forced-refresh period in frames (0 = rely on max_skip alone)
    refresh: int = 30
    #: the thresholds were set explicitly (property or env var): the
    #: control plane's gate_scale leaves this gate alone
    pinned: bool = False

    @classmethod
    def from_properties(cls, properties: dict) -> "GateConfig":
        """Property beats env beats default; ``EVAM_GATE=off`` beats
        everything."""
        env_gate = os.environ.get("EVAM_GATE", "").strip().lower()
        interval = properties.get("inference-interval", 1)
        adaptive = (isinstance(interval, str)
                    and interval.strip().lower() == "adaptive")
        if env_gate in ("off", "0", "false"):
            enabled = False
        else:
            enabled = adaptive or env_gate in ("on", "1", "true")
        thr = float(properties.get(
            "gate-threshold", _env_float("EVAM_GATE_THRESHOLD", 2.0)))
        lo_default = _env_float("EVAM_GATE_THRESHOLD_LO", thr / 2.0)
        lo = float(properties.get("gate-threshold-lo", lo_default))
        pinned = ("gate-threshold" in properties
                  or "gate-threshold-lo" in properties
                  or "EVAM_GATE_THRESHOLD" in os.environ
                  or "EVAM_GATE_THRESHOLD_LO" in os.environ)
        return cls(
            enabled=enabled,
            threshold=thr,
            threshold_lo=min(lo, thr),
            max_skip=max(1, int(properties.get(
                "gate-max-skip", _env_int("EVAM_GATE_MAX_SKIP", 8)))),
            refresh=max(0, int(properties.get(
                "gate-refresh", _env_int("EVAM_GATE_REFRESH", 30)))),
            pinned=pinned,
        )


class MotionGate:
    """Per-stream run/skip controller, called from that stream's thread
    only. ``decide(frame)`` scores the frame against the last INFERRED
    frame (so slow drift accumulates against the anchor and eventually
    crosses the threshold) and applies, in order: the first-frame,
    forced-refresh and max-skip bounds, then the hysteresis state
    machine."""

    def __init__(self, cfg: GateConfig, engine_name: str = "",
                 clock=time.monotonic):
        self.cfg = cfg
        self.engine_name = engine_name
        self._clock = clock
        self._ref_grid: np.ndarray | None = None
        self._pending_grid: np.ndarray | None = None
        self._moving = True  # conservative until the first score
        self.ran = 0
        self.skipped = 0
        self.consecutive_skips = 0
        self.max_consecutive_skips = 0
        self._since_run = 0
        self.last_score = 0.0
        #: times of recent skips, pruned to RATE_WINDOW_S
        self._skip_times: deque[float] = deque(maxlen=8192)
        registry.add(self)

    # ------------------------------------------------------- decision

    def score(self, frame: np.ndarray) -> float:
        """Mean |Δluma| per grid cell (0-255) against the last inferred
        frame; +inf when there is none yet (the first frame)."""
        self._pending_grid = native.luma_grid(frame, GRID_H, GRID_W)
        if self._ref_grid is None:
            return float("inf")
        d = np.abs(self._pending_grid.astype(np.int16)
                   - self._ref_grid.astype(np.int16))
        return float(d.mean())

    def decide(self, frame: np.ndarray) -> bool:
        """True = run inference on this frame; False = skip (coast)."""
        run = self.apply(self.score(frame))
        if run:
            # the anchor advances only on inferred frames
            self._ref_grid = self._pending_grid
        return run

    def apply(self, s: float) -> bool:
        """The controller alone: bounds first, then hysteresis; updates
        the counters."""
        self.last_score = s if np.isfinite(s) else 0.0
        if not np.isfinite(s):
            run = True  # the first frame always infers
        elif self.cfg.refresh and self._since_run + 1 >= self.cfg.refresh:
            run = True  # forced refresh: the drift bound
        elif self.consecutive_skips >= self.cfg.max_skip:
            run = True  # the staleness bound
        else:
            # hysteresis: enter "moving" at threshold, leave at
            # threshold_lo; the control plane's gate_scale stretches
            # both unless this gate's thresholds are pinned (max_skip
            # and refresh hold at any operating point)
            thr = self.cfg.threshold
            lo = self.cfg.threshold_lo
            if not self.cfg.pinned:
                op = current_op()
                if op is not None and op.gate_scale != 1.0:
                    thr *= op.gate_scale
                    lo *= op.gate_scale
            if s >= thr:
                self._moving = True
            elif s <= lo:
                self._moving = False
            run = self._moving
        if run:
            self.ran += 1
            self.consecutive_skips = 0
            self._since_run = 0
            metrics.inc("evam_gate_ran", labels={"engine": self.engine_name})
            registry.note(ran=1)
        else:
            self.skipped += 1
            self.consecutive_skips += 1
            self._since_run += 1
            self.max_consecutive_skips = max(
                self.max_consecutive_skips, self.consecutive_skips)
            self._skip_times.append(self._clock())
            metrics.inc("evam_gate_skipped",
                        labels={"engine": self.engine_name})
            registry.note(skipped=1)
        return run

    # -------------------------------------------------- introspection

    def skipped_fps(self, now: float | None = None) -> float:
        """Recent skip rate (frames/s) over RATE_WINDOW_S."""
        now = self._clock() if now is None else now
        cutoff = now - RATE_WINDOW_S
        while self._skip_times and self._skip_times[0] < cutoff:
            self._skip_times.popleft()
        return len(self._skip_times) / RATE_WINDOW_S

    def state_dict(self) -> dict:
        """Serializable controller state (the luma anchor, the
        hysteresis phase and the skip counters) for a stream
        checkpoint."""
        return {
            "ref_grid": (self._ref_grid.tolist()
                         if self._ref_grid is not None else None),
            "moving": bool(self._moving),
            "consecutive_skips": int(self.consecutive_skips),
            "since_run": int(self._since_run),
            "last_score": float(self.last_score),
        }

    def load_state(self, state: dict) -> None:
        """Re-apply a ``state_dict()`` on a fresh gate. A grid of
        another shape is dropped (the next frame then infers)."""
        grid = state.get("ref_grid")
        if grid is not None:
            arr = np.asarray(grid, dtype=np.uint8)
            if arr.shape == (GRID_H, GRID_W):
                self._ref_grid = arr
        self._moving = bool(state.get("moving", True))
        self.consecutive_skips = int(state.get("consecutive_skips", 0))
        self._since_run = int(state.get("since_run", 0))
        self.last_score = float(state.get("last_score", 0.0))

    def force_refresh(self) -> None:
        """Drop the anchor so the next frame infers unconditionally."""
        self._ref_grid = None
        self._moving = True
        self.consecutive_skips = 0
        self._since_run = 0

    def snapshot(self) -> dict:
        """Per-stream gate state for /pipelines/.../{id}/status."""
        total = self.ran + self.skipped
        return {
            "enabled": self.cfg.enabled,
            "ran": self.ran,
            "skipped": self.skipped,
            "skip_rate": round(self.skipped / total, 3) if total else 0.0,
            "moving": self._moving,
            "last_score": round(self.last_score, 3),
            "consecutive_skips": self.consecutive_skips,
            "max_consecutive_skips": self.max_consecutive_skips,
            "max_skip": self.cfg.max_skip,
        }


class GateRegistry:
    """Process-wide gate aggregation: cumulative ran/skipped counters
    that survive stream churn (the /healthz totals stay monotonic), and
    a weak set of live gates whose recent skip rates it sums."""

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {
        "_gates": "_lock",
        "_ran": "_lock",
        "_skipped": "_lock",
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gates: "weakref.WeakSet[MotionGate]" = weakref.WeakSet()
        self._ran = 0
        self._skipped = 0

    def add(self, gate: MotionGate) -> None:
        with self._lock:
            if gate.cfg.enabled:
                self._gates.add(gate)

    def note(self, ran: int = 0, skipped: int = 0) -> None:
        with self._lock:
            self._ran += ran
            self._skipped += skipped

    def skipped_fps(self) -> float:
        """Summed recent skipped-frames/s across live gated streams."""
        with self._lock:
            gates = list(self._gates)
        return sum(g.skipped_fps() for g in gates)

    def summary(self) -> dict:
        """Fixed-shape aggregate for /healthz."""
        with self._lock:
            gates = list(self._gates)
            ran, skipped = self._ran, self._skipped
        total = ran + skipped
        return {
            "streams": len(gates),
            "ran": ran,
            "skipped": skipped,
            "skip_rate": round(skipped / total, 3) if total else 0.0,
            "skipped_fps": round(sum(g.skipped_fps() for g in gates), 1),
        }

    def reset(self) -> None:
        """Drop the cumulative counters and the live gates (tests)."""
        with self._lock:
            self._gates = weakref.WeakSet()
            self._ran = 0
            self._skipped = 0


#: the process-wide registry
registry = GateRegistry()


def maybe_gate(properties: dict, engine_name: str = "") -> MotionGate | None:
    """A MotionGate when the resolved config enables gating, else None
    (the static-interval path)."""
    cfg = GateConfig.from_properties(properties)
    if not cfg.enabled:
        return None
    log.info(
        "motion gate on (engine %s): threshold %.2f/%.2f, max_skip %d, "
        "refresh %d", engine_name, cfg.threshold, cfg.threshold_lo,
        cfg.max_skip, cfg.refresh,
    )
    return MotionGate(cfg, engine_name=engine_name)
