"""Workload-aware self-tuning control plane (counterpart of
``evam_tpu/control``).

- ``state``: the memoized live :class:`OperatingPoint` — one
  ``None`` check on every hot path with EVAM_TUNE off — swapped whole by
  the controller each tick. Consumers (the engine's dispatch loops, the
  motion gate, admission, the shedder) pull scalar setpoints; the
  upload-queue depth is pushed through ``EngineHub.retune``.
- ``controller``: the feedback loop — per-signal laws with damping and
  per-knob cooldowns, clamped away from any knob the operator set.

``GET /scheduler`` reports the operating point, the signals that
produced it and the last actions with their reasons.
"""

from evam_tpu_torch.control.controller import TuneController
from evam_tpu_torch.control.state import (
    OperatingPoint,
    TuneState,
    active,
    current_op,
    disabled_snapshot,
    reset_cache,
)

__all__ = [
    "OperatingPoint",
    "TuneController",
    "TuneState",
    "active",
    "current_op",
    "disabled_snapshot",
    "reset_cache",
]
