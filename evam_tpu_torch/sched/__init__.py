"""SLO-aware scheduling: admission control, priority classes, load
shedding — the QoS layer between REST and the shared batch engines
(counterpart of ``evam_tpu/sched``).

* ``sched.admission`` — ``AdmissionController``: over-capacity starts
  answer 503 with Retry-After, from a capacity model over the engines'
  stage clock;
* ``sched.classes``   — the classes (realtime|standard|batch),
  ``SchedConfig`` (the EVAM_SCHED_* knobs) and ``ClassQueues``;
* ``sched.shedder``   — per-class staleness budgets enforced at
  dispatch, oldest first, as ``ShedError``.

With EVAM_SCHED off the engines keep their single-FIFO path.
"""

from evam_tpu_torch.sched.admission import (
    CLASS_HEADROOM,
    AdmissionController,
    AdmissionError,
)
from evam_tpu_torch.sched.classes import (
    DEFAULT_PRIORITY,
    PRIORITIES,
    ClassQueues,
    SchedConfig,
    validate_priority,
)
from evam_tpu_torch.sched.shedder import Shedder, ShedError

__all__ = [
    "CLASS_HEADROOM",
    "AdmissionController",
    "AdmissionError",
    "ClassQueues",
    "DEFAULT_PRIORITY",
    "PRIORITIES",
    "SchedConfig",
    "Shedder",
    "ShedError",
    "validate_priority",
]
