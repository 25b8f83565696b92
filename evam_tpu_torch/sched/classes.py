"""Priority classes and per-class work queues for the QoS layer
(counterpart of ``evam_tpu/sched/classes.py``).

Three classes:

* ``realtime`` — live cameras; small batch-formation deadline, tight
  staleness budget, drained first;
* ``standard`` — the default; the engine's behaviour without classes;
* ``batch``    — bulk and offline re-runs; a long formation deadline
  (fill large buckets), a generous staleness budget, first to shed.

``SchedConfig`` is the resolved knob set (policy as data: the dispatch
loop only reads it) and ``ClassQueues`` the per-class FIFOs that replace
the engine's single queue, drained realtime-first with a pick that no
class can starve.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any

#: scheduling classes, highest priority first (drain order)
PRIORITIES = ("realtime", "standard", "batch")

DEFAULT_PRIORITY = "standard"

#: consecutive times a non-empty class may be passed over before it
#: must be picked: under contention realtime gets ~4× standard and ~12×
#: batch
STARVATION_LIMITS = {"standard": 4, "batch": 12}


def coerce_priority(value: Any, default: str = DEFAULT_PRIORITY) -> str:
    """Best-effort normalization (restored state): an unknown value
    falls back to ``default`` instead of raising."""
    if isinstance(value, str) and value.strip().lower() in PRIORITIES:
        return value.strip().lower()
    return default


def validate_priority(value: Any) -> str:
    """Normalize and validate a request's or a spec's ``priority``."""
    if not isinstance(value, str):
        raise ValueError(
            f"priority must be one of {'|'.join(PRIORITIES)}, "
            f"got {value!r}")
    prio = value.strip().lower()
    if prio not in PRIORITIES:
        raise ValueError(
            f"unknown priority {value!r}; valid values: "
            f"{'|'.join(PRIORITIES)}")
    return prio


@dataclasses.dataclass(frozen=True)
class SchedConfig:
    """Resolved scheduler knobs (``config/settings.py``
    ``SchedSettings``). Frozen: the dispatcher and the admission
    controller read it without a lock."""

    enabled: bool = True
    #: projected-utilization ceiling for admission (0 disables it)
    admit_util: float = 0.85
    #: declared serving capacity in frames/s (0: derive it)
    capacity_fps: float = 0.0
    #: assumed per-stream demand when a start declares no fps
    default_fps: float = 30.0
    #: per-class batch-formation deadline (ms)
    deadline_ms: dict[str, float] = dataclasses.field(
        default_factory=lambda: {
            "realtime": 4.0, "standard": 8.0, "batch": 25.0})
    #: per-class staleness budget (ms); 0 never sheds that class
    staleness_ms: dict[str, float] = dataclasses.field(
        default_factory=lambda: {
            "realtime": 200.0, "standard": 1000.0, "batch": 5000.0})

    def deadline_s(self, priority: str) -> float:
        return self.deadline_ms.get(priority, 8.0) / 1e3

    def staleness_s(self) -> dict[str, float]:
        return {c: ms / 1e3 for c, ms in self.staleness_ms.items()}

    @classmethod
    def from_settings(cls, s,
                      standard_deadline_ms: float | None = None
                      ) -> "SchedConfig":
        """From ``SchedSettings``. Unless EVAM_SCHED_DEADLINE_MS_STANDARD
        was set, the ``standard`` class follows the engine-level
        ``standard_deadline_ms`` (EVAM_BATCH_DEADLINE_MS): turning the
        scheduler on does not repeal a tuned global deadline."""
        std = s.deadline_ms_standard
        if (standard_deadline_ms is not None
                and "deadline_ms_standard" not in s.fields_set):
            std = standard_deadline_ms
        return cls(
            enabled=s.enabled,
            admit_util=s.admit_util,
            capacity_fps=s.capacity_fps,
            default_fps=s.default_fps,
            deadline_ms={
                "realtime": s.deadline_ms_realtime,
                "standard": std,
                "batch": s.deadline_ms_batch,
            },
            staleness_ms={
                "realtime": s.staleness_ms_realtime,
                "standard": s.staleness_ms_standard,
                "batch": s.staleness_ms_batch,
            },
        )

    @classmethod
    def disabled(cls) -> "SchedConfig":
        return cls(enabled=False, admit_util=0.0)


class ClassQueues:
    """Per-class FIFO queues with a starvation-proof realtime-first
    pick — the scheduler's replacement for the engine's single queue.

    Items expose ``t_submit`` (perf_counter at enqueue) and ``future``
    (the engine's ``_WorkItem``). All state is guarded by one condition
    variable; a put is a deque append and a notify.

    Pick policy: the highest-priority non-empty class wins, except that
    a class passed over ``STARVATION_LIMITS[cls]`` consecutive times is
    served first (the lowest class checked first, so ``batch`` cannot
    starve behind a starving ``standard``).
    """

    #: thread-shared attributes and the lock that guards each (the
    #: ``locks`` pass of ``evam_tpu_torch.analysis`` checks them)
    SHARED_UNDER = {
        "_q": "_cv",
        "_starve": "_cv",
        "_closed": "_cv",
    }

    def __init__(self, starvation_limits: dict[str, int] | None = None):
        self._limits = dict(starvation_limits or STARVATION_LIMITS)
        self._cv = threading.Condition()
        self._q: dict[str, deque] = {c: deque() for c in PRIORITIES}
        self._starve = {c: 0 for c in PRIORITIES}
        self._closed = False

    # ------------------------------------------------------ submit side

    def put(self, priority: str, item) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError("scheduler queues are closed")
            self._q[priority].append(item)
            self._cv.notify_all()

    # -------------------------------------------------- dispatcher side

    def pick(self, timeout: float) -> str | None:
        """Block until any class has work (or ``timeout``); return the
        class the policy chooses, or None on timeout or once closed and
        empty."""
        deadline = time.perf_counter() + timeout
        with self._cv:
            while True:
                nonempty = [c for c in PRIORITIES if self._q[c]]
                if nonempty:
                    break
                if self._closed:
                    return None
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)
            chosen = None
            for c in reversed(PRIORITIES):
                limit = self._limits.get(c)
                if limit and c in nonempty and self._starve[c] >= limit:
                    chosen = c
                    break
            if chosen is None:
                chosen = nonempty[0]
            for c in nonempty:
                if c != chosen:
                    self._starve[c] += 1
            self._starve[chosen] = 0
            return chosen

    def collect(self, priority: str, max_n: int,
                deadline_s: float) -> list:
        """Form one batch from ``priority``'s queue: wait until it holds
        ``max_n`` items or ``deadline_s`` past the head item's submit
        (a backlog dispatches a full bucket at once, a trickle at the
        deadline)."""
        with self._cv:
            dq = self._q[priority]
            if not dq:
                return []
            deadline = dq[0].t_submit + deadline_s
            while len(dq) < max_n and not self._closed:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            return [dq.popleft() for _ in range(min(max_n, len(dq)))]

    def pop_expired(self, priority: str, min_t_submit: float) -> list:
        """Remove and return the head items submitted before
        ``min_t_submit`` (FIFO: every expired item sits at the head)."""
        out = []
        with self._cv:
            dq = self._q[priority]
            while dq and dq[0].t_submit < min_t_submit:
                out.append(dq.popleft())
        return out

    # ------------------------------------------------------- lifecycle

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def drain(self) -> list:
        """Remove and return every queued item (stop, stall, abandon:
        the engine fails their futures)."""
        out = []
        with self._cv:
            for dq in self._q.values():
                out.extend(dq)
                dq.clear()
        return out

    # -------------------------------------------------- introspection

    def empty(self) -> bool:
        with self._cv:
            return not any(self._q.values())

    def depth(self) -> int:
        with self._cv:
            return sum(len(dq) for dq in self._q.values())

    def depth_by_class(self) -> dict[str, int]:
        with self._cv:
            return {c: len(dq) for c, dq in self._q.items()}

    def oldest_age_s(self, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        with self._cv:
            heads = [dq[0].t_submit for dq in self._q.values() if dq]
        return max(0.0, now - min(heads)) if heads else 0.0
