"""Load shedding: per-class staleness budgets enforced at dispatch
(counterpart of ``evam_tpu/sched/shedder.py``).

Detections on a frame the camera took two seconds ago are wrong, not
late. Under overload the policy is freshest-frame-wins: the oldest
queued frames are dropped first and their futures fail with
``ShedError``, which the stream runner (``stages/runner.py``) counts as
one frame error, never the end of the stream. Every shed rides
``evam_sched_shed_total{class}`` and a local counter that a metrics
reset cannot clear (/healthz and /scheduler read the local counts).
Nothing is shed once it is staged: sheds happen in ``sweep`` and
``shed``, before the dispatcher copies a batch into a slot.
"""

from __future__ import annotations

import logging
import threading
import time

from evam_tpu_torch.control.state import current_op
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.sched.classes import PRIORITIES

log = logging.getLogger("evam_tpu_torch.sched.shedder")


class ShedError(RuntimeError):
    """A queued frame exceeded its class staleness budget and was
    dropped at dispatch (oldest first): overload behaviour, not an
    engine fault."""

    def __init__(self, priority: str, age_s: float, budget_s: float,
                 engine: str = ""):
        self.priority = priority
        self.age_s = age_s
        self.budget_s = budget_s
        self.engine = engine
        super().__init__(
            f"frame shed: {priority}-class item aged {age_s * 1e3:.0f}ms "
            f"> staleness budget {budget_s * 1e3:.0f}ms"
            f"{f' (engine {engine})' if engine else ''}"
        )


class Shedder:
    """Per-engine staleness enforcement over ``ClassQueues``.

    ``sweep`` runs every dispatcher cycle and sheds expired items still
    waiting in any class queue; ``shed`` filters a just-formed batch
    (items can expire during the formation wait). Both drop oldest
    first: FIFO queues age from head to tail."""

    def __init__(self, engine_name: str, staleness_s: dict[str, float]):
        self.engine_name = engine_name
        self.staleness_s = dict(staleness_s)
        self._lock = threading.Lock()
        #: per-class shed counts that survive a metrics reset
        self.counts = {c: 0 for c in PRIORITIES}

    def sweep(self, queues, now: float | None = None) -> int:
        """Shed every expired item waiting in ``queues``; returns the
        number shed."""
        now = time.perf_counter() if now is None else now
        total = 0
        scale = self._staleness_scale()
        for cls, budget in self.staleness_s.items():
            if budget <= 0:
                continue
            budget *= scale
            expired = queues.pop_expired(cls, now - budget)
            if expired:
                self._fail(cls, expired, now, budget)
                total += len(expired)
        return total

    @staticmethod
    def _staleness_scale() -> float:
        """The control plane's staleness multiplier (< 1 sheds earlier
        under sustained overload), read at use so its current value
        wins; 1.0 with EVAM_TUNE off. The controller leaves it at 1.0
        when any EVAM_SCHED_STALENESS_MS_* is set."""
        op = current_op()
        return op.staleness_scale if op is not None else 1.0

    def shed(self, priority: str, items: list,
             now: float | None = None) -> list:
        """Filter a formed batch: fail the items over budget, return the
        survivors in order."""
        budget = self.staleness_s.get(priority, 0.0)
        if budget <= 0 or not items:
            return items
        budget *= self._staleness_scale()
        now = time.perf_counter() if now is None else now
        cutoff = now - budget
        survivors = [it for it in items if it.t_submit >= cutoff]
        dropped = [it for it in items if it.t_submit < cutoff]
        if dropped:
            self._fail(priority, dropped, now, budget)
        return survivors

    def _fail(self, priority: str, items: list, now: float,
              budget: float) -> None:
        with self._lock:
            self.counts[priority] = self.counts.get(priority, 0) + len(items)
        metrics.inc("evam_sched_shed", value=float(len(items)),
                    labels={"class": priority})
        log.warning(
            "engine %s shed %d stale %s-class frame(s) "
            "(oldest %.0fms > budget %.0fms)",
            self.engine_name, len(items), priority,
            (now - items[0].t_submit) * 1e3, budget * 1e3,
        )
        for it in items:
            exc = ShedError(priority, now - it.t_submit, budget,
                            self.engine_name)
            try:
                it.future.set_exception(exc)
            except Exception:  # noqa: BLE001 — already resolved/cancelled
                pass
