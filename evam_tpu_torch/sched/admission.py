"""Admission control: reject over-capacity starts at the REST edge
(counterpart of ``evam_tpu/sched/admission.py``).

An edge box has a knowable frame budget; the answer to a start beyond
it is an immediate 503 with ``Retry-After``, not an oversubscription
that degrades the streams already admitted. The capacity model reads
the engines' stage clock:

    capacity_fps = min over engines of
        (1 / per-batch service seconds: h2d_issue + h2d_wait + launch
         + readback) × items per batch

i.e. what the slowest shared engine delivers at the measured batch
fill. ``EVAM_SCHED_CAPACITY_FPS`` pins it instead. Demand is the sum of
the admitted streams' declared fps (request ``fps``, default
``EVAM_SCHED_DEFAULT_FPS``) less the motion gates' skipped frames/s. A
start is rejected when the projected utilization exceeds the class
ceiling — ``EVAM_SCHED_ADMIT_UTIL`` × ``CLASS_HEADROOM`` — so ``batch``
is turned away first and ``realtime`` last. A hub that has run no batch
and declares no capacity admits everything.

On the card, ``launch`` under CUDA graphs is the replay's issue time
plus the waits for the interpreter lock, not the device's time; the
formula is the reference's as it stands.
"""

from __future__ import annotations

import logging
import math
import threading
import uuid

from evam_tpu_torch.control.state import current_op
from evam_tpu_torch.obs.metrics import metrics
from evam_tpu_torch.sched.classes import PRIORITIES, SchedConfig

log = logging.getLogger("evam_tpu_torch.sched.admission")

#: fraction of admit_util each class may fill: batch hits its ceiling
#: first, realtime last
CLASS_HEADROOM = {"realtime": 1.0, "standard": 0.85, "batch": 0.6}

#: the device-path stages of the per-batch clock (``engine/ringbuf.py``
#: ``STAGES``) that bound one batch's serial service time
_SERVICE_STAGES = ("h2d_issue", "h2d_wait", "launch", "readback")


class AdmissionError(RuntimeError):
    """Start rejected for capacity: HTTP 503 with Retry-After."""

    def __init__(self, priority: str, util: float, ceiling: float,
                 retry_after_s: float):
        self.priority = priority
        self.util = util
        self.ceiling = ceiling
        self.retry_after_s = retry_after_s
        super().__init__(
            f"admission rejected: projected utilization {util:.2f} "
            f"exceeds the {priority}-class ceiling {ceiling:.2f}; "
            f"retry after {retry_after_s:.0f}s"
        )


class _Ticket:
    """One admitted stream's capacity reservation; ``release`` is
    idempotent (the instance's end and a failed start both call it)."""

    __slots__ = ("_ctrl", "key", "priority", "fps", "_released")

    def __init__(self, ctrl: "AdmissionController", key: str,
                 priority: str, fps: float):
        self._ctrl = ctrl
        self.key = key
        self.priority = priority
        self.fps = fps
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._ctrl._release(self.key)


class AdmissionController:
    """Admitted demand against modeled capacity for one hub.

    Needs only ``hub.stats()`` (per-engine rows with batches, items,
    mean_occupancy and stage_ms) and ``hub.max_batch``. Disabled
    (``cfg.enabled`` false or ``admit_util`` ≤ 0) it admits everything
    but still counts admissions per class for /scheduler and /healthz.
    """

    def __init__(self, hub, cfg: SchedConfig):
        self.hub = hub
        self.cfg = cfg
        self._lock = threading.Lock()
        #: ticket key -> (priority, fps)
        self._streams: dict[str, tuple[str, float]] = {}
        #: counters a metrics reset cannot clear
        self._admitted = {c: 0 for c in PRIORITIES}
        self._rejected = {c: 0 for c in PRIORITIES}

    # ------------------------------------------------------------- API

    def admit(self, priority: str, fps: float) -> _Ticket:
        """Reserve capacity for one stream or raise AdmissionError."""
        enforcing = self.cfg.enabled and self.cfg.admit_util > 0
        if enforcing:
            cap = self.capacity_fps()
            if cap > 0:
                util = (self.effective_demand_fps() + fps) / cap
                ceiling = self.admit_util() * CLASS_HEADROOM.get(
                    priority, 1.0)
                if util > ceiling:
                    retry_after = self._retry_after_s(util, ceiling)
                    with self._lock:
                        self._rejected[priority] += 1
                    metrics.inc("evam_sched_rejected",
                                labels={"class": priority})
                    log.warning(
                        "rejected %s-class start (%.0f fps): projected "
                        "util %.2f > ceiling %.2f (capacity %.0f fps, "
                        "post-gate demand %.0f fps)", priority, fps, util,
                        ceiling, cap, self.effective_demand_fps(),
                    )
                    raise AdmissionError(priority, util, ceiling,
                                         retry_after)
        key = uuid.uuid4().hex
        with self._lock:
            self._streams[key] = (priority, fps)
            self._admitted[priority] += 1
        metrics.inc("evam_sched_admitted", labels={"class": priority})
        return _Ticket(self, key, priority, fps)

    def _release(self, key: str) -> None:
        with self._lock:
            self._streams.pop(key, None)

    # -------------------------------------------------- capacity model

    def demand_fps(self) -> float:
        with self._lock:
            return sum(fps for _, fps in self._streams.values())

    def admit_util(self) -> float:
        """The live ceiling: the controller's override where it has
        stepped off EVAM_SCHED_ADMIT_UTIL, else the configured value."""
        op = current_op()
        if op is not None and op.admit_util > 0:
            return op.admit_util
        return self.cfg.admit_util

    def effective_demand_fps(self) -> float:
        """Declared demand less the motion gates' recent skipped
        frames/s: frames a gate does not submit use no engine."""
        from evam_tpu_torch.stages.gate import registry as gate_registry

        return max(0.0, self.demand_fps() - gate_registry.skipped_fps())

    def capacity_fps(self, live: bool = False) -> float:
        """Declared capacity, the controller's published EWMA, or the
        bottleneck projection from the engines' stats; 0 = unknown (a
        cold hub admits). ``live`` skips the controller's setpoint (the
        controller itself reads this form). Each row derives its own
        capacity from its own stage clock and batch fill; rows are
        summed within their ``group`` (the shards of one fleet engine
        are parallel capacity, Σ shards) and the minimum across groups
        is the capacity (a pipeline is bounded by its slowest engine
        kind). A single engine is its own group."""
        if self.cfg.capacity_fps > 0:
            return self.cfg.capacity_fps
        if not live:
            op = current_op()
            if op is not None and op.capacity_fps > 0:
                return op.capacity_fps
        group_caps: dict[str, float] = {}
        for key, stats in self.hub.stats().items():
            batches = stats.get("batches")
            if not batches:
                continue
            stage_ms = stats.get("stage_ms") or {}
            service_ms = sum(stage_ms.get(s, 0.0) for s in _SERVICE_STAGES)
            if service_ms <= 0:
                continue
            # real items per dispatched batch; rows without an item
            # count keep the occupancy × top-bucket projection
            items = stats.get("items")
            if items:
                per_batch = items / batches
            else:
                occ = max(float(stats.get("mean_occupancy", 0.0)), 1e-3)
                per_batch = occ * self.hub.max_batch
            group = stats.get("group") or key
            group_caps[group] = (group_caps.get(group, 0.0)
                                 + (1e3 / service_ms) * per_batch)
        return min(group_caps.values()) if group_caps else 0.0

    def utilization(self) -> float:
        cap = self.capacity_fps()
        return self.effective_demand_fps() / cap if cap > 0 else 0.0

    @staticmethod
    def _retry_after_s(util: float, ceiling: float) -> float:
        """Back off in proportion to how far past the ceiling the
        projection landed, bounded to [1, 30] s."""
        over = util / max(ceiling, 1e-6)
        return float(min(30, max(1, math.ceil(2.0 * over))))

    # ------------------------------------------------- introspection

    def counts(self) -> dict[str, dict[str, int]]:
        with self._lock:
            return {
                "admitted": dict(self._admitted),
                "rejected": dict(self._rejected),
            }

    def streams_by_class(self) -> dict[str, int]:
        out = {c: 0 for c in PRIORITIES}
        with self._lock:
            for prio, _ in self._streams.values():
                out[prio] = out.get(prio, 0) + 1
        return out

    def snapshot(self) -> dict:
        """The /scheduler payload's core (fixed keys: the route
        golden)."""
        counts = self.counts()
        return {
            "enabled": bool(self.cfg.enabled),
            "admit_util": self.admit_util(),
            "capacity_fps": round(self.capacity_fps(), 1),
            "demand_fps": round(self.demand_fps(), 1),
            "effective_demand_fps": round(self.effective_demand_fps(), 1),
            "utilization": round(self.utilization(), 3),
            "streams": self.streams_by_class(),
            "admitted": counts["admitted"],
            "rejected": counts["rejected"],
            "deadline_ms": dict(self.cfg.deadline_ms),
            "staleness_ms": dict(self.cfg.staleness_ms),
        }
