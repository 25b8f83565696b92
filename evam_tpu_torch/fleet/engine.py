"""FleetEngine: one model served by N per-device shards + a mesh twin
(counterpart of ``evam_tpu/fleet/engine.py``).

The stable fleet-mode handle the hub caches per engine key
(``EVAM_FLEET=sharded``). It owns:

- ``shards``: one engine per device of the hub's device list (each a
  SupervisedEngine around a single-device BatchEngine whose ladder is
  capped at ``fleet_shard_max_batch``), serving the small buckets. A
  stream's traffic is pinned to one shard by the consistent-hash
  placer, so per-stream outputs are those of a single-device engine:
  the same step on the same device, nothing gathered.
- one lazily built MESH twin for ``batch``-class traffic: bulk frames
  want the big buckets. Torch has no pjit: on N devices the twin is a
  BatchEngine on the first device whose step (:class:`MeshStep`) splits
  a bucket's rows over one replica per device and gathers the outputs
  back; its rungs under N run on the first device alone (the
  reference's ``fleet_local`` bypass: a trickle of batch traffic does
  not pay a gather for 2 real rows).

Drain-and-rebalance: when a shard's supervisor marks it terminally
``degraded`` (restart budget exhausted — transient wedges are the
supervisor's own job), the shard is retired: its counters are absorbed
into a fleet-level carry (the supervisor's rebuild-carry discipline,
one level up — /healthz and /engines stay monotonic fleet-wide), its
streams re-place onto the survivors (``evam_fleet_rebalance_total``
counts every move), and its in-flight futures resolve with the stop
error, so the per-class stream policy decides.

Everything the hub's aggregate views touch (stats, warmed, stalled,
state, queue depths, shed counts) is a fleet-wide aggregate, so
/healthz, /engines and admission read a FleetEngine as they read one
engine — with Σ-shard capacity.

Left out until slice 10 (tracing, faults and stream state): the
reference's fault drill (``faults.current()`` injecting a shard loss
between placement and submit) and the pre-rebalance checkpoint of each
migrating stream's gate, coaster and tracker state.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import torch

from evam_tpu_torch.engine.batcher import EngineStats, stats_row
from evam_tpu_torch.fleet.placer import ConsistentHashPlacer
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.fleet.engine")

FLEET_MODES = ("sharded", "off")

#: ring points per shard (the placer's default; the reference's too)
VNODES = 512


def fleet_mode(value: str | None = None) -> str:
    """Resolve the fleet mode: explicit arg > EVAM_FLEET > off."""
    mode = value or os.environ.get("EVAM_FLEET", "off") or "off"
    if mode not in FLEET_MODES:
        raise ValueError(
            f"EVAM_FLEET must be one of {FLEET_MODES}, got {mode!r}")
    return mode


class MeshStep:
    """One step over the hub's devices, the port's stand-in for the
    reference's batch-sharded ``jax.jit``: a bucket of ``b >= N`` rows is
    split into N equal chunks (the twin's ladder is aligned to N), chunk
    ``i`` runs on the replica of device ``i``, and the outputs are
    gathered onto the first device in order. ``b < N`` (the
    ``fleet_local`` rungs) runs on the first device alone.

    Only where every device is the same one can a bucket be captured
    as one CUDA graph (``capturable``); otherwise the twin's engine runs
    it eagerly."""

    def __init__(self, steps: list, devices: list[torch.device]):
        if len(steps) != len(devices) or not steps:
            raise ValueError("MeshStep needs one step per device")
        self.steps = steps
        self.devices = [torch.device(d) for d in devices]
        self.capturable = len(set(self.devices)) == 1

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        n = len(self.steps)
        b = inputs[0].shape[0]
        if n == 1 or b < n:
            return self.steps[0](*inputs)
        if b % n:
            raise ValueError(f"mesh bucket {b} does not split over {n} "
                             "devices")
        chunks = [x.chunk(n) for x in inputs]
        outs = [step(*(c[i].to(dev, non_blocking=True) for c in chunks))
                for i, (step, dev) in enumerate(zip(self.steps,
                                                    self.devices))]
        first = self.devices[0]
        return torch.cat([o.to(first, non_blocking=True) for o in outs])


class _AllWarmed:
    """Event-shaped view: set when every member event is set."""

    def __init__(self, events):
        self._events = events

    def is_set(self) -> bool:
        return bool(self._events) and all(e.is_set() for e in self._events)


class _AnySet:
    """Event-shaped view: set when any member event is set."""

    def __init__(self, events):
        self._events = events

    def is_set(self) -> bool:
        return any(e.is_set() for e in self._events)


class FleetEngine:
    """Consistent-hash front over per-device shard engines.

    ``shard_factory(device, label)`` builds one shard engine on one
    device; ``mesh_factory(label)`` (optional) builds the twin over
    every device. Both are hub closures, so shards inherit the hub's
    supervision, scheduler, transfer and ragged configuration.
    ``devices`` is one entry per shard slot — the structural scale
    ceiling; ``initial`` (the autoscaling boot size) builds only the
    first n and leaves the rest for :meth:`scale_up`.
    """

    def __init__(self, name: str, shard_factory, devices,
                 mesh_factory=None, initial: int = 0):
        if not devices:
            raise ValueError(f"fleet engine {name}: no shard devices")
        self.name = name
        self._mesh_factory = mesh_factory
        self._mesh_eng = None
        self._mesh_lock = threading.Lock()
        #: guards the placement and carry state, hit from every
        #: submitting stream thread plus the drain threads
        self._lock = threading.RLock()
        self._slots = [torch.device(d) for d in devices]
        self._shard_factory = shard_factory
        n = len(self._slots)
        if initial > 0:
            n = max(1, min(initial, n))
        self.shards: dict[str, object] = {}
        self._devices: dict[str, str] = {}
        for i, dev in enumerate(self._slots[:n]):
            label = f"s{i}"
            self.shards[label] = shard_factory(dev, f"{name}@{label}")
            self._devices[label] = str(dev)
        self._placer = ConsistentHashPlacer(list(self.shards), VNODES)
        #: stream key → shard label (the pin makes moves observable, so
        #: they can be counted)
        self._pins: dict[str, str] = {}
        #: retired on degradation: the slot is dead, scale_up never
        #: reuses it; planned scale-downs land in _retired_planned
        self._degraded: set[str] = set()
        self._retired_planned: set[str] = set()
        self.rebalances = 0
        self.scale_ups = 0
        self.scale_downs = 0
        #: one spin-up at a time
        self._scaling = False
        #: the last scale_up's build + warm wall seconds
        self._last_spinup_s = 0.0
        #: retired-shard carry (the supervisor's discipline, fleet level)
        self._stats_carry: EngineStats | None = None
        self._shed_carry: dict[str, int] = {}
        self._restarts_carry = 0
        self._example: dict | None = None
        #: the hub warms (``warm_async`` was called): the lazily built
        #: twin is then warmed too, or the fleet would never be
        #: ``warmed`` and its buckets never captured
        self._warm = False
        self._drains: list[threading.Thread] = []

    # ------------------------------------------------------------- API

    def submit(self, priority: str = "standard", units: int | None = None,
               stream: str | None = None, **inputs):
        """Route one item: batch class → the mesh twin (big buckets),
        everything else → the stream's pinned shard."""
        self._sweep_degraded()
        if priority == "batch" and self._mesh_factory is not None:
            return self._mesh().submit(priority=priority, units=units,
                                       stream=stream, **inputs)
        label = self._place(stream or "")
        with self._lock:
            eng = self.shards.get(label)
        if eng is None:  # retired between place and lookup
            label = self._place(stream or "")
            with self._lock:
                eng = self.shards[label]
        return eng.submit(priority=priority, units=units, stream=stream,
                          **inputs)

    def placement(self, stream: str) -> str:
        """The shard label a stream is pinned to (placing it now if it
        has no pin yet)."""
        return self._place(stream)

    def _place(self, stream: str) -> str:
        with self._lock:
            cur = self._pins.get(stream)
            if cur is not None and cur in self.shards:
                return cur
            label = self._placer.place(stream)
            if cur is not None and cur != label:
                self.rebalances += 1
                metrics.inc("evam_fleet_rebalance_total",
                            labels={"engine": self.name})
            self._pins[stream] = label
            return label

    def _sweep_degraded(self) -> None:
        """Retire every live shard whose supervisor went terminal."""
        with self._lock:
            dead = [label for label, e in self.shards.items()
                    if getattr(e, "state", "running") == "degraded"]
        for label in dead:
            self._retire(label)

    def _retire(self, label: str, reason: str = "shard_loss") -> None:
        """Drain-and-rebalance one shard: absorb its counters, migrate
        its streams, fail its in-flight work via stop()."""
        with self._lock:
            eng = self.shards.pop(label, None)
            if eng is None:
                return
            if reason == "scale_down":
                # planned shrink: the device is healthy, the slot is
                # reusable by a later scale_up
                self._retired_planned.add(label)
            else:
                self._degraded.add(label)
            self._placer.mark_down(label)
            # carry before the engine goes away: the fleet view stays
            # monotonic though the shard's rows vanish
            try:
                carry = self._stats_carry or EngineStats()
                carry.absorb(eng.stats)
                self._stats_carry = carry
                for k, v in eng.shed_counts().items():
                    self._shed_carry[k] = self._shed_carry.get(k, 0) + v
                self._restarts_carry += getattr(eng, "restarts", 0)
            except Exception:  # noqa: BLE001 — shard mid-teardown
                pass
            moved = [s for s, cur in self._pins.items() if cur == label]
            for s in moved:
                self._pins[s] = self._placer.place(s)
                self.rebalances += 1
                metrics.inc("evam_fleet_rebalance_total",
                            labels={"engine": self.name})
        log.warning(
            "fleet %s: shard %s %s — retired, %d stream(s) migrated (%d "
            "moves total)", self.name, label,
            "scaled down" if reason == "scale_down" else "degraded",
            len(moved), self.rebalances)
        # stop() fails the shard's queued and in-flight futures; joined
        # off-thread, so a placement move never stalls the stream
        t = threading.Thread(target=self._safe_stop, args=(eng,),
                             name=f"fleet-{self.name}-drain-{label}",
                             daemon=True)
        t.start()
        with self._lock:
            self._drains.append(t)

    def scale_down(self, label: str | None = None) -> str | None:
        """Retire one live shard (the highest-numbered by default),
        migrating its streams. Refuses to retire the last shard.
        Returns the retired label (None: nothing done)."""
        with self._lock:
            live = sorted(self.shards)
            if len(live) <= 1:
                return None
            if label is None:
                label = live[-1]
            elif label not in self.shards:
                return None
        self._retire(label, reason="scale_down")
        with self._lock:
            self.scale_downs += 1
        return label

    def scale_up(self, warm_timeout_s: float = 120.0) -> str | None:
        """Grow the fleet by one shard (the eighth control law's up
        action). The shard is built from the factory and **warmed before
        it joins placement** (on the card: every bucket captured): no
        stream is ever pinned to a cold shard. Once warm the label
        enters the shard map and the ring; the streams whose arcs its
        vnodes own are re-pinned, each move counted.

        Returns the new label, or None (at capacity, already scaling, or
        the warm gate timed out — the half-built shard is stopped and
        nothing joined the ring)."""
        with self._lock:
            if self._scaling:
                return None
            free = [i for i in range(len(self._slots))
                    if f"s{i}" not in self.shards
                    and f"s{i}" not in self._degraded]
            if not free:
                return None
            idx = free[0]
            label = f"s{idx}"
            self._scaling = True
            example = self._example
        t0 = time.perf_counter()
        try:
            try:
                eng = self._shard_factory(self._slots[idx],
                                          f"{self.name}@{label}")
            except Exception:  # noqa: BLE001 — a failed build is a no-op grow
                log.exception("fleet %s: scale_up build of %s failed",
                              self.name, label)
                return None
            if example:
                # the warm-before-join gate (skipped while the fleet has
                # seen no example, as at boot)
                eng.warm_async(**example)
                deadline = time.monotonic() + warm_timeout_s
                while not eng.warmed.wait(0.05):
                    if time.monotonic() >= deadline:
                        log.warning(
                            "fleet %s: scale_up of %s abandoned — warmup "
                            "exceeded %.0fs; the shard never joined the "
                            "ring", self.name, label, warm_timeout_s)
                        threading.Thread(
                            target=self._safe_stop, args=(eng,),
                            name=f"fleet-{self.name}-abort-{label}",
                            daemon=True).start()
                        return None
            # join: the shard map first, the ring second — a submit that
            # places onto the new label must find its engine
            with self._lock:
                self.shards[label] = eng
                self._devices[label] = str(self._slots[idx])
                self._retired_planned.discard(label)
                self._placer.add(label)
                self.scale_ups += 1
                self._last_spinup_s = time.perf_counter() - t0
                moved = 0
                for s, cur in list(self._pins.items()):
                    if cur != label and self._placer.place(s) == label:
                        self._pins[s] = label
                        self.rebalances += 1
                        moved += 1
                        metrics.inc("evam_fleet_rebalance_total",
                                    labels={"engine": self.name})
                spinup = self._last_spinup_s
            log.info("fleet %s: scaled up — shard %s joined warm in %.2fs, "
                     "%d stream(s) rebalanced onto it", self.name, label,
                     spinup, moved)
            return label
        finally:
            with self._lock:
                self._scaling = False

    @staticmethod
    def _safe_stop(eng) -> None:
        try:
            eng.stop()
        except Exception:  # noqa: BLE001 — already torn down
            pass

    def drain_wait(self, timeout: float = 10.0) -> None:
        """Join outstanding retirement drains (tests, shutdown)."""
        with self._lock:
            drains = list(self._drains)
        for t in drains:
            t.join(timeout=timeout)

    def _mesh(self):
        with self._mesh_lock:
            if self._mesh_eng is None:
                self._mesh_eng = self._mesh_factory(f"{self.name}@mesh")
                with self._lock:
                    example, warm = self._example, self._warm
                if example and warm:
                    self._mesh_eng.warm_async(**example)
                elif example:
                    self._mesh_eng.set_example(**example)
            return self._mesh_eng

    # -------------------------------------------------- engine surface

    def _members(self) -> list:
        with self._lock:
            members = list(self.shards.values())
        if self._mesh_eng is not None:
            members.append(self._mesh_eng)
        return members

    @property
    def stats(self) -> EngineStats:
        merged = EngineStats()
        with self._lock:
            if self._stats_carry is not None:
                merged.absorb(self._stats_carry)
        for e in self._members():
            merged.absorb(e.stats)
        return merged

    def stats_row(self) -> dict:
        """The fleet as one /engines row (the hub's aggregates read it;
        /engines itself shows one row per shard, ``shard_rows``)."""
        return stats_row(self, self.stats)

    def graphs_captured(self) -> int:
        return sum(e.graphs_captured() for e in self._members())

    @property
    def warmed(self) -> _AllWarmed:
        return _AllWarmed([e.warmed for e in self._members()])

    @property
    def stalled(self) -> _AnySet:
        return _AnySet([e.stalled for e in self._members()
                        if getattr(e, "state", "running") == "running"])

    @property
    def state(self) -> str:
        states = [getattr(e, "state", "running") for e in self._members()]
        if any(s == "running" for s in states):
            # one live device keeps the process serving: a single loss
            # must not flip /healthz to 503 while survivors carry it
            return "running"
        if any(s == "restarting" for s in states):
            return "restarting"
        return "degraded"

    @property
    def restarts(self) -> int:
        with self._lock:
            carry = self._restarts_carry
        return carry + sum(getattr(e, "restarts", 0)
                           for e in self._members())

    @property
    def last_stall_ts(self):
        ts = [getattr(e, "last_stall_ts", None) for e in self._members()]
        ts = [t for t in ts if t]
        return max(ts) if ts else None

    def queue_depth(self) -> int:
        return sum(e.queue_depth() for e in self._members())

    def queue_age_s(self) -> float:
        ages = [e.queue_age_s() for e in self._members()]
        return max(ages) if ages else 0.0

    def class_depths(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self._members():
            for k, v in e.class_depths().items():
                out[k] = out.get(k, 0) + v
        return out

    def shed_counts(self) -> dict[str, int]:
        with self._lock:
            out = dict(self._shed_carry)
        for e in self._members():
            for k, v in e.shed_counts().items():
                out[k] = out.get(k, 0) + v
        return out

    def set_example(self, **example) -> None:
        with self._lock:
            self._example = example
        for e in self._members():
            e.set_example(**example)

    def warm_async(self, **example) -> None:
        with self._lock:
            self._example = example
            self._warm = True
        for e in self._members():
            e.warm_async(**example)

    def retune(self, op) -> None:
        """Broadcast the controller's operating point to every shard and
        the twin, and actuate the eighth law: ``op.fleet_shards`` > 0 is
        the controller's (damped, cooled-down) target fleet size, and
        each retune moves ONE step toward it — grow on a background
        thread (warm-before-join takes seconds; the controller's tick
        must not block), shrink inline through :meth:`scale_down`. 0
        (the knob's rest state) actuates nothing."""
        for e in self._members():
            try:
                e.retune(op)
            except Exception:  # noqa: BLE001 — shard mid-teardown
                pass
        target = int(getattr(op, "fleet_shards", 0) or 0)
        if target <= 0:
            return
        with self._lock:
            live = len(self.shards)
            scaling = self._scaling
        if target > live and not scaling:
            threading.Thread(target=self._scale_up_guarded,
                             name=f"fleet-{self.name}-scale-up",
                             daemon=True).start()
        elif target < live and live > 1:
            self.scale_down()

    def _scale_up_guarded(self) -> None:
        try:
            self.scale_up()
        except Exception:  # noqa: BLE001 — a failed grow must not kill the thread
            log.exception("fleet %s: scale_up failed", self.name)

    def abandon(self) -> None:
        for e in self._members():
            try:
                e.abandon()
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass

    def stop(self) -> None:
        for e in self._members():
            self._safe_stop(e)
        self.drain_wait()

    def __getattr__(self, item):
        # structural attributes (buckets, assembly, ragged, step_fn, ...)
        # are the same on every shard by construction: answer from the
        # first one
        if item.startswith("__"):
            raise AttributeError(item)
        with self._lock:
            for e in self.shards.values():
                return getattr(e, item)
        raise AttributeError(item)

    # ------------------------------------------------- fleet introspection

    def shard_rows(self) -> list[tuple[str, str, object]]:
        """(label, device, engine) per live shard and the mesh twin —
        the /engines rows of the fleet."""
        with self._lock:
            rows = [(label, self._devices[label], eng)
                    for label, eng in self.shards.items()]
        if self._mesh_eng is not None:
            rows.append(("mesh", "mesh", self._mesh_eng))
        return rows

    def placement_counts(self) -> dict[str, int]:
        """Streams pinned per shard label."""
        with self._lock:
            out = {label: 0 for label in self.shards}
            for label in self._pins.values():
                if label in out:
                    out[label] += 1
            return out

    def fleet_summary(self) -> dict:
        self._sweep_degraded()
        with self._lock:
            return {
                "shards": len(self.shards),
                "degraded_shards": len(self._degraded),
                "streams": self.placement_counts(),
                "rebalances": self.rebalances,
                # the structural ceiling (the device list less dead
                # devices; the hub clamps it to EVAM_FLEET_MAX_SHARDS)
                "max_shards": len(self._slots) - len(self._degraded),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
            }
