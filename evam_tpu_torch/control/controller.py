"""The feedback controller: signals in, operating point out
(counterpart of ``evam_tpu/control/controller.py``).

Runs on its own cadence (``EVAM_TUNE_INTERVAL_S``), reads the signals
the engines already measure — the stage clock, queue depth and age,
per-bucket dispatch counts, the gates' skip rate, admission's
utilization and live capacity, the per-class shed counts — and retunes
through :mod:`control.state`:

- **deadline_scale** stretches batch-formation deadlines as utilization
  climbs, shrinks them with headroom, decays to 1.0 in the dead band;
- **batch_cap** follows the bucket the demand mix fills (p95 of the
  per-bucket dispatch counts, 2× headroom), uncapped under queue
  pressure;
- **transfer_depth** deepens the upload queue when the launcher waits
  on the upload (``h2d_wait``/``launch``), shallows it back after;
- **gate_scale** tightens the motion-gate thresholds under pressure;
- **admit_util / capacity_fps** lower the admission ceiling on sheds
  and restore it with headroom; capacity is re-derived every tick as an
  EWMA;
- **staleness_scale** tightens the staleness budgets under sustained
  overload;
- **fleet_shards** (the eighth law): utilization sustained at or above
  ``scale_up_util`` grows the fleet by one warm shard, at or below
  ``scale_down_util`` drains one (``FleetEngine.retune`` actuates one
  step per push). Inert while the hub's ``fleet_summary`` reports
  ``max_shards`` 0: the fleet off, or EVAM_FLEET_MAX_SHARDS unset.

Anti-flap: a law must agree in direction for ``damping`` consecutive
ticks before its action applies, and an applied knob sits out a
``cooldown`` (capacity_fps excepted). Knobs the operator set (their
field in ``Settings``'s ``fields_set``) stay neutral. Decisions show as
``evam_tune_*`` metrics and in the /scheduler action log.
"""

from __future__ import annotations

import logging
import threading
import time

from evam_tpu_torch.config.settings import Settings, get_settings
from evam_tpu_torch.control.state import OperatingPoint, TuneState, ZERO_SIGNALS
from evam_tpu_torch.obs import trace
from evam_tpu_torch.obs.metrics import metrics

log = logging.getLogger("evam_tpu_torch.control.controller")

#: law bounds
DEADLINE_SCALE_MAX = 2.0
DEADLINE_SCALE_MIN = 0.5
DEADLINE_STEP = 0.25
GATE_SCALE_MAX = 3.0
GATE_STEP = 0.5
TRANSFER_DEPTH_MAX = 8
ADMIT_STEP = 0.05
ADMIT_UTIL_MIN = 0.5
STALENESS_FACTOR = 0.75
STALENESS_SCALE_MIN = 0.25
CAPACITY_EWMA = 0.3
#: deepen when the launcher waits on the upload more than this share of
#: launch time; shallow when it waits less than a tenth of that
H2D_DEEPEN_RATIO = 0.25
H2D_SHALLOW_RATIO = 0.025


class TuneController:
    """Feedback loop binding a hub (and an admission controller) to the
    process TuneState. Only the controller thread touches its
    internals."""

    KNOBS = ("deadline_scale", "batch_cap", "transfer_depth",
             "gate_scale", "admit_util", "capacity_fps",
             "staleness_scale", "fleet_shards")

    def __init__(self, hub, state: TuneState, admission=None,
                 settings: Settings | None = None) -> None:
        self.hub = hub
        self.state = state
        self.admission = admission
        self.cfg = state.cfg
        s = settings or get_settings()
        tset = s.engine.fields_set
        sset = s.sched.fields_set
        #: knobs the operator pinned: the laws never move them
        self.pins = {
            "deadline_scale": bool({"batch_deadline_ms"} & tset) or bool(
                {"deadline_ms_realtime", "deadline_ms_standard",
                 "deadline_ms_batch"} & sset),
            "batch_cap": "max_batch" in tset,
            "transfer_depth": "transfer_depth" in tset,
            # per-gate pins are resolved in GateConfig.from_properties
            "gate_scale": False,
            "admit_util": "admit_util" in sset,
            "capacity_fps": "capacity_fps" in sset,
            "staleness_scale": bool(
                {"staleness_ms_realtime", "staleness_ms_standard",
                 "staleness_ms_batch"} & sset),
            "fleet_shards": False,
        }
        self.static_transfer_depth = max(1, int(s.engine.transfer_depth))
        self.static_admit_util = float(s.sched.admit_util)
        self.max_batch = max(1, int(s.engine.max_batch))
        self._ticks = 0
        #: per-knob (direction, consecutive agreeing ticks)
        self._streak: dict[str, tuple[int, int]] = {}
        #: per-knob cooldown ticks left after an applied action
        self._cool: dict[str, int] = {}
        #: last-seen cumulative counters of the delta signals
        self._last_shed = 0.0
        self._last_buckets: dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="tune-controller", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        interval = max(0.05, float(self.cfg.interval_s))
        while not self._stop.wait(interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the loop must keep ticking
                log.exception("tune tick failed")

    # -- signals --------------------------------------------------------

    def signals(self) -> dict:
        """One reading of every input the laws use (the keys of
        ZERO_SIGNALS). Each engine's row is a snapshot taken under that
        engine's lock (``stats_row``)."""
        sig = dict(ZERO_SIGNALS)
        rows: list[dict] = []
        try:
            rows = list(self.hub.stats().values())
        except Exception:  # noqa: BLE001 — a tick without rows reads zeros
            log.exception("hub stats unavailable")
        h2d, launch, weight = 0.0, 0.0, 0.0
        depth, age = 0.0, 0.0
        buckets: dict[str, float] = {}
        for row in rows:
            batches = float(row.get("batches") or 0.0)
            stage = row.get("stage_ms") or {}
            if batches > 0:
                h2d += float(stage.get("h2d_wait") or 0.0) * batches
                launch += float(stage.get("launch") or 0.0) * batches
                weight += batches
            depth += float(row.get("queue_depth") or 0.0)
            age = max(age, float(row.get("queue_age_s") or 0.0))
            for b, n in (row.get("bucket_batches") or {}).items():
                buckets[b] = buckets.get(b, 0.0) + float(n)
        if weight > 0:
            sig["h2d_wait_ms"] = h2d / weight
            sig["launch_ms"] = launch / weight
        sig["queue_depth"] = depth
        sig["oldest_age_s"] = age
        sig["batch_p95"] = self._demand_p95(buckets)
        shed = 0.0
        try:
            shed = float(sum(self.hub.shed_totals().values()))
        except Exception:  # noqa: BLE001 — a hub without shed counts
            pass
        sig["shed_delta"] = max(0.0, shed - self._last_shed)
        self._last_shed = shed
        from evam_tpu_torch.stages.gate import registry as gate_registry

        sig["skip_fps"] = float(gate_registry.skipped_fps())
        if self.admission is not None:
            sig["utilization"] = float(self.admission.utilization())
            sig["capacity_fps"] = float(
                self.admission.capacity_fps(live=True))
            sig["demand_fps"] = float(
                self.admission.effective_demand_fps())
        # the fleet law's inputs (zeros with the fleet off)
        fleet_fn = getattr(self.hub, "fleet_summary", None)
        if fleet_fn is not None:
            fs = fleet_fn()
            sig["fleet_shards"] = float(fs.get("shards", 0))
            sig["fleet_max_shards"] = float(fs.get("max_shards", 0))
        return sig

    def _demand_p95(self, buckets: dict[str, float]) -> float:
        """p95 dispatched bucket size over the last tick (deltas of the
        cumulative per-bucket dispatch counts)."""
        deltas: list[tuple[int, float]] = []
        for b, n in buckets.items():
            d = n - self._last_buckets.get(b, 0.0)
            if d > 0:
                try:
                    deltas.append((int(b), d))
                except ValueError:
                    continue
        self._last_buckets = buckets
        if not deltas:
            return 0.0
        deltas.sort()
        total = sum(d for _, d in deltas)
        acc = 0.0
        for size, d in deltas:
            acc += d
            if acc >= 0.95 * total:
                return float(size)
        return float(deltas[-1][0])

    # -- the loop -------------------------------------------------------

    def tick(self) -> dict:
        """One iteration: read the signals, run every law through the
        damping, cooldown and pin clamps, publish the new operating
        point and push it to the hub (the tick is a ``control.tick``
        span on a ``control`` trace). Returns the signals read."""
        t0 = time.perf_counter()
        self._ticks += 1
        sig = self.signals()
        old = self.state.op
        fields = old.to_dict()
        applied: list[str] = []
        for knob, value, reason in self._propose(sig, old):
            if self.pins.get(knob):
                continue
            if knob == "capacity_fps":  # per-tick EWMA, undamped
                fields[knob] = value
                continue
            if self._cool.get(knob, 0) > 0:
                continue
            cur = fields[knob]
            direction = 1 if value > cur else -1
            last_dir, count = self._streak.get(knob, (0, 0))
            count = count + 1 if direction == last_dir else 1
            self._streak[knob] = (direction, count)
            if count < max(1, int(self.cfg.damping)):
                continue
            fields[knob] = value
            self._streak[knob] = (0, 0)
            self._cool[knob] = max(0, int(self.cfg.cooldown))
            applied.append(knob)
            self.state.record({
                "tick": self._ticks, "knob": knob,
                "from": round(float(cur), 4),
                "to": round(float(value), 4), "reason": reason,
            })
            metrics.inc("evam_tune_actions", labels={"knob": knob})
        for knob in list(self._cool):
            if knob not in applied and self._cool[knob] > 0:
                self._cool[knob] -= 1
        op = OperatingPoint(**fields)
        self.state.install(op, sig)
        metrics.inc("evam_tune_ticks")
        for knob, value in fields.items():
            metrics.set("evam_tune_setpoint", float(value),
                        {"knob": knob})
        try:
            self.hub.retune(op)
        except Exception:  # noqa: BLE001 — the next tick pushes again
            log.exception("hub retune failed")
        ft = trace.start_frame("control", self._ticks, "standard")
        if ft is not None:
            ft.add_span("control.tick", t0, time.perf_counter() - t0,
                        attrs={"applied": ",".join(applied) or "none",
                               "utilization": round(sig["utilization"], 4)})
            trace.finish_frame(ft, "ok")
        return sig

    def _propose(self, sig: dict, old: OperatingPoint) -> list[tuple]:
        """Every law's raw proposal for this tick, (knob, value,
        reason); damping, cooldown and pins apply downstream."""
        out: list[tuple] = []
        util = sig["utilization"]
        hi, lo = float(self.cfg.util_hi), float(self.cfg.util_lo)

        # deadline_scale: pressure stretches batch formation, headroom
        # shrinks it, the dead band decays toward neutral
        cur = old.deadline_scale
        if util >= hi and cur < DEADLINE_SCALE_MAX:
            out.append(("deadline_scale",
                        round(min(DEADLINE_SCALE_MAX,
                                  cur + DEADLINE_STEP), 4),
                        f"utilization {util:.2f} >= {hi:.2f}: stretch "
                        f"deadlines for fuller buckets"))
        elif util <= lo and cur > DEADLINE_SCALE_MIN:
            out.append(("deadline_scale",
                        round(max(DEADLINE_SCALE_MIN,
                                  cur - DEADLINE_STEP), 4),
                        f"utilization {util:.2f} <= {lo:.2f}: shrink "
                        f"deadlines for latency"))
        elif lo < util < hi and cur != 1.0:
            step = DEADLINE_STEP if cur < 1.0 else -DEADLINE_STEP
            nxt = round(cur + step, 4)
            if (cur < 1.0) != (nxt < 1.0):
                nxt = 1.0
            out.append(("deadline_scale", nxt,
                        "dead band: decay toward neutral"))

        # batch_cap: follow the observed demand mix; uncap on pressure
        p95 = sig["batch_p95"]
        if sig["queue_depth"] > self.max_batch and old.batch_cap:
            out.append(("batch_cap", 0,
                        "queue pressure: uncap batch formation"))
        elif p95 > 0 and p95 * 4 <= self.max_batch:
            cap = max(8, int(p95) * 2)
            if cap != old.batch_cap and cap < self.max_batch:
                out.append(("batch_cap", cap,
                            f"demand mix p95 bucket {int(p95)}: cap "
                            f"formation at {cap}"))
        elif p95 * 4 > self.max_batch and old.batch_cap:
            out.append(("batch_cap", 0,
                        f"demand mix p95 bucket {int(p95)}: uncap"))

        # transfer_depth: the launcher waiting on the upload => deepen
        launch_ms = sig["launch_ms"]
        h2d_ms = sig["h2d_wait_ms"]
        cur_depth = old.transfer_depth or self.static_transfer_depth
        if launch_ms > 0 and h2d_ms > H2D_DEEPEN_RATIO * launch_ms \
                and cur_depth < TRANSFER_DEPTH_MAX:
            out.append(("transfer_depth", cur_depth + 1,
                        f"h2d_wait {h2d_ms:.2f}ms vs launch "
                        f"{launch_ms:.2f}ms: deepen upload queue"))
        elif launch_ms > 0 and h2d_ms < H2D_SHALLOW_RATIO * launch_ms \
                and cur_depth > self.static_transfer_depth:
            out.append(("transfer_depth", cur_depth - 1,
                        "upload queue running ahead: shallow toward "
                        "static depth"))

        # gate_scale: gate harder under pressure; relax only when the
        # demand the skips hide would still fit under util_hi
        cur = old.gate_scale
        if util >= hi and cur < GATE_SCALE_MAX:
            out.append(("gate_scale",
                        round(min(GATE_SCALE_MAX, cur + GATE_STEP), 4),
                        f"utilization {util:.2f} >= {hi:.2f}: tighten "
                        f"gate thresholds"))
        elif util <= lo and cur > 1.0:
            cap = sig["capacity_fps"] or old.capacity_fps
            projected = util + (sig["skip_fps"] / cap if cap > 0 else 0.0)
            if projected <= hi:
                out.append(("gate_scale",
                            round(max(1.0, cur - GATE_STEP), 4),
                            f"headroom even with skipped demand back "
                            f"(projected {projected:.2f}): relax gate"))

        # admit_util: sheds lower the ceiling, headroom restores it
        cur_util = old.admit_util or self.static_admit_util
        if sig["shed_delta"] > 0 and cur_util > ADMIT_UTIL_MIN:
            out.append(("admit_util",
                        round(max(ADMIT_UTIL_MIN,
                                  cur_util - ADMIT_STEP), 4),
                        f"shed {sig['shed_delta']:.0f} frames last "
                        f"tick: lower admission ceiling"))
        elif sig["shed_delta"] == 0 and util <= lo \
                and 0 < old.admit_util < self.static_admit_util:
            out.append(("admit_util",
                        round(min(self.static_admit_util,
                                  cur_util + ADMIT_STEP), 4),
                        "headroom, no sheds: restore admission "
                        "ceiling"))

        # capacity_fps: per-tick EWMA of the live capacity
        live = sig["capacity_fps"]
        if live > 0:
            prev = old.capacity_fps or live
            ewma = CAPACITY_EWMA * live + (1 - CAPACITY_EWMA) * prev
            out.append(("capacity_fps", round(ewma, 2),
                        "per-tick capacity re-derivation (EWMA)"))

        # staleness_scale: sustained overload sheds earlier
        cur = old.staleness_scale
        if util >= hi and sig["shed_delta"] > 0 \
                and cur > STALENESS_SCALE_MIN:
            out.append(("staleness_scale",
                        round(max(STALENESS_SCALE_MIN,
                                  cur * STALENESS_FACTOR), 4),
                        "sustained overload: tighten staleness "
                        "budgets"))
        elif util <= lo and cur < 1.0:
            out.append(("staleness_scale",
                        round(min(1.0, cur / STALENESS_FACTOR), 4),
                        "headroom: relax staleness budgets"))

        # fleet_shards (the eighth law): sustained saturation grows the
        # fleet by a warm shard, sustained idleness drains one. The
        # thresholds sit outside the util_hi/util_lo band: the in-shard
        # laws absorb pressure before the fleet takes a device.
        # max_shards 0 (EVAM_FLEET_MAX_SHARDS unset, or the fleet off)
        # keeps the law inert.
        maxs = int(sig["fleet_max_shards"])
        live_shards = int(sig["fleet_shards"])
        if maxs > 0 and live_shards > 0:
            up = float(self.cfg.scale_up_util)
            down = float(self.cfg.scale_down_util)
            if util >= up and live_shards < maxs:
                out.append(("fleet_shards", live_shards + 1,
                            f"utilization {util:.2f} >= {up:.2f} "
                            f"sustained: warm shard "
                            f"{live_shards + 1}/{maxs} before it "
                            f"joins"))
            elif util <= down and live_shards > 1:
                out.append(("fleet_shards", live_shards - 1,
                            f"utilization {util:.2f} <= {down:.2f} "
                            f"sustained: drain one shard, its "
                            f"streams re-placed without a "
                            f"checkpoint"))
            elif old.fleet_shards and old.fleet_shards != live_shards \
                    and down < util < up:
                out.append(("fleet_shards", live_shards,
                            "fleet at rest: track live shard count"))
        return out
