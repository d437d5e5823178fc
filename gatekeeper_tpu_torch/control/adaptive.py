"""Closed-loop adaptive serving controller + degradation ladder.

Every serving knob PAPER.md's control plane exposes — micro-batch
`max_wait`/`max_batch`, the shed depth, engine fan-out, AOT pre-warm —
was a hand-tuned constant: the plane's gauges made saturation legible
(seal reasons, fill ratios, queue depths, duty cycle, burn rates) and a
scrape of them proved the plane edge-bound, but a human still read the
scrape and picked the numbers. This module closes the loop.

`AdaptiveController` is one daemon thread that, each `interval`
seconds, samples the EXISTING signals — `SloEngine` burn rates,
batch seal-reason mix + mean fill ratio (registry counter/histogram
deltas), queue depth, per-engine duty cycle, backplane inflight —
and actuates a small set of DECLARED knobs:

  * `batch_max_wait` / `batch_max_batch` — from the seal-reason mix:
    a window dominated by max_wait seals at near-zero fill is a
    trickle paying the full collection wait for nothing (shrink the
    wait); a window dominated by full seals is engine-bound (grow the
    batch). A quiet or mixed window relaxes both back toward the
    configured baseline.
  * `shed_depth` — the availability burn rate crossing the SRE
    fast/slow alert bounds (14.4x over 5m / 6x over 1h) tightens the
    bounded queue so overload is answered at the edge instead of
    queueing into certain timeout; burn under 1.0 on both windows
    relaxes it back toward baseline.
  * `engine_fanout` — duty cycle vs inflight attribution: sustained
    high duty is engine-bound (unpark an engine, up to the configured
    fleet); idle duty with an idle edge parks one (scale-down), via
    `EngineSupervisor.scale_to` — non-blocking, the supervisor's
    monitor loop does the process work.
  * `prewarm` — library-generation churn triggers one off-thread AOT
    pre-warm pass so the first post-churn evaluation dispatches warm.

Every actuation flows through ONE gate (`_actuate`): clamped to the
knob's declared [lo, hi], rate-limited by a per-knob cooldown,
direction reversals additionally held back by a hysteresis window
(the anti-oscillation guarantee the bench gates on), recorded as an
`Actuation` (knob, old, new, direction, reason, bounds, clamped),
logged, and counted on
`gatekeeper_tpu_adaptive_actuations_total{knob,direction}`. The
`--adaptive-control` kill switch maps to `disarm()`: the loop stops
and every knob is restored to its captured baseline BIT-EXACTLY (the
baseline value object itself is re-applied, not a rounded replay).

The degradation ladder makes overload behavior an explicit ordered
policy instead of emergent:

  rung 0 `normal`        — no intervention.
  rung 1 `tighten_shed`  — shed_depth actuated down to its floor.
  rung 2 `cache_only`    — ValidationHandler serves decision-cache
                           hits and short-circuits only; misses shed
                           (429 + failure stance) without evaluation.
  rung 3 `fail_stance`   — every non-exempt admission answers per the
                           configured failure stance immediately.

Escalation requires the fast-burn alert bound to hold for
`ladder_dwell` consecutive ticks AFTER shed tightening bottomed out;
de-escalation requires both windows under burn 1.0 for
`ladder_clear` ticks — one rung per dwell, never a jump to the top.

gklint registers `AdaptiveController._loop` as a no-block entry: the
tick may take locks and wait on its pacing event but never sleeps,
never touches sockets/subprocess/kube, and spawns pre-warm on a
one-shot thread — so the control loop can never wedge the plane it
is steering.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from . import metrics
from .logging import logger
from .metrics import REGISTRY
from .slo import ALERT_REFERENCE

log = logger("adaptive")

# ladder rungs, in escalation order (indices are the gauge value and
# the ValidationHandler contract: >= 2 cache-only, >= 3 fail-stance)
RUNG_NORMAL = 0
RUNG_TIGHTEN_SHED = 1
RUNG_CACHE_ONLY = 2
RUNG_FAIL_STANCE = 3

_SIGNAL_METRICS = (
    "gatekeeper_tpu_batch_seal_total",
    "gatekeeper_tpu_batch_fill_ratio",
    "gatekeeper_tpu_queue_depth",
    "gatekeeper_tpu_device_duty_cycle",
    "gatekeeper_tpu_backplane_inflight",
    "admission_requests_shed_total",
)


class Actuation:
    """One knob movement, fully described: what moved, from/to, why,
    inside which declared bounds, and whether the target was clamped.
    The audit trail every self-tuning step leaves behind — /debug/
    adaptive dumps the recent ring, the log line carries the same
    fields, and the {knob,direction} counter aggregates them."""

    __slots__ = ("knob", "old", "new", "direction", "reason",
                 "lo", "hi", "clamped", "t")

    def __init__(self, knob: str, old, new, direction: str,
                 reason: str, lo, hi, clamped: bool, t: float):
        self.knob = knob
        self.old = old
        self.new = new
        self.direction = direction
        self.reason = reason
        self.lo = lo
        self.hi = hi
        self.clamped = clamped
        self.t = t

    def describe(self) -> dict:
        return {"knob": self.knob, "old": self.old, "new": self.new,
                "direction": self.direction, "reason": self.reason,
                "bounds": [self.lo, self.hi], "clamped": self.clamped}


class Knob:
    """One declared actuator: getter/setter plus the bounds and rate
    limits every movement is clamped under. `baseline` is captured at
    arm() time — the configured value disarm() restores bit-exactly."""

    def __init__(self, name: str, get: Callable[[], float],
                 set_: Callable[[float], None], lo, hi,
                 cooldown_s: float = 5.0, integer: bool = False):
        self.name = name
        self.get = get
        self.set = set_
        self.lo = lo
        self.hi = hi
        self.cooldown_s = cooldown_s
        self.integer = integer
        self.baseline = None      # captured at arm()
        self.last_dir: Optional[str] = None
        self.last_t: Optional[float] = None
        self.flips = 0            # landed direction reversals
        self.suppressed = 0       # actuations held by cooldown/hysteresis

    def describe(self) -> dict:
        return {"value": self.get(), "baseline": self.baseline,
                "bounds": [self.lo, self.hi],
                "cooldown_s": self.cooldown_s,
                "last_direction": self.last_dir, "flips": self.flips,
                "suppressed": self.suppressed}


class DegradationLadder:
    """Thread-safe current rung + transition history. Consumers
    (ValidationHandler) only read `.rung`; only the controller (or a
    test) moves it. Reports the rung gauge and the per-rung
    transition counter on every move."""

    def __init__(self):
        self._lock = threading.Lock()
        self._rung = RUNG_NORMAL
        self.transitions = 0
        self.history: deque = deque(maxlen=64)
        metrics.report_degradation_rung(self._rung)

    @property
    def rung(self) -> int:
        return self._rung

    @property
    def name(self) -> str:
        return metrics.DEGRADATION_RUNGS[
            min(self._rung, len(metrics.DEGRADATION_RUNGS) - 1)]

    def set(self, rung: int, reason: str = "") -> bool:
        rung = min(RUNG_FAIL_STANCE, max(RUNG_NORMAL, int(rung)))
        with self._lock:
            if rung == self._rung:
                return False
            old = self._rung
            self._rung = rung
            self.transitions += 1
            self.history.append(
                {"from": old, "to": rung, "reason": reason,
                 "t": time.time()})
        metrics.report_degradation_rung(rung)
        log.info("degradation rung %d -> %d" % (old, rung),
                 details={"reason": reason,
                          "rung": metrics.DEGRADATION_RUNGS[rung]})
        return True

    def describe(self) -> dict:
        return {"rung": self._rung, "name": self.name,
                "transitions": self.transitions,
                "history": list(self.history)}


class AdaptiveController:
    """The closed loop. Construct with whatever actuators this process
    owns (each optional — an audit-only pod gets a controller that
    only watches), `arm()` to capture baselines and start the tick
    thread, `disarm()` to stop and restore every baseline."""

    def __init__(self, batcher=None, engines=None, slo=None,
                 generation: Optional[Callable[[], int]] = None,
                 prewarm: Optional[Callable[[], int]] = None,
                 on_actuate: Optional[Callable] = None,
                 registry=REGISTRY,
                 interval: float = 1.0,
                 hysteresis_s: float = 10.0,
                 cooldown_s: float = 5.0,
                 fanout_cooldown_s: float = 30.0,
                 prewarm_cooldown_s: float = 30.0,
                 fill_low: float = 0.25,
                 seal_dominance: float = 0.8,
                 min_seals: int = 3,
                 duty_high: float = 0.75,
                 duty_low: float = 0.10,
                 relax_after_s: float = 30.0,
                 ladder_dwell: int = 5,
                 ladder_clear: int = 10,
                 max_wait_lo: float = 0.0005,
                 max_wait_hi: float = 0.05,
                 max_batch_lo: int = 16,
                 max_batch_hi: int = 4096,
                 shed_floor_frac: float = 0.125):
        self.registry = registry
        self.slo = slo
        self.batcher = batcher
        self.engines = engines
        self.generation = generation
        self.prewarm = prewarm
        # post-actuation hook (Actuation -> None): Runtime replicates
        # batcher-knob movements to engine children through it. Must
        # itself be non-blocking — it runs on the control loop.
        self.on_actuate = on_actuate
        self.interval = max(0.05, interval)
        self.hysteresis_s = hysteresis_s
        self.fill_low = fill_low
        self.seal_dominance = seal_dominance
        self.min_seals = min_seals
        self.duty_high = duty_high
        self.duty_low = duty_low
        self.relax_after_s = relax_after_s
        self.ladder_dwell = max(1, ladder_dwell)
        self.ladder_clear = max(1, ladder_clear)
        self.prewarm_cooldown_s = prewarm_cooldown_s
        self.ladder = DegradationLadder()
        self.knobs: dict[str, Knob] = {}
        if batcher is not None:
            self.knobs["batch_max_wait"] = Knob(
                "batch_max_wait",
                lambda: batcher.max_wait,
                lambda v: batcher.set_knobs(max_wait=v),
                max_wait_lo, max_wait_hi, cooldown_s=cooldown_s)
            self.knobs["batch_max_batch"] = Knob(
                "batch_max_batch",
                lambda: batcher.max_batch,
                lambda v: batcher.set_knobs(max_batch=v),
                max_batch_lo, max_batch_hi, cooldown_s=cooldown_s,
                integer=True)
            # shed floor derives from the configured depth at arm();
            # 0 (unbounded) stays unbounded — there is no meaningful
            # tightening of "no bound" (the ladder still covers it)
            self._shed_floor_frac = shed_floor_frac
            self.knobs["shed_depth"] = Knob(
                "shed_depth",
                lambda: batcher.max_queue,
                lambda v: batcher.set_knobs(max_queue=v),
                1, 1 << 20, cooldown_s=cooldown_s, integer=True)
        if engines is not None:
            self.knobs["engine_fanout"] = Knob(
                "engine_fanout",
                engines.active_total,
                engines.scale_to,
                1, 1 + len(engines.engine_ids),
                cooldown_s=fanout_cooldown_s, integer=True)
        self._history: deque = deque(maxlen=256)
        self._prev_snap: Optional[dict] = None
        self._last_gen: Optional[int] = None
        self._gen_settled = False
        self._last_prewarm_t: Optional[float] = None
        self._last_busy_t = time.monotonic()
        self._burn_hot_ticks = 0
        self._burn_clear_ticks = 0
        self._armed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self.ticks = 0
        self._last_signals: dict = {}

    # ------------------------------------------------------- lifecycle

    def arm(self) -> None:
        """Capture every knob's configured value as its baseline and
        start the control loop. Idempotent."""
        with self._lock:
            if self._armed:
                return
            for knob in self.knobs.values():
                knob.baseline = knob.get()
                metrics.report_adaptive_knob(knob.name, knob.baseline)
            shed = self.knobs.get("shed_depth")
            if shed is not None:
                if shed.baseline:
                    shed.lo = max(1, int(shed.baseline
                                         * self._shed_floor_frac))
                    shed.hi = int(shed.baseline)
                else:
                    # unbounded queue: leave the knob parked
                    shed.lo = shed.hi = 0
            self._armed = True
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="adaptive",
                                            daemon=True)
            self._thread.start()
        log.info("adaptive controller armed",
                 details={"knobs": sorted(self.knobs),
                          "interval_s": self.interval})

    def disarm(self, restore: bool = True) -> None:
        """Kill switch: stop the loop and (by default) restore every
        knob to its captured baseline bit-exactly. Idempotent."""
        with self._lock:
            if not self._armed:
                return
            self._armed = False
            self._stop.set()
            thread = self._thread
            self._thread = None
        if thread is not None:
            thread.join(timeout=10.0)
        if restore:
            now = time.monotonic()
            for knob in self.knobs.values():
                if knob.baseline is None:
                    continue
                old = knob.get()
                if old == knob.baseline:
                    continue
                knob.set(knob.baseline)
                act = Actuation(knob.name, old, knob.baseline,
                                "restore", "disarm: baseline restore",
                                knob.lo, knob.hi, False, now)
                self._history.append(act)
                metrics.report_adaptive_actuation(knob.name, "restore")
                metrics.report_adaptive_knob(knob.name, knob.baseline)
                log.info("knob restored to baseline",
                         details=act.describe())
                self._notify(act)
            self.ladder.set(RUNG_NORMAL, "disarm")
        log.info("adaptive controller disarmed",
                 details={"restored": restore})

    @property
    def armed(self) -> bool:
        return self._armed

    def healthy(self) -> bool:
        t = self._thread
        return not self._armed or bool(t and t.is_alive())

    # ------------------------------------------------------ the loop

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # the controller must never crash
                log.warning("adaptive tick failed", details=str(e))

    def tick(self, now: Optional[float] = None) -> dict:
        """One control iteration: sample -> decide -> actuate. Public
        so tests (and the bench harness) can drive the loop
        deterministically without the thread."""
        now = now if now is not None else time.monotonic()
        signals = self._sample(now)
        self._last_signals = signals
        self.ticks += 1
        self._steer_batch_shape(signals, now)
        self._steer_ladder(signals, now)
        self._steer_fanout(signals, now)
        self._steer_prewarm(now)
        return signals

    # ------------------------------------------------------- sampling

    def _sample(self, now: float) -> dict:
        snap = self.registry.snapshot(_SIGNAL_METRICS)
        prev, self._prev_snap = self._prev_snap, snap
        seals = self._counter_deltas(
            snap, prev, "gatekeeper_tpu_batch_seal_total",
            match={"plane": "admission"}, by="reason")
        fill = self._hist_mean_delta(
            snap, prev, "gatekeeper_tpu_batch_fill_ratio",
            match={"plane": "admission"})
        shed = sum(self._counter_deltas(
            snap, prev, "admission_requests_shed_total").values())
        depth = sum(v for _, v in self._gauge_values(
            snap, "gatekeeper_tpu_queue_depth",
            match={"queue": "admission"}))
        duties = [v for _, v in self._gauge_values(
            snap, "gatekeeper_tpu_device_duty_cycle")]
        inflight = sum(v for _, v in self._gauge_values(
            snap, "gatekeeper_tpu_backplane_inflight"))
        burn = {}
        if self.slo is not None:
            burn = (self.slo.latest() or {}).get("availability") or {}
        return {
            "seals": seals,
            "seal_total": sum(seals.values()),
            "mean_fill": fill,
            "shed_delta": shed,
            "queue_depth": depth,
            "duty_max": max(duties) if duties else 0.0,
            "inflight": inflight,
            "burn_5m": (burn.get("5m") or {}).get("burn_rate", 0.0),
            "burn_1h": (burn.get("1h") or {}).get("burn_rate", 0.0),
        }

    @staticmethod
    def _entries(snap: Optional[dict], name: str):
        ent = (snap or {}).get(name)
        if not ent:
            return (), ()
        return tuple(ent.get("labels") or ()), ent

    def _gauge_values(self, snap, name, match=None):
        labels, ent = self._entries(snap, name)
        out = []
        for key, v in (ent.get("values") or []) if ent else []:
            lab = dict(zip(labels, tuple(key)))
            if match and any(lab.get(mk) != mv
                             for mk, mv in match.items()):
                continue
            out.append((lab, v))
        return out

    def _counter_deltas(self, snap, prev, name, match=None, by=None):
        cur = {tuple(k): v for k, v in self._raw_values(snap, name)}
        old = {tuple(k): v for k, v in self._raw_values(prev, name)}
        labels, _ = self._entries(snap, name)
        out: dict = {}
        for key, v in cur.items():
            lab = dict(zip(labels, key))
            if match and any(lab.get(mk) != mv
                             for mk, mv in match.items()):
                continue
            d = v - old.get(key, 0.0)
            if d <= 0:
                continue
            bucket = lab.get(by, "") if by else ""
            out[bucket] = out.get(bucket, 0.0) + d
        return out

    @staticmethod
    def _raw_values(snap, name):
        ent = (snap or {}).get(name) or {}
        return ent.get("values") or []

    def _hist_mean_delta(self, snap, prev, name, match=None):
        labels, ent = self._entries(snap, name)
        if not ent:
            return None
        old = {tuple(k): (s, n)
               for k, _, s, n in
               (((prev or {}).get(name) or {}).get("hist") or [])}
        dsum = dcount = 0.0
        for k, _, s, n in ent.get("hist") or []:
            lab = dict(zip(labels, tuple(k)))
            if match and any(lab.get(mk) != mv
                             for mk, mv in match.items()):
                continue
            ps, pn = old.get(tuple(k), (0.0, 0))
            dsum += s - ps
            dcount += n - pn
        if dcount <= 0:
            return None
        return dsum / dcount

    # ------------------------------------------------------ policies

    def _steer_batch_shape(self, signals: dict, now: float) -> None:
        wait = self.knobs.get("batch_max_wait")
        batch = self.knobs.get("batch_max_batch")
        if wait is None or batch is None:
            return
        total = signals["seal_total"]
        seals = signals["seals"]
        fill = signals["mean_fill"]
        if total >= self.min_seals:
            self._last_busy_t = now
            if (seals.get("max_wait", 0.0) / total
                    >= self.seal_dominance
                    and fill is not None and fill <= self.fill_low):
                # edge trickle: every batch waits the full window to
                # seal near-empty — the wait is pure added latency
                self._actuate(wait, wait.get() * 0.5,
                              "max_wait-sealed at fill %.2f" % fill,
                              now)
                return
            if seals.get("full", 0.0) / total >= self.seal_dominance:
                # engine-bound: batches seal full — amortize further
                self._actuate(batch, batch.get() * 2,
                              "full-sealed: growing batch", now)
                return
        if now - self._last_busy_t >= self.relax_after_s:
            # quiet plane: drift both knobs back toward the
            # configured baseline one cooldown-paced step at a time
            for knob in (wait, batch):
                if knob.baseline is None or knob.get() == knob.baseline:
                    continue
                cur = knob.get()
                target = (min(cur * 2, knob.baseline) if
                          cur < knob.baseline
                          else max(cur / 2, knob.baseline))
                self._actuate(knob, target, "relax toward baseline",
                              now)

    def _steer_ladder(self, signals: dict, now: float) -> None:
        shed = self.knobs.get("shed_depth")
        fast_ref = ALERT_REFERENCE.get("5m", 14.4)
        slow_ref = ALERT_REFERENCE.get("1h", 6.0)
        hot = (signals["burn_5m"] >= fast_ref
               or signals["burn_1h"] >= slow_ref)
        clear = signals["burn_5m"] < 1.0 and signals["burn_1h"] < 1.0
        if hot:
            self._burn_hot_ticks += 1
            self._burn_clear_ticks = 0
        elif clear:
            self._burn_clear_ticks += 1
            self._burn_hot_ticks = 0
        else:
            self._burn_hot_ticks = 0
            self._burn_clear_ticks = 0
        tightened_out = True
        if shed is not None and shed.hi:
            if hot:
                self.ladder.set(max(self.ladder.rung,
                                    RUNG_TIGHTEN_SHED),
                                "availability burn %.1fx/%.1fx over "
                                "alert bounds"
                                % (signals["burn_5m"],
                                   signals["burn_1h"]))
                self._actuate(shed, shed.get() // 2,
                              "availability burn over alert bounds",
                              now)
            elif clear and self.ladder.rung <= RUNG_TIGHTEN_SHED \
                    and shed.get() < shed.hi:
                self._actuate(shed, min(shed.get() * 2, shed.hi),
                              "burn clear: relaxing shed depth", now)
            tightened_out = shed.get() <= shed.lo
        if hot and tightened_out \
                and self._burn_hot_ticks >= self.ladder_dwell:
            # tightening alone is not holding the budget: climb ONE
            # rung, then require a fresh dwell before the next
            if self.ladder.set(self.ladder.rung + 1,
                               "burn held %dx dwell after shed floor"
                               % self._burn_hot_ticks):
                self._burn_hot_ticks = 0
        if self._burn_clear_ticks >= self.ladder_clear \
                and self.ladder.rung > RUNG_NORMAL:
            rung = self.ladder.rung - 1
            if rung == RUNG_TIGHTEN_SHED and shed is not None \
                    and shed.hi and shed.get() >= shed.hi:
                rung = RUNG_NORMAL  # shed already relaxed: skip rung 1
            if self.ladder.set(rung, "burn clear %d ticks"
                               % self._burn_clear_ticks):
                self._burn_clear_ticks = 0

    def _steer_fanout(self, signals: dict, now: float) -> None:
        fan = self.knobs.get("engine_fanout")
        if fan is None:
            return
        cur = fan.get()
        if signals["duty_max"] >= self.duty_high and cur < fan.hi:
            # engine-bound: evaluators busy — add capacity
            self._actuate(fan, cur + 1,
                          "duty %.2f: engine-bound" % signals["duty_max"],
                          now)
        elif (signals["duty_max"] <= self.duty_low
              and signals["inflight"] <= 1.0
              and signals["queue_depth"] <= 1.0
              and cur > fan.lo):
            # edge- or nothing-bound: park an engine (the supervisor
            # keeps the process warm to respawn on the next step-up)
            self._actuate(fan, cur - 1,
                          "duty %.2f, idle edge: parking engine"
                          % signals["duty_max"], now)

    def _steer_prewarm(self, now: float) -> None:
        if self.generation is None or self.prewarm is None:
            return
        try:
            gen = self.generation()
        except Exception:
            return
        if self._last_gen is None:
            self._last_gen = gen
            return
        if gen != self._last_gen:
            # churn in flight: wait for a settled tick so one burst of
            # template ingestion triggers ONE pre-warm, not one per op
            self._last_gen = gen
            self._gen_settled = False
            return
        if self._gen_settled:
            return
        self._gen_settled = True
        if self._last_prewarm_t is not None and \
                now - self._last_prewarm_t < self.prewarm_cooldown_s:
            return
        self._last_prewarm_t = now
        prewarm = self.prewarm

        def run():
            try:
                n = prewarm()
                log.info("adaptive pre-warm pass finished",
                         details={"programs": n})
            except Exception as e:
                log.warning("adaptive pre-warm failed", details=str(e))

        threading.Thread(target=run, name="adaptive-prewarm",
                         daemon=True).start()
        act = Actuation("prewarm", 0, 1, "up",
                        "library generation settled at %d"
                        % self._last_gen, 0, 1, False, now)
        self._history.append(act)
        metrics.report_adaptive_actuation("prewarm", "up")
        log.info("adaptive pre-warm spawned", details=act.describe())

    # ------------------------------------------------------ actuation

    def _actuate(self, knob: Knob, target, reason: str,
                 now: float) -> Optional[Actuation]:
        """The single gate every knob movement passes: clamp, rate
        limit (cooldown + reversal hysteresis), apply, record."""
        lo, hi = knob.lo, knob.hi
        new = min(hi, max(lo, target))
        clamped = new != target
        if knob.integer:
            new = int(round(new))
        old = knob.get()
        if new == old:
            return None
        direction = "up" if new > old else "down"
        if knob.last_t is not None:
            since = now - knob.last_t
            if direction == knob.last_dir and since < knob.cooldown_s:
                knob.suppressed += 1
                return None
            if direction != knob.last_dir and since < self.hysteresis_s:
                # a reversal this soon IS oscillation: hold the knob
                knob.suppressed += 1
                return None
        knob.set(new)
        if knob.last_dir is not None and direction != knob.last_dir:
            knob.flips += 1
        knob.last_dir = direction
        knob.last_t = now
        act = Actuation(knob.name, old, new, direction, reason,
                        lo, hi, clamped, now)
        self._history.append(act)
        metrics.report_adaptive_actuation(knob.name, direction)
        metrics.report_adaptive_knob(knob.name, new)
        log.info("adaptive actuation", details=act.describe())
        self._notify(act)
        return act

    def _notify(self, act: Actuation) -> None:
        if self.on_actuate is None:
            return
        try:
            self.on_actuate(act)
        except Exception as e:
            log.warning("actuation hook failed", details=str(e))

    # ---------------------------------------------------------- views

    def flip_count(self) -> int:
        """Total landed direction reversals across all knobs — the
        oscillation measure the bench gate reads."""
        return sum(k.flips for k in self.knobs.values())

    def actuations(self) -> list:
        return [a.describe() for a in self._history]

    def status(self, query: str = "") -> dict:
        """/debug/adaptive payload."""
        return {
            "armed": self._armed,
            "interval_s": self.interval,
            "hysteresis_s": self.hysteresis_s,
            "ticks": self.ticks,
            "ladder": self.ladder.describe(),
            "knobs": {name: k.describe()
                      for name, k in sorted(self.knobs.items())},
            "flip_count": self.flip_count(),
            "signals": self._last_signals,
            "actuations": self.actuations()[-32:],
        }
