"""Declarative SLOs compiled against the metrics Registry into
multi-window burn-rate gauges.

The serving plane's per-stage latency histograms and its
saturation gauges say WHERE capacity goes — this module says whether
the plane is meeting its promises, in the shape alerting actually
consumes: error-budget BURN RATES over two windows (5m/1h), the
multiwindow-multi-burn-rate pattern from the SRE workbook. Burn rate
1.0 means the objective is consuming its budget exactly at the
sustained-compliance rate; 14.4 over 5m (for a 99.9% objective over a
30-day budget) is the classic fast-burn page, 6 over 1h the slow-burn
ticket.

Objectives are DECLARATIVE — a name, a target, and which existing
Registry series to read:

  * `latency`: a histogram family + a threshold that must be one of
    its bucket bounds; "target fraction of observations complete
    under threshold". Good events = the cumulative bucket count at the
    threshold bound, total = _count — no new instrumentation, the
    compliance math rides the histograms the planes already emit.
  * `availability`: a counter family with a status label; bad label
    values are enumerated (shed/timeout/error for admission). Good =
    total - bad.

`SloEngine` samples each objective's (good, total) totals on a ring
(one sample per `sample_interval`, sized to cover the longest window),
computes per-window bad-event fractions from the deltas, divides by
the error budget (1 - target), and exports
`gatekeeper_tpu_slo_burn_rate{slo,window}` plus
`gatekeeper_tpu_slo_target{slo}`. `/debug/slo` dumps the full
compliance picture (targets, windows, burn rates, event counts, alert
reference thresholds) as JSON.

Windows shorter than the accumulated history use the oldest available
sample (a freshly booted pod reports burn over its own lifetime — the
honest answer, not zero).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from .logging import logger
from .metrics import REGISTRY, Registry

log = logger("slo")

# the two standard alerting windows: fast-burn (page) and slow-burn
# (ticket). Keys are the label values on the burn-rate gauge.
DEFAULT_WINDOWS: dict[str, float] = {"5m": 300.0, "1h": 3600.0}

# SRE-workbook reference burn thresholds for a 30-day budget, surfaced
# in /debug/slo so the operator wiring alerts doesn't re-derive them
ALERT_REFERENCE = {"5m": 14.4, "1h": 6.0}

DEFAULT_SAMPLE_INTERVAL_S = 15.0


class SloObjective:
    """One declarative objective bound to an existing metric family."""

    def __init__(self, name: str, kind: str, target: float, metric: str,
                 threshold_s: Optional[float] = None,
                 status_label: str = "",
                 bad_statuses: tuple = ()):
        if kind not in ("latency", "availability"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if not 0.0 < target < 1.0:
            raise ValueError(f"SLO target must be in (0, 1): {target}")
        if kind == "latency" and (threshold_s is None or threshold_s <= 0):
            raise ValueError(f"latency SLO {name!r} needs threshold_s")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.metric = metric
        self.threshold_s = threshold_s
        self.status_label = status_label
        self.bad_statuses = frozenset(bad_statuses)
        self._bound_warned = False

    # ------------------------------------------------------------ totals

    def totals(self, registry: Registry) -> tuple[float, float]:
        """(good, total) event totals right now, summed across every
        label series of the bound family. Monotonic by construction
        (counters / histogram counts), which is what the windowed
        delta math assumes."""
        snap = registry.snapshot((self.metric,)).get(self.metric)
        if snap is None:
            return 0.0, 0.0
        if self.kind == "latency":
            return self._latency_totals(snap)
        return self._availability_totals(snap)

    def _latency_totals(self, snap: dict) -> tuple[float, float]:
        buckets = list(snap.get("buckets") or ())
        # the threshold bucket: smallest bound >= threshold, resolved
        # per sample (the family may not exist yet at construction).
        # A threshold past every finite bound degrades to "anything
        # not in +Inf overflow is good".
        k = len(buckets) - 1
        for i, b in enumerate(buckets):
            if self.threshold_s <= b + 1e-12:
                k = i
                break
        if buckets and not self._bound_warned and not any(
                abs(self.threshold_s - b) <= 1e-9 for b in buckets):
            # a threshold between bounds silently rounds UP to the next
            # bound (overcounting good events, under-reporting burn) —
            # every other bad --slo-* value fails loudly, this one must
            # at least SAY it is measuring a different promise
            self._bound_warned = True
            log.warning(
                "SLO latency threshold is not a histogram bucket bound;"
                " compliance is measured at the next bound up",
                details={"slo": self.name,
                         "threshold_s": self.threshold_s,
                         "effective_bound_s": buckets[k],
                         "bounds": list(buckets)})
        good = total = 0.0
        for _labels, counts, _sum, n in snap.get("hist") or []:
            total += n
            # +Inf overflow (counts[-1]) is bad by definition: it is
            # never inside the k-prefix sum
            good += sum(counts[: k + 1])
        return good, total

    def _availability_totals(self, snap: dict) -> tuple[float, float]:
        label_names = list(snap.get("labels") or ())
        try:
            idx = label_names.index(self.status_label)
        except ValueError:
            idx = 0 if label_names else -1
        good = total = 0.0
        for labelvals, v in snap.get("values") or []:
            total += v
            status = labelvals[idx] if 0 <= idx < len(labelvals) else ""
            if status not in self.bad_statuses:
                good += v
        return good, total

    def describe(self) -> dict:
        out = {"name": self.name, "kind": self.kind,
               "target": self.target, "metric": self.metric}
        if self.kind == "latency":
            out["threshold_s"] = self.threshold_s
        else:
            out["bad_statuses"] = sorted(self.bad_statuses)
        return out


def default_objectives(admission_p99_s: float = 0.1,
                       availability_target: float = 0.999,
                       detection_p99_s: float = 1.0) -> list[SloObjective]:
    """The shipped objective set (each tunable via --slo-* flags):

    * admission_p99_latency — 99% of admission decisions complete
      under `admission_p99_s` (reads request_duration_seconds);
    * availability — at most 1-target of admission requests end
      shed / timeout / error (reads request_count);
    * violation_detection_p99 — 99% of streaming-audit detections
      (event -> status write) complete under `detection_p99_s`.
    """
    return [
        SloObjective("admission_p99_latency", "latency", 0.99,
                     "request_duration_seconds",
                     threshold_s=admission_p99_s),
        SloObjective("availability", "availability",
                     availability_target, "request_count",
                     status_label="admission_status",
                     bad_statuses=("shed", "timeout", "error")),
        SloObjective("violation_detection_p99", "latency", 0.99,
                     "gatekeeper_tpu_violation_detection_seconds",
                     threshold_s=detection_p99_s),
    ]


class SloEngine:
    """Samples objective totals on a ring and exports burn rates.

    The ring holds (monotonic_ts, {slo: (good, total)}) samples at
    `sample_interval`, sized to span the longest window with slack; a
    window's burn rate is computed from the delta between now and the
    newest sample at least `window` old (or the oldest held — a young
    process reports burn over its lifetime)."""

    def __init__(self, objectives: list[SloObjective],
                 registry: Registry = REGISTRY,
                 windows: Optional[dict[str, float]] = None,
                 sample_interval_s: float = DEFAULT_SAMPLE_INTERVAL_S):
        self.objectives = list(objectives)
        self.registry = registry
        self.windows = dict(windows or DEFAULT_WINDOWS)
        self.sample_interval_s = max(1.0, float(sample_interval_s))
        keep = int(max(self.windows.values())
                   / self.sample_interval_s) + 8
        self._samples: deque = deque(maxlen=keep)
        self._last_rates: dict = {}  # latest export(), for latest()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- sampling

    def sample(self, now: Optional[float] = None) -> None:
        """Take one totals sample (the loop calls this; tests inject
        `now` to fabricate history without sleeping)."""
        totals = {}
        for obj in self.objectives:
            try:
                totals[obj.name] = obj.totals(self.registry)
            except Exception as e:  # a broken family must not kill SLOs
                log.warning("SLO totals read failed",
                            details={"slo": obj.name, "error": str(e)})
        with self._lock:
            self._samples.append(
                (now if now is not None else time.monotonic(), totals))

    def _window_anchor(self, now: float, window_s: float
                       ) -> Optional[tuple]:
        """Newest sample at least `window_s` old, else the oldest held."""
        with self._lock:
            if not self._samples:
                return None
            anchor = self._samples[0]
            for ts, totals in self._samples:
                if now - ts >= window_s:
                    anchor = (ts, totals)
                else:
                    break
            return anchor

    def burn_rates(self, now: Optional[float] = None) -> dict:
        """{slo: {window: {burn_rate, bad, total, window_actual_s}}}
        over the configured windows, from the ring's deltas."""
        now = now if now is not None else time.monotonic()
        cur = {}
        for obj in self.objectives:
            try:
                cur[obj.name] = obj.totals(self.registry)
            except Exception:
                continue
        out: dict = {}
        for wname, wsec in sorted(self.windows.items(),
                                  key=lambda kv: kv[1]):
            anchor = self._window_anchor(now, wsec)
            for obj in self.objectives:
                if obj.name not in cur:
                    continue
                good_now, total_now = cur[obj.name]
                if anchor is None:
                    good_then = total_then = 0.0
                    actual = 0.0
                else:
                    good_then, total_then = anchor[1].get(
                        obj.name, (0.0, 0.0))
                    actual = now - anchor[0]
                d_total = max(0.0, total_now - total_then)
                d_bad = max(0.0, (total_now - good_now)
                            - (total_then - good_then))
                budget = 1.0 - obj.target
                bad_frac = (d_bad / d_total) if d_total > 0 else 0.0
                burn = bad_frac / budget if budget > 0 else 0.0
                out.setdefault(obj.name, {})[wname] = {
                    "burn_rate": round(burn, 4),
                    "bad": d_bad, "total": d_total,
                    "window_actual_s": round(actual, 1),
                }
        return out

    # ----------------------------------------------------------- exports

    def latest(self) -> dict:
        """The most recent export()'s burn rates, without recomputing:
        the adaptive controller's per-tick signal read. Shape matches
        burn_rates(); {} before the first export. The reference is
        swapped atomically and never mutated after publication, so
        readers need no lock."""
        return self._last_rates

    def export(self, now: Optional[float] = None) -> dict:
        """Refresh the burn-rate gauges from the ring; returns what it
        exported (the /debug/slo payload core)."""
        rates = self.burn_rates(now)
        self._last_rates = rates
        for obj in self.objectives:
            self.registry.gauge_set(
                "gatekeeper_tpu_slo_target",
                "Declared SLO target (fraction of good events promised)",
                obj.target, slo=obj.name)
            for wname, ent in (rates.get(obj.name) or {}).items():
                self.registry.gauge_set(
                    "gatekeeper_tpu_slo_burn_rate",
                    "Error-budget burn rate per objective and window "
                    "(1.0 = consuming budget exactly at the sustained-"
                    "compliance rate; see /debug/slo for alert "
                    "reference thresholds)",
                    ent["burn_rate"], slo=obj.name, window=wname)
        return rates

    def status(self, now: Optional[float] = None) -> dict:
        """The /debug/slo payload: objectives, current burn rates per
        window, and the standard alerting reference."""
        rates = self.burn_rates(now)
        objectives = []
        for obj in self.objectives:
            try:
                good, total = obj.totals(self.registry)
            except Exception:
                good = total = 0.0
            compliance = (good / total) if total > 0 else None
            objectives.append({
                **obj.describe(),
                "events_total": total,
                "events_bad": total - good,
                "compliance": (round(compliance, 6)
                               if compliance is not None else None),
                "windows": rates.get(obj.name, {}),
            })
        return {
            "objectives": objectives,
            "windows_s": self.windows,
            "sample_interval_s": self.sample_interval_s,
            "samples_held": len(self._samples),
            "alert_reference_burn_rates": dict(ALERT_REFERENCE),
            "note": "burn_rate 1.0 consumes the error budget exactly "
                    "at the sustained-compliance rate; page on the 5m "
                    "fast-burn threshold, ticket on the 1h slow burn",
        }

    # ---------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self.sample()  # seed the ring so the first export has an anchor
        self.export()
        self._thread = threading.Thread(target=self._loop, name="slo",
                                        daemon=True)
        self._thread.start()
        log.info("SLO engine started",
                 details={"objectives": [o.name for o in self.objectives],
                          "windows": self.windows})

    def _loop(self) -> None:
        while not self._stop.wait(self.sample_interval_s):
            try:
                self.sample()
                self.export()
            except Exception as e:  # the SLO layer must never crash a pod
                log.warning("SLO tick failed", details=str(e))

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # wait the sampler out BEFORE zeroing: an in-flight tick's
            # export() would re-write the last burst's burn after the
            # zero (same discipline as AuditManager.stop)
            self._thread.join(timeout=10.0)
        # burn-rate gauges are SET-only and alert-bearing: a stopped
        # engine in a still-serving process (embedder, test harness)
        # must not export its last burst's burn — and keep a page
        # firing — forever
        for obj in self.objectives:
            for wname in self.windows:
                try:
                    self.registry.gauge_set(
                        "gatekeeper_tpu_slo_burn_rate",
                        "Error-budget burn rate per objective and "
                        "window", 0.0, slo=obj.name, window=wname)
                except Exception:
                    pass
