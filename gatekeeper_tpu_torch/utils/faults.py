"""Fault injection for chaos testing.

Named injection points are compiled into the serving paths (kube writes,
watch subscriptions, device evaluation, the micro-batch flusher) and are
ZERO-COST when no fault is armed: `fire()` returns on a plain dict lookup.
Arming happens programmatically (the chaos suite), via the
GATEKEEPER_TPU_FAULTS environment variable, or the --fault-injection
flag — the production entrypoint accepts storms so operators can game-day
a staging cluster with the exact binary they deploy.

Spec syntax (env/flag), comma-separated:

    point:mode[:param][@rate][#count]

    kube.write:error:503            every guarded kube write fails 503
    kube.write:error:503@0.5#20     ... with probability 0.5, 20 times
    kube.watch:error                watch subscriptions fail (poll path)
    eval.device:raise               device eval raises (quarantine path)
    webhook.flush:sleep:2           each micro-batch flush stalls 2s
    state.snapshot:corrupt          snapshot files corrupt on disk
    state.snapshot:truncate#1       one snapshot file torn mid-write
    kube.lease:steal                leader lease stolen by a rival
    kube.lease:expire               leader misses renews; lease lapses
    backplane.engine:error          frontends cannot reach the engine
                                    (answer per the failure stance)

Injection points in the tree (grep for faults.fire / faults.consume):
    kube.write     control/resilience.py  GuardedKube mutating verbs
    kube.watch     control/resilience.py  GuardedKube.watch subscribe
    eval.device    ir/driver.py           compiled-template device eval
    webhook.flush  control/webhook.py     MicroBatcher._flush entry
    state.snapshot control/statestore.py  snapshot save/load (modes:
                   io-error -> the I/O call raises; truncate/corrupt ->
                   the on-disk file is torn / bit-flipped so the next
                   restore must fall back to the cold path)
    kube.lease     control/kube.py        LeaseElector tick (modes:
                   steal -> a rival identity takes the lease; expire ->
                   our renews stop landing and the lease lapses;
                   error -> the renew API call fails)
    backplane.engine control/backplane.py BackplaneClient.call — the
                   frontend->engine forward path (raise/error -> the
                   engine is unreachable and the frontend answers per
                   the fail-open/closed stance; sleep -> a slow
                   backplane)
    backplane.wire control/backplane.py    _send_frame — the wire
                   itself (modes: reset -> the socket closes mid-frame;
                   truncate -> a partial frame is written then the
                   socket closes; slow -> the frame drips out in small
                   chunks with delays, holding the peer's read loop)
    state.disk     control/statestore.py   _write_atomic (modes:
                   enospc/eio -> the write raises OSError as if the
                   state dir ran out of space / the device errored)
    kube.list      control/kube.py         FakeKube.list — apiserver
                   flap (error param carries the HTTP code: 410 forces
                   relist storms, 429 rate-limit storms)
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Any, Callable, Optional


class FaultError(Exception):
    """Default exception raised at an armed point (sites that need a
    typed error — e.g. KubeError with an HTTP code — translate it)."""

    def __init__(self, point: str, param: Optional[str] = None):
        super().__init__(f"injected fault at {point}"
                         + (f" ({param})" if param else ""))
        self.point = point
        self.param = param

    def code(self, default: int = 503) -> int:
        try:
            return int(self.param)
        except (TypeError, ValueError):
            return default


class _Spec:
    __slots__ = ("point", "mode", "param", "rate", "count", "sleep_s",
                 "exc", "match")

    def __init__(self, point: str, mode: str, param: Optional[str],
                 rate: float, count: Optional[int], sleep_s: float,
                 exc: Optional[Callable[[], BaseException]],
                 match: Optional[dict]):
        self.point = point
        self.mode = mode          # "raise" | "error" | "sleep"
        self.param = param
        self.rate = rate
        self.count = count        # remaining fires; None = unlimited
        self.sleep_s = sleep_s
        self.exc = exc            # factory overriding the default
        self.match = match        # ctx subset that must equal fire()'s


class FaultInjector:
    """Thread-safe registry of armed faults + per-point fire counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: dict[str, _Spec] = {}
        self._fired: dict[str, int] = {}

    # ------------------------------------------------------------- arming

    def inject(self, point: str, mode: str = "raise",
               param: Optional[str] = None, rate: float = 1.0,
               count: Optional[int] = None, sleep_s: float = 0.0,
               exc: Optional[Callable[[], BaseException]] = None,
               match: Optional[dict] = None) -> None:
        with self._lock:
            self._specs[point] = _Spec(point, mode, param, rate, count,
                                       sleep_s, exc, match)

    def clear(self, point: Optional[str] = None) -> None:
        with self._lock:
            if point is None:
                self._specs.clear()
            else:
                self._specs.pop(point, None)

    def reset(self) -> None:
        """Disarm everything and zero the counters (test isolation)."""
        with self._lock:
            self._specs.clear()
            self._fired.clear()

    def configure(self, spec_text: str) -> None:
        """Arm faults from the flag/env spec syntax (module docstring)."""
        for part in (spec_text or "").split(","):
            part = part.strip()
            if not part:
                continue
            count = None
            if "#" in part:
                part, _, c = part.rpartition("#")
                count = int(c)
            rate = 1.0
            if "@" in part:
                part, _, r = part.rpartition("@")
                rate = float(r)
            fields = part.split(":")
            point = fields[0]
            mode = fields[1] if len(fields) > 1 else "raise"
            param = fields[2] if len(fields) > 2 else None
            sleep_s = float(param) if mode == "sleep" and param else 1.0
            self.inject(point, mode=mode, param=param, rate=rate,
                        count=count, sleep_s=sleep_s)

    # ---------------------------------------------------------- reporting

    def fired(self, point: str) -> int:
        with self._lock:
            return self._fired.get(point, 0)

    def armed(self) -> list[str]:
        with self._lock:
            return sorted(self._specs)

    def armed_snapshot(self) -> dict[str, dict]:
        """Full armed-state snapshot for /debug/chaos: point -> the
        spec's observable fields (mode, param, rate, remaining count).
        An aborted schedule reports which faults were still pending."""
        with self._lock:
            return {
                point: {
                    "mode": spec.mode,
                    "param": spec.param,
                    "rate": spec.rate,
                    "count": spec.count,
                }
                for point, spec in sorted(self._specs.items())
            }

    def fired_snapshot(self) -> dict[str, int]:
        """All per-point fire counters (points that fired at least
        once), for the /debug/chaos ledger."""
        with self._lock:
            return dict(sorted(self._fired.items()))

    # ------------------------------------------------------------- firing

    def fire(self, point: str, **ctx: Any) -> None:
        """Called at an injection point; no-op unless armed. An armed
        "sleep" fault stalls the caller; "raise"/"error" raise the
        injected exception (FaultError carrying the param when no
        factory was given)."""
        if not self._specs:  # hot path: nothing armed anywhere
            return
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return
            if spec.match and any(ctx.get(k) != v
                                  for k, v in spec.match.items()):
                return
            if spec.rate < 1.0 and random.random() >= spec.rate:
                return
            if spec.count is not None:
                if spec.count <= 0:
                    return
                spec.count -= 1
                if spec.count == 0:
                    self._specs.pop(point, None)
            self._fired[point] = self._fired.get(point, 0) + 1
            sleep_s = spec.sleep_s if spec.mode == "sleep" else 0.0
            exc = None
            if spec.mode in ("raise", "error"):
                exc = spec.exc() if spec.exc is not None else \
                    FaultError(point, spec.param)
        if sleep_s:
            time.sleep(sleep_s)
        if exc is not None:
            raise exc

    def consume(self, point: str, **ctx: Any) -> Optional[tuple]:
        """Site-interpreted firing: instead of raising, return the armed
        `(mode, param)` for the caller to act on (file corruption, lease
        theft — behaviors only the call site can simulate), or None when
        nothing is armed. Respects rate/count/match and increments the
        fire counter exactly like fire()."""
        if not self._specs:
            return None
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return None
            if spec.match and any(ctx.get(k) != v
                                  for k, v in spec.match.items()):
                return None
            if spec.rate < 1.0 and random.random() >= spec.rate:
                return None
            if spec.count is not None:
                if spec.count <= 0:
                    return None
                spec.count -= 1
                if spec.count == 0:
                    self._specs.pop(point, None)
            self._fired[point] = self._fired.get(point, 0) + 1
            return (spec.mode, spec.param)


FAULTS = FaultInjector()

_env_spec = os.environ.get("GATEKEEPER_TPU_FAULTS")
if _env_spec:
    FAULTS.configure(_env_spec)


def fire(point: str, **ctx: Any) -> None:
    FAULTS.fire(point, **ctx)


def consume(point: str, **ctx: Any) -> Optional[tuple]:
    return FAULTS.consume(point, **ctx)
