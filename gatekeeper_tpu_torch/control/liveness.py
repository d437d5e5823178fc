"""Crash-loop backoff shared by the process supervisors.

The serving plane's three supervisors (frontends, engine children,
audit shards) respawn dead children from a 0.5s monitor loop. Before
this module that respawn was immediate and unconditional — a child
that dies during boot (bad flag, broken device, poisoned snapshot)
hot-loops the supervisor: spawn, crash, spawn, crash, each cycle
burning a fork + JAX init and spamming the log. `Backoff` rate-limits
the loop with jittered exponential delays and exports the state as two
supervisor-labeled gauges:

    gatekeeper_tpu_respawn_backoff_seconds{supervisor}  the delay the
        supervisor is currently holding before the next respawn
        attempt (0 = healthy / no delay pending)
    gatekeeper_tpu_crashloop_breaker{supervisor}  1 once a child has
        died `trip_after` consecutive times without ever surviving
        past `healthy_after` seconds — the alerting read for "this
        child will not come back on its own". Respawns CONTINUE at the
        capped delay; the breaker is a signal, not a stop.

A child that stays up past `healthy_after` resets its slot's count
(and the breaker, once no slot is tripped): a one-off chaos kill pays
no delay, only a sustained crash loop does.
"""

from __future__ import annotations

import random
import threading

from . import metrics


class Backoff:
    """Per-supervisor jittered exponential respawn backoff + crash-loop
    breaker. Thread-safe; one instance per supervisor, tracking every
    child slot."""

    def __init__(self, supervisor: str, base: float = 0.25,
                 factor: float = 2.0, cap: float = 30.0,
                 healthy_after: float = 30.0, trip_after: int = 5,
                 rng: random.Random = None):
        self.supervisor = supervisor
        self.base = base
        self.factor = factor
        self.cap = cap
        self.healthy_after = healthy_after
        self.trip_after = trip_after
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        self._consecutive: dict = {}   # slot -> deaths without a
        #                                healthy_after-long uptime
        self._tripped: set = set()

    def delay_for(self, slot, uptime_s: float) -> float:
        """Record one child death and return the delay to hold before
        its respawn. The first death of a healthy child (uptime past
        `healthy_after`, or the first ever) respawns immediately;
        consecutive fast deaths climb base * factor^n, jittered to
        [0.5x, 1.5x) so N children crashing together don't respawn in
        lockstep, capped at `cap`."""
        with self._lock:
            if uptime_s >= self.healthy_after:
                self._consecutive[slot] = 0
                self._tripped.discard(slot)
            n = self._consecutive.get(slot, 0) + 1
            self._consecutive[slot] = n
            if n >= self.trip_after:
                self._tripped.add(slot)
            tripped = bool(self._tripped)
            if n <= 1:
                delay = 0.0
            else:
                delay = min(self.cap, self.base * self.factor ** (n - 2))
                delay = min(self.cap,
                            delay * (0.5 + self._rng.random()))
        metrics.report_respawn_backoff(self.supervisor, delay)
        metrics.report_crashloop_breaker(self.supervisor, tripped)
        return delay

    def respawned(self, slot) -> None:
        """The slot's replacement is up: no delay is held any more (the
        crash count persists — only a healthy_after-long uptime, seen
        by note_healthy or the next delay_for, clears it)."""
        metrics.report_respawn_backoff(self.supervisor, 0.0)

    def pending(self, slot) -> bool:
        """True while the slot carries crash-loop state (a non-zero
        consecutive count or a tripped breaker) that a healthy uptime
        observation should clear."""
        with self._lock:
            return bool(self._consecutive.get(slot)) \
                or slot in self._tripped

    def note_healthy(self, slot) -> None:
        """The supervisor observed this slot's child alive past
        `healthy_after`: clear its crash count and, once no slot is
        tripped, the breaker gauge."""
        with self._lock:
            if not self._consecutive.get(slot) \
                    and slot not in self._tripped:
                return
            self._consecutive[slot] = 0
            self._tripped.discard(slot)
            tripped = bool(self._tripped)
        metrics.report_crashloop_breaker(self.supervisor, tripped)

    def close(self) -> None:
        """Supervisor teardown: a stopped supervisor must not export
        its last backoff/breaker state forever."""
        metrics.report_respawn_backoff(self.supervisor, 0.0)
        metrics.report_crashloop_breaker(self.supervisor, False)
