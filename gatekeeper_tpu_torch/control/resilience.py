"""Kube write resilience: circuit breaker, retry budget, guarded client.

Gatekeeper's control loops write to the API server from several places
(audit constraint-status PATCHes, cert secret/CA-bundle updates,
controller byPod statuses and CRD applies — Runtime hands them all the
guarded client). During an API-server brownout every one of
those callers used to retry independently — N loops x M constraints of
synchronized hammering at the worst possible moment. This module gives
them one shared failure discipline, mirroring the reference's reliance on
client-go rate limiting + workqueue backoff:

  * CircuitBreaker — closed -> open after `failure_threshold` consecutive
    write failures; open -> half-open after `reset_timeout` (one probe
    in flight at a time); a probe success closes, a probe failure
    re-opens. Transitions are logged and exported as metrics, and the
    open state is surfaced through /readyz (wired in main.py).
  * RetryBudget — token bucket shared by every retrying writer: retries
    spend a token, steady time refills them. When an outage burns the
    budget, writers fail fast instead of amplifying the storm.
  * GuardedKube — transparent proxy over a kube client (Fake or REST)
    that routes the MUTATING verbs (create/update/apply/delete) through
    exponential-backoff-with-jitter retries under the shared breaker +
    budget. Reads and watches pass straight through. Fault-injection
    points "kube.write" and "kube.watch" live here so chaos suites storm
    any backing client.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from ..utils import faults
from . import metrics
from .kube import Conflict, KubeError, NotFound
from .logging import logger

log = logger("resilience")

# server-side statuses worth retrying (429/5xx); code=None means a
# transport-level failure (connection refused, reset), also transient
RETRYABLE_CODES = (429, 500, 502, 503, 504)


class BreakerOpen(KubeError):
    """Write refused locally: the breaker is open (no API call made)."""

    def __init__(self, message: str):
        super().__init__(message, code=503)


class NotLeader(KubeError):
    """Write refused locally: this replica does not hold the leader
    lease (no API call made). Raised by a GuardedKube whose write_gate
    says no — a deposed leader's in-flight status writes abort here
    instead of racing the new leader's writes. Status writers treat it
    like a breaker refusal: return immediately, the next sweep/reconcile
    on the actual leader re-issues the write."""

    def __init__(self, message: str):
        super().__init__(message, code=409)


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, name: str = "kube-writes",
                 failure_threshold: int = 5,
                 reset_timeout: float = 30.0):
        self.name = name
        self.failure_threshold = max(1, failure_threshold)
        self.reset_timeout = reset_timeout
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._fails = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_claimed_at = 0.0
        metrics.report_breaker(name, self.CLOSED)

    # ------------------------------------------------------------- state

    @property
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    @property
    def is_open(self) -> bool:
        return self.state == self.OPEN

    def _tick(self) -> None:
        """open -> half-open once the reset timeout elapsed (lock held).

        Also expires a stale half-open probe LEASE: allow() hands out
        one probe slot, and the claimant is obligated to resolve it —
        but a claimant that dies without a verdict (its thread torn
        down mid-write, a BaseException skipping the caller's failure
        handling) would otherwise wedge the breaker in half-open with
        the slot held forever, refusing every write while the server
        may be perfectly healthy. A claim older than reset_timeout is
        treated as abandoned and the slot re-opens."""
        now = time.monotonic()
        if self._state == self.OPEN and \
                now - self._opened_at >= self.reset_timeout:
            self._transition(self.HALF_OPEN)
            self._probe_inflight = False
        elif self._state == self.HALF_OPEN and self._probe_inflight and \
                now - self._probe_claimed_at >= self.reset_timeout:
            log.info("circuit breaker %s: half-open probe lease expired; "
                     "releasing the slot" % self.name)
            self._probe_inflight = False

    def _transition(self, state: str) -> None:
        if state == self._state:
            return
        log.info("circuit breaker %s: %s -> %s"
                 % (self.name, self._state, state))
        self._state = state
        metrics.report_breaker(self.name, state)

    # ----------------------------------------------------------- calls

    def allow(self) -> bool:
        """May a write be attempted now? A True in half-open claims the
        single probe slot; the caller MUST follow with record_success or
        record_failure."""
        with self._lock:
            self._tick()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                self._probe_claimed_at = time.monotonic()
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._probe_inflight = False
            self._fails = 0
            if self._state != self.CLOSED:
                self._transition(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == self.HALF_OPEN:
                # probe failed: back to open for another reset period
                self._opened_at = time.monotonic()
                self._transition(self.OPEN)
                return
            self._fails += 1
            if self._state == self.CLOSED and \
                    self._fails >= self.failure_threshold:
                self._opened_at = time.monotonic()
                self._transition(self.OPEN)

    def abandon(self) -> None:
        """Release a claimed probe slot with NO health verdict.

        For callers cancelled before their write resolved
        (KeyboardInterrupt, SystemExit, executor teardown): the aborted
        attempt says nothing about the server, so the state machine and
        failure count stay untouched — half-open simply waits for the
        next real probe instead of wedging on the leaked slot."""
        with self._lock:
            self._probe_inflight = False


class RetryBudget:
    """Token bucket bounding RETRIES (first attempts are free): each
    retry spends one token; tokens refill at `refill_per_s`. A shared
    budget keeps a cluster-wide outage from turning into N independent
    exponential retry storms."""

    def __init__(self, budget: float = 10.0, refill_per_s: float = 1.0):
        self._cap = max(0.0, budget)
        self._tokens = self._cap
        self._refill = refill_per_s
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def try_spend(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self._cap,
                               self._tokens + (now - self._last)
                               * self._refill)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


def retry_call(fn: Callable, breaker: Optional[CircuitBreaker] = None,
               budget: Optional[RetryBudget] = None, attempts: int = 4,
               base: float = 0.05, cap: float = 2.0,
               verb: str = "write"):
    """Run `fn` with exponential-backoff-with-jitter retries on transient
    KubeErrors, under the breaker and retry budget. NotFound/Conflict are
    semantic outcomes, not faults: they re-raise immediately and count as
    the server being alive.

    The breaker sees ONE verdict per retry_call — allow() once up
    front, record_success/record_failure once at the end — so
    --kube-breaker-threshold counts failed WRITES (as documented), not
    attempts, and a half-open probe's own retries never trip over the
    probe slot they hold."""
    if breaker is not None and not breaker.allow():
        metrics.report_kube_write("breaker_open")
        raise BreakerOpen(f"kube {verb} refused: circuit open")
    last: Optional[KubeError] = None
    for attempt in range(max(1, attempts)):
        try:
            out = fn()
        except (NotFound, Conflict):
            if breaker is not None:
                breaker.record_success()
            raise
        except KubeError as e:
            retryable = e.code is None or e.code in RETRYABLE_CODES
            if not retryable:
                # deterministic client error (403 RBAC, 422 schema...):
                # the server ANSWERED — it must neither trip the shared
                # breaker (that would escalate a config mistake into a
                # serving outage) nor be retried
                if breaker is not None:
                    breaker.record_success()
                metrics.report_kube_write("failed")
                raise
            last = e
            if attempt + 1 >= max(1, attempts):
                if breaker is not None:
                    breaker.record_failure()
                metrics.report_kube_write("failed")
                raise
            if budget is not None and not budget.try_spend():
                if breaker is not None:
                    breaker.record_failure()
                metrics.report_kube_write("budget_exhausted")
                raise
            # full jitter on the exponential step: synchronized callers
            # must desynchronize, not re-collide every 2^k
            time.sleep(min(cap, base * (2 ** attempt))
                       * (0.5 + random.random()))
            continue
        except Exception:
            # non-KubeError garbage (e.g. an LB answering with HTML
            # that fails json.loads): count it as a failure so a
            # claimed half-open probe slot is ALWAYS released —
            # otherwise the breaker wedges with _probe_inflight stuck
            # and no write ever goes through again
            if breaker is not None:
                breaker.record_failure()
            metrics.report_kube_write("failed")
            raise
        except BaseException:
            # cancellation (KeyboardInterrupt, SystemExit, interpreter
            # teardown) skips `except Exception` — it is not a health
            # verdict either way, so release the probe slot with no
            # state transition instead of leaking it
            if breaker is not None:
                breaker.abandon()
            raise
        if breaker is not None:
            breaker.record_success()
        metrics.report_kube_write("retried_ok" if attempt else "ok")
        return out
    raise last  # unreachable; defensive


def guarded_status_update(kube, obj: dict, refresh: Callable,
                          attempts: int = 5) -> bool:
    """Shared status-write retry protocol for every controller/audit
    writer: NotFound and a breaker refusal return immediately (the next
    reconcile/sweep re-issues the write), Conflicts refresh via
    `refresh(obj) -> obj | None` and retry without sleeping, and other
    KubeErrors retry with backoff ONLY on an unguarded client — a
    resilience.GuardedKube already retried transients under the shared
    breaker/budget, and stacking loops would multiply to attempts^2 of
    synchronized hammering. Returns True when the write landed."""
    guarded = getattr(kube, "breaker", None) is not None
    for i in range(attempts):
        try:
            kube.update(obj, subresource="status")
            return True
        except NotFound:
            return False
        except (BreakerOpen, NotLeader):
            return False
        except Conflict:
            pass  # resourceVersion raced another writer: refresh below
        except KubeError:
            if guarded:
                return False
            time.sleep(0.01 * (2 ** i))
        obj = refresh(obj)
        if obj is None:
            return False
    return False


class GuardedKube:
    """Transparent kube proxy: mutating verbs ride retry_call under the
    shared breaker + budget; everything else (reads, watches, discovery,
    FakeKube extras like register_kind/calls) delegates untouched."""

    def __init__(self, inner, breaker: Optional[CircuitBreaker] = None,
                 budget: Optional[RetryBudget] = None, attempts: int = 4,
                 write_gate: Optional[Callable[[], bool]] = None):
        self.inner = inner
        self.breaker = breaker
        self.budget = budget
        self.attempts = attempts
        # leadership fence: when set and False, mutating verbs raise
        # NotLeader BEFORE any API call — a deposed leader's in-flight
        # status writes abort at the proxy instead of racing the new
        # leader (wired to LeaseElector.is_leader by Runtime)
        self.write_gate = write_gate

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _guard(self, verb: str, fn: Callable):
        if self.write_gate is not None and not self.write_gate():
            metrics.report_kube_write("not_leader")
            raise NotLeader(f"kube {verb} refused: not the leader")

        def call():
            try:
                faults.fire("kube.write", verb=verb)
            except faults.FaultError as e:
                raise KubeError(str(e), code=e.code(503)) from None
            return fn()

        return retry_call(call, breaker=self.breaker, budget=self.budget,
                          attempts=self.attempts, verb=verb)

    def create(self, obj: dict) -> dict:
        return self._guard("create", lambda: self.inner.create(obj))

    def update(self, obj: dict, subresource: str = "") -> dict:
        return self._guard("update",
                           lambda: self.inner.update(obj, subresource))

    def apply(self, obj: dict) -> dict:
        return self._guard("apply", lambda: self.inner.apply(obj))

    def delete(self, gvk, name: str, namespace: str = "") -> None:
        return self._guard("delete",
                           lambda: self.inner.delete(gvk, name, namespace))

    def watch(self, gvk, callback, send_initial: bool = True,
              resource_version: str = "", on_gap=None):
        try:
            faults.fire("kube.watch", gvk=tuple(gvk))
        except faults.FaultError as e:
            raise KubeError(str(e), code=e.code(500)) from None
        return self.inner.watch(gvk, callback, send_initial=send_initial,
                                resource_version=resource_version,
                                on_gap=on_gap)
