"""Admission webhooks: /v1/admit, /v1/admitlabel, and /v1/mutate.

Counterpart of the reference pkg/webhook/policy.go + namespacelabel.go +
mutation.go, with one structural change (BASELINE config #5): requests are
MICRO-BATCHED — handler threads enqueue reviews and a flusher thread ships
whole batches through the driver's vectorized review_batch, so admission
latency rides the batched evaluator instead of per-request interpretation.
The mutating webhook rides the same batcher: applicability for the whole
micro-batch is computed in one vectorized matcher sweep, then the host
applies the matched mutators to convergence and answers with an RFC-6902
JSONPatch (MutationHandler below).

Behavior parity:
  * self-service-account requests short-circuit to allow (policy.go:122-124)
  * DELETE reviews evaluate oldObject as object (policy.go:126-141)
  * gatekeeper's own resources are validated structurally (CreateCRD /
    ValidateConstraint), not policy-evaluated (policy.go:237-287)
  * the request namespace is fetched and sideloaded for namespaceSelector
    resolution (policy.go:310-317)
  * only `deny` enforcement produces deny messages; dryrun only logs
    (policy.go:194-217); --log-denies
  * per-(user, kind) tracing via the Config CRD (policy.go:290-309)
  * fail-open stance is deployment-level (failurePolicy: Ignore), so any
    internal error here returns allow with a warning status
"""

from __future__ import annotations

import base64
import json
import ssl
import threading
import time
from typing import Any, Callable, Optional

from ..client import Client
from ..target.handler import AugmentedReview
from ..utils import faults
from . import jsonio, metrics
from . import trace as gtrace
from .config_types import trace_enabled
from .kube import NotFound
from .logging import logger
from .util import DEFAULT_ENFORCEMENT_ACTION, validate_enforcement_action

log = logger("webhook")

TEMPLATE_GROUP = "templates.gatekeeper.sh"
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
IGNORE_LABEL = "admission.gatekeeper.sh/ignore"
SERVICE_ACCOUNT = "system:serviceaccount:gatekeeper-system:gatekeeper-admin"

# the API server defaults webhook timeoutSeconds to 10 and caps it at 30
DEFAULT_WEBHOOK_TIMEOUT_S = 10.0
MAX_WEBHOOK_TIMEOUT_S = 30.0


class AdmissionDeadline(TimeoutError):
    """The request's propagated deadline expired before a verdict."""


class AdmissionShed(Exception):
    """The request was refused at enqueue time (queue full / draining)."""


def go_duration_s(text: Optional[str]) -> Optional[float]:
    """Parse the API server's Go-duration webhook timeout ('5s', '30s',
    '500ms', '1m10s') or a bare float; None when absent/unparseable."""
    import re

    if not text:
        return None
    m = re.fullmatch(
        r"(?:(\d+)h)?(?:(\d+)m)?(?:(\d+(?:\.\d+)?)s)?(?:(\d+)ms)?", text)
    if m and any(m.groups()):
        h, mins, secs, ms = m.groups()
        return (int(h or 0) * 3600 + int(mins or 0) * 60
                + float(secs or 0) + int(ms or 0) / 1000.0)
    try:
        return float(text)
    except ValueError:
        return None


def route_path(path: str) -> Optional[str]:
    """One routing rule for every serving topology (in-process server,
    backplane engine, frontends): the admitlabel prefix must be checked
    BEFORE admit (shared prefix), and unknown paths are None."""
    if path.startswith("/v1/admitlabel"):
        return "admitlabel"
    if path.startswith("/v1/admit"):
        return "admit"
    if path.startswith("/v1/mutate"):
        return "mutate"
    if path.startswith("/v1/preview"):
        return "preview"
    if path.startswith("/v1/auditslice"):
        return "auditslice"
    return None


def parse_timeout_query(query: str) -> Optional[float]:
    """The webhook timeout from a request's URL query string.

    admission.k8s.io/v1 carries NO timeoutSeconds in the body — the API
    server conveys its budget only as `?timeout=5s`. Tolerates the wild:
    percent-encoded values, duplicate pairs (first parseable wins), bare
    keys, and malformed fragments never raise."""
    if not query:
        return None
    from urllib.parse import parse_qsl

    try:
        pairs = parse_qsl(query, keep_blank_values=True,
                          strict_parsing=False)
    except ValueError:  # pragma: no cover - parse_qsl is lenient
        return None
    for k, v in pairs:
        if k != "timeout":
            continue
        t = go_duration_s(v)
        if t is not None and t > 0:
            return t
    return None


def request_deadline(request: dict, default_s: float =
                     DEFAULT_WEBHOOK_TIMEOUT_S) -> float:
    """Absolute monotonic deadline for one AdmissionReview: the request's
    timeoutSeconds (defaulting like the API server does) minus a safety
    margin, so the verdict ships BEFORE the API server gives up and
    applies the deployed failurePolicy to a connection we already paid
    for."""
    t = request.get("timeoutSeconds")
    try:
        t = float(t) if t is not None else float(default_s)
    except (TypeError, ValueError):
        t = float(default_s)
    t = min(max(t, 0.5), MAX_WEBHOOK_TIMEOUT_S)
    margin = min(1.0, 0.2 * t)
    return time.monotonic() + t - margin


class _Pending:
    __slots__ = ("review", "done", "results", "error", "deadline",
                 "trace", "t_submit")

    def __init__(self, review: dict, deadline: float, trace=None):
        self.review = review
        self.done = threading.Event()
        self.results: list = []
        self.error: Optional[Exception] = None
        self.deadline = deadline
        # span context pinned to the entry: the flush stamps this
        # request's batch_seal (submit -> eval start) and evaluate
        # spans. None for unsampled requests — no span objects ride
        # the hot path.
        self.trace = trace
        self.t_submit = 0.0


class MicroBatcher:
    """Deadline-bounded admission batching: collect pending reviews for up
    to `max_wait`, flush them through driver.review_batch as one sweep.

    `evaluate` swaps the flush body: it receives the batch's review list
    and returns one outcome per review (an Exception instance fails just
    that request). The default evaluates violations through the driver;
    the mutation webhook passes MutationSystem.mutate_batch and rides
    the identical collector/flusher pipeline."""

    def __init__(self, opa: Optional[Client], max_wait: float = 0.005,
                 max_batch: int = 256,
                 target: str = "admission.k8s.gatekeeper.sh",
                 evaluate: Optional[Callable[[list], list]] = None,
                 max_queue: int = 0, plane: str = "admission"):
        self.opa = opa
        self.max_wait = max_wait
        self.max_batch = max_batch
        # which plane's batch-economics series this batcher feeds
        # (admission | mutation): the seal/fill attribution read must
        # not mix the two batchers' traffic shapes
        self.plane = plane
        # load-shed depth: beyond this many queued (unsealed) requests,
        # submit() refuses immediately with AdmissionShed instead of
        # queueing into certain deadline expiry. 0 = unbounded.
        self.max_queue = max_queue
        self.target = target
        self._evaluate = evaluate or self._evaluate_violations
        self._queue: list[_Pending] = []
        self._cv = threading.Condition()
        self._stop = threading.Event()
        # collector/flusher pipeline: a sealed batch evaluates while the
        # next one collects, so a request that just missed a batch waits
        # ~one flush instead of up to two
        self._sealed: list[list[_Pending]] = []
        self._scv = threading.Condition()
        # liveness heartbeats, one per loop (a live collector must not
        # mask a wedged flusher): healthy() flags a dead thread or work
        # pending with a stale beat so the k8s liveness probe restarts
        # the pod
        self.heartbeat = time.monotonic()    # collector
        self.fheartbeat = time.monotonic()   # flusher
        self._flushing = False
        self._thread = threading.Thread(target=self._loop, name="batcher",
                                        daemon=True)
        self._thread.start()
        self._fthread = threading.Thread(target=self._flush_loop,
                                         name="batcher-flush", daemon=True)
        self._fthread.start()
        self.batches = 0
        self.batched_requests = 0
        self.timeouts = 0
        self.shed = 0
        # total admitted-but-unanswered requests (queued + sealed +
        # flushing): the shed bound applies to THIS, not just the
        # unsealed queue — the collector seals regardless of flusher
        # backlog, so bounding the queue alone would let overload pile
        # up in _sealed instead
        self._pending = 0

    def set_knobs(self, max_wait: Optional[float] = None,
                  max_batch: Optional[int] = None,
                  max_queue: Optional[int] = None) -> dict:
        """Thread-safe live retuning (the adaptive controller's
        actuation surface, also replicated to engine children as a
        `knobs` control op). Values are sanity-clamped here — the
        controller's declared per-knob bounds are tighter, this floor
        only guards a garbage replication frame. Takes effect at the
        next collection window: the collector re-reads max_wait /
        max_batch at each window start, and the shed bound is
        consulted per enqueue. Returns the resulting values."""
        with self._cv:
            if max_wait is not None:
                self.max_wait = max(0.0, float(max_wait))
            if max_batch is not None:
                self.max_batch = max(1, int(max_batch))
            if max_queue is not None:
                self.max_queue = max(0, int(max_queue))
            self._cv.notify()
        return self.knob_values()

    def knob_values(self) -> dict:
        """The live knob set, in the `knobs` control-op wire shape."""
        return {"max_wait": self.max_wait, "max_batch": self.max_batch,
                "max_queue": self.max_queue}

    def submit_many(self, reviews: list, timeout: float = 60.0,
                    deadline: Optional[float] = None) -> list:
        """Bulk enqueue (streaming ingest): every review joins the
        queue under ONE lock pass and one collector wake-up, so a
        whole B-frame batch seals together instead of trickling in
        submit-by-submit. Returns one entry per review — the results
        list, or an AdmissionShed / AdmissionDeadline / evaluation
        Exception INSTANCE for that review (bulk callers need every
        verdict, so per-item failures never raise out)."""
        now = time.monotonic()
        dl = deadline if deadline is not None else now + timeout
        entries: list = []
        with self._cv:
            stopping = self._stop.is_set()
            for review in reviews:
                if stopping:
                    entries.append(AdmissionShed(
                        "admission batcher is shutting down"))
                    continue
                if self.max_queue and self._pending >= self.max_queue:
                    self.shed += 1
                    metrics.report_admission_shed()
                    entries.append(AdmissionShed(
                        f"admission queue full ({self.max_queue} "
                        "pending)"))
                    continue
                p = _Pending(review, dl)
                p.t_submit = now
                self._pending += 1
                self._queue.append(p)
                entries.append(p)
            if self._queue:
                self._cv.notify()
        outs: list = []
        for p in entries:
            if not isinstance(p, _Pending):
                outs.append(p)  # shed at enqueue
                continue
            if not p.done.wait(max(0.0, dl - time.monotonic())):
                with self._cv:
                    try:
                        self._queue.remove(p)
                        self._pending -= 1
                    except ValueError:
                        pass  # already sealed / mid-flush
                self.timeouts += 1
                metrics.report_batch_timeout()
                outs.append(AdmissionDeadline(
                    "admission deadline expired before the micro-batch "
                    "verdict"))
            elif p.error is not None:
                outs.append(p.error)
            else:
                outs.append(p.results)
        return outs

    def submit(self, review: dict, timeout: float = 60.0,
               deadline: Optional[float] = None, trace=None) -> list:
        """Enqueue and wait for the batched verdict. `deadline` is an
        absolute time.monotonic() instant (propagated from the request's
        timeoutSeconds); without one, `timeout` seconds from now. On
        expiry raises AdmissionDeadline; a full queue or a draining
        batcher raises AdmissionShed without queueing. `trace` (a
        sampled gtrace.Trace) is pinned to the queue entry so the flush
        stamps this request's batch spans."""
        now = time.monotonic()
        p = _Pending(review, deadline if deadline is not None
                     else now + timeout,
                     trace=trace if trace is not None
                     and trace.sampled else None)
        p.t_submit = now
        with self._cv:
            if self._stop.is_set():
                raise AdmissionShed("admission batcher is shutting down")
            if self.max_queue and self._pending >= self.max_queue:
                self.shed += 1
                metrics.report_admission_shed()
                raise AdmissionShed(
                    f"admission queue full ({self.max_queue} pending)")
            self._pending += 1
            self._queue.append(p)
            if len(self._queue) == 1 or len(self._queue) >= self.max_batch:
                # wake the collector only on the first enqueue (it sleeps
                # to the batch deadline anyway) or on a full batch — a
                # notify per submit makes it spin once per caller thread
                self._cv.notify()
        if not p.done.wait(max(0.0, p.deadline - time.monotonic())):
            # nobody will consume the result: drop the entry so a later
            # flush doesn't evaluate (and set results on) an abandoned
            # request; if it already sealed into a batch the flush's
            # done.set() is harmless — the waiter is gone either way
            with self._cv:
                try:
                    self._queue.remove(p)
                    self._pending -= 1  # sealed entries decrement at flush
                except ValueError:
                    pass  # already sealed / mid-flush
            self.timeouts += 1
            metrics.report_batch_timeout()
            raise AdmissionDeadline("admission deadline expired before "
                                    "the micro-batch verdict")
        if p.error is not None:
            raise p.error
        return p.results

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify()
        with self._scv:
            self._scv.notify()

    def drain(self, timeout: float = 10.0) -> bool:
        """Flush everything queued/sealed and wait for the in-flight
        evaluation (graceful shutdown: pending reviews get real verdicts
        instead of dropped sockets). True when fully drained.

        Drained == _pending hit zero: that counter only decrements
        AFTER a verdict is set (or a waiter gave up), so it covers the
        collector's queue->sealed handoff window that probing the two
        queues under their separate locks would race."""
        end = time.monotonic() + timeout
        with self._cv:
            self._cv.notify()
        while time.monotonic() < end:
            with self._cv:
                if self._pending == 0:
                    return True
            time.sleep(0.01)
        return False

    def pending(self) -> int:
        """Admitted-but-unanswered requests (queued + sealed +
        flushing): the depth the --admission-max-queue bound applies
        to, sampled by the saturation gauge probe."""
        with self._cv:
            return self._pending

    def healthy(self, max_stall: float = 30.0) -> bool:
        """Liveness: both pipeline threads alive, and — when a loop has
        work pending — that loop's heartbeat within `max_stall` (a
        flusher wedged in a hung evaluation stops beating while its
        backlog grows, even though the collector keeps running)."""
        if self._stop.is_set():
            return True  # stopped on purpose is not a liveness failure
        if not self._thread.is_alive() or not self._fthread.is_alive():
            return False
        now = time.monotonic()
        with self._cv:
            queued = bool(self._queue)
        with self._scv:
            fbusy = bool(self._sealed) or self._flushing
        if queued and now - self.heartbeat > max_stall:
            return False
        if fbusy and now - self.fheartbeat > max_stall:
            return False
        return True

    def _loop(self) -> None:
        while not self._stop.is_set():
            seal_reason = "drain"
            with self._cv:
                while not self._queue and not self._stop.is_set():
                    self.heartbeat = time.monotonic()
                    self._cv.wait(0.1)
                if self._stop.is_set():
                    batch = self._queue[:]
                    self._queue.clear()
                else:
                    self.heartbeat = time.monotonic()
                    # collection window bounded by BOTH the batch wait
                    # and the tightest member deadline: a batch carrying
                    # a 1s-timeout review must seal in time to evaluate
                    # and answer before that review expires
                    window_end = time.monotonic() + self.max_wait
                    tight = min(p.deadline for p in self._queue)
                    deadline = min(window_end, tight - self.max_wait)
                    while (len(self._queue) < self.max_batch
                           and time.monotonic() < deadline):
                        self._cv.wait(
                            max(0.0, deadline - time.monotonic()))
                    # tightest deadlines seal (and therefore flush)
                    # first; sort is stable, so arrival order holds
                    # within equal deadlines
                    self._queue.sort(key=lambda p: p.deadline)
                    batch = self._queue[: self.max_batch]
                    del self._queue[: len(batch)]
                    # what closed the window: full batch, a member's
                    # propagated deadline, or the wait elapsing — the
                    # seal-reason counter is how "edge-bound trickle"
                    # (max_wait at fill ~0) and "engine-bound" (full
                    # at fill 1.0) read off one scrape
                    if len(batch) >= self.max_batch:
                        seal_reason = "full"
                    elif deadline < window_end:
                        seal_reason = "deadline"
                    else:
                        seal_reason = "max_wait"
            if not batch:
                continue
            metrics.report_batch_seal(
                seal_reason, len(batch) / max(1, self.max_batch),
                plane=self.plane)
            with self._scv:
                self._sealed.append(batch)
                self._scv.notify()

    def _flush_loop(self) -> None:
        while True:
            with self._scv:
                while not self._sealed and not self._stop.is_set():
                    self.fheartbeat = time.monotonic()
                    self._scv.wait(0.1)
                if not self._sealed:
                    if self._stop.is_set():
                        return
                    continue
                batch = self._sealed.pop(0)
                self._flushing = True
            try:
                self._flush(batch)
            finally:
                with self._scv:
                    self._flushing = False
            self.fheartbeat = time.monotonic()

    def _flush(self, batch: list[_Pending]) -> None:
        self.batches += 1
        self.batched_requests += len(batch)
        t_eval0 = time.monotonic()
        try:
            # inside the try: a raise-mode flush fault must error THIS
            # batch (and release its _pending slots), not kill the
            # flusher thread and leak the count toward permanent shed
            faults.fire("webhook.flush")
            outs = self._evaluate([p.review for p in batch])
            t_eval1 = time.monotonic()
            for p, results in zip(batch, outs):
                if isinstance(results, Exception):
                    p.error = results
                else:
                    p.results = results
                if p.trace is not None:
                    self._stamp_spans(p, t_eval0, t_eval1)
                p.done.set()
        except Exception as e:
            t_eval1 = time.monotonic()
            for p in batch:
                p.error = e
                if p.trace is not None:
                    self._stamp_spans(p, t_eval0, t_eval1)
                p.done.set()
        finally:
            with self._cv:
                self._pending -= len(batch)

    @staticmethod
    def _stamp_spans(p: _Pending, t_eval0: float, t_eval1: float) -> None:
        """Batch spans for one sampled member: batch_seal (submit ->
        eval start: collection window + flusher backlog) and evaluate
        (the shared batched evaluation — the same interval for every
        co-batched member, which is exactly the attribution wanted:
        the request DID wait that long for its verdict)."""
        p.trace.add_span("batch_seal", p.t_submit, t_eval0)
        p.trace.add_span("evaluate", t_eval0, t_eval1)

    def _evaluate_violations(self, reviews: list[dict]) -> list:
        driver = self.opa.driver
        handler = self.opa.targets[self.target]
        if hasattr(driver, "review_batch"):
            try:
                outs = driver.review_batch(self.target, reviews)
            except Exception as e:
                # one bad review (or one bad template's eval) must not
                # take down every co-batched admission: isolate by
                # re-evaluating per review, failing only the culprits
                log.warning("batched evaluation failed; isolating per "
                            "review", details=str(e))
                outs = self._evaluate_per_review(driver, reviews)
        else:
            outs = self._evaluate_per_review(driver, reviews)
        for results in outs:
            if isinstance(results, Exception):
                continue
            for r in results:
                handler.handle_violation(r)
        return outs

    def _evaluate_per_review(self, driver, reviews: list[dict]) -> list:
        outs: list = []
        for review in reviews:
            try:
                resp = driver.query(("hooks", self.target, "violation"),
                                    {"review": review})
                outs.append(resp.results)
            except Exception as e:
                outs.append(e)
        return outs


def _envelope(admission_review: dict, response: dict) -> dict:
    """AdmissionReview response envelope. admission.k8s.io/v1 REQUIRES
    the response to echo the request's apiVersion/kind (the v1beta1 API
    server tolerated their absence); both are echoed verbatim with the
    legacy defaults for envelope-free callers."""
    return {
        "apiVersion": admission_review.get("apiVersion")
        or "admission.k8s.io/v1beta1",
        "kind": admission_review.get("kind") or "AdmissionReview",
        "response": response,
    }


# --------------------------------------------------- response encoding

# uid charset the API server actually emits (UUIDs); anything outside it
# takes the full-encoder fallback rather than a hand-rolled escape
_UID_SAFE = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789-_.:")
_ENVELOPE_PREFIXES: dict = {}


def encode_envelope(envelope: dict) -> bytes:
    """Serialize an AdmissionReview response envelope.

    The overwhelmingly common response is a bare allow; its envelope is
    PRESERIALIZED per (apiVersion, kind) and patched with the uid, so
    the hot path is two bytes-joins instead of a full JSON encode. A
    response carrying a status message rides a fragment splice (the
    message is the only part needing real escaping); anything else —
    patches, warnings — falls back to the full encoder."""
    resp = envelope.get("response")
    if isinstance(resp, dict):
        uid = resp.get("uid") or ""
        if isinstance(uid, str) and _UID_SAFE.issuperset(uid):
            keys = set(resp)
            if keys <= {"uid", "allowed"} and resp.get("allowed") is True:
                return (_envelope_prefix(envelope) + uid.encode()
                        + b'","allowed":true}}')
            if keys == {"uid", "allowed", "status"} and \
                    isinstance(resp.get("status"), dict):
                return (_envelope_prefix(envelope) + uid.encode()
                        + b'","allowed":'
                        + (b"true" if resp.get("allowed") else b"false")
                        + b',"status":'
                        + jsonio.dumps_bytes(resp["status"]) + b"}}")
    return jsonio.dumps_bytes(envelope)


def _envelope_prefix(envelope: dict) -> bytes:
    key = (envelope.get("apiVersion"), envelope.get("kind"))
    prefix = _ENVELOPE_PREFIXES.get(key)
    if prefix is None:
        prefix = (b'{"apiVersion":' + jsonio.dumps_bytes(key[0])
                  + b',"kind":' + jsonio.dumps_bytes(key[1])
                  + b',"response":{"uid":"')
        if len(_ENVELOPE_PREFIXES) < 64:  # callers send ~2 shapes ever
            _ENVELOPE_PREFIXES[key] = prefix
    return prefix


def verdict_response(pairs) -> dict:
    """The single authority for mapping (enforcement_action, msg)
    violation pairs to an AdmissionReview response body. Every
    consumer of evaluation results — `/v1/admit`, the bulk paths, the
    offline fleet scan — builds its verdict here, so a scan verdict is
    bit-equal to what admission would have answered for the same
    object."""
    denies = []
    warns = []
    for action, msg in pairs:
        if action == "deny":
            denies.append(msg)
        elif action == "warn":
            warns.append(msg)
    if denies:
        response = {"allowed": False,
                    "status": {"code": 403,
                               "reason": "; ".join(sorted(denies))}}
    else:
        response = {"allowed": True}
    if warns:
        response["warnings"] = sorted(warns)
    return response


# ----------------------------------------------------- decision cache


class DecisionCache:
    """Generation-keyed LRU over admission verdicts.

    Key = (canonical request hash, library generation, namespace-label
    hash). Identical retries and DaemonSet-style object storms (the same
    pod spec admitted once per node) skip evaluation entirely; any
    template/constraint/synced-data change bumps the client generation,
    so every stale entry misses and ages out — there is no explicit
    invalidation path to get wrong. Namespace label edits flip the
    namespace hash the same way."""

    def __init__(self, size: int = 4096):
        from collections import OrderedDict

        self.size = size
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def request_key(request: dict) -> bytes:
        """Canonical hash of the verdict-relevant request fields: uid is
        per-attempt noise and timeoutSeconds is a transport budget —
        neither can change the decision."""
        import hashlib

        slim = {k: v for k, v in request.items()
                if k not in ("uid", "timeoutSeconds")}
        return hashlib.blake2b(jsonio.canonical_bytes(slim),
                               digest_size=16).digest()

    @staticmethod
    def ns_key(ns_obj: Optional[dict]) -> bytes:
        """Hash of the WHOLE sideloaded namespace object: policies can
        key on annotations or any other namespace field (the full
        object rides the review), so labels alone would serve stale
        verdicts across non-label namespace edits."""
        if not ns_obj:
            return b""
        import hashlib

        return hashlib.blake2b(jsonio.canonical_bytes(ns_obj),
                               digest_size=16).digest()

    def get(self, key: tuple) -> Optional[dict]:
        with self._lock:
            resp = self._entries.get(key)
            if resp is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return resp

    def put(self, key: tuple, response: dict) -> None:
        with self._lock:
            self._entries[key] = response
            self._entries.move_to_end(key)
            while len(self._entries) > self.size:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


class NeedsEvaluation(Exception):
    """Raised inside a fast=True handle(): the verdict is not in the
    decision cache, so answering requires the (blocking) micro-batch
    path — the caller re-dispatches to a worker thread."""


class ValidationHandler:
    """The /v1/admit logic, transport-independent.

    fail_closed flips the internal-error stance: the deployed
    failurePolicy is Ignore (fail-open) and the default matches it, but
    a cluster that prefers blocking to unvalidated admission runs
    --fail-closed and errors become denies. Either way the decision is
    reported to metrics as status="error", not "allow"."""

    def __init__(self, opa: Client, kube=None,
                 batcher: Optional[MicroBatcher] = None,
                 log_denies: bool = False,
                 validate_enforcement: bool = True,
                 traces_provider=None,
                 fail_closed: bool = False,
                 default_timeout: float = DEFAULT_WEBHOOK_TIMEOUT_S,
                 decision_cache_size: int = 4096,
                 ladder=None):
        self.opa = opa
        self.kube = kube
        self.batcher = batcher or MicroBatcher(opa)
        self.log_denies = log_denies
        self.validate_enforcement = validate_enforcement
        self.traces_provider = traces_provider or (lambda: [])
        self.fail_closed = fail_closed
        self.default_timeout = default_timeout
        self.cache = (DecisionCache(decision_cache_size)
                      if decision_cache_size > 0 else None)
        # degradation ladder (control/adaptive.py DegradationLadder,
        # duck-typed: anything with an int `.rung`). Rung >= 2 serves
        # cache hits + short-circuits only (misses shed per the
        # failure stance); rung >= 3 answers every non-exempt request
        # per the stance immediately. None = never degraded.
        self.ladder = ladder

    def handle(self, admission_review: dict,
               deadline: Optional[float] = None,
               fast: bool = False,
               trace=gtrace.NOOP) -> Optional[dict]:
        """`deadline` (absolute monotonic) overrides the one derived
        from the request body — the backplane engine pins it at frame
        receipt so queueing ahead of this call spends the request's
        budget, not a fresh one.

        fast=True answers ONLY when no blocking work is needed (the
        short-circuits and decision-cache hits); a request that would
        have to evaluate returns None instead, and the caller re-issues
        handle() from a thread that may block. The backplane engine
        serves cache hits inline in its frame-reader thread this way —
        no thread handoff on the hot path.

        `trace` is the request's span context (gtrace.NOOP when
        unsampled): batch spans are stamped through the batcher entry,
        and the OUTCOME — allow/deny/shed/timeout/error — lands on the
        trace either way, so shed storms are diagnosable from the
        flight recorder after the fact."""
        t0 = time.monotonic()
        request = admission_review.get("request") or {}
        if deadline is None:
            deadline = request_deadline(request, self.default_timeout)
        try:
            response = self._decide(request, deadline, fast=fast,
                                    trace=trace)
        except NeedsEvaluation:
            return None
        except Exception as e:
            return self._failure(admission_review, request, e, t0,
                                 trace)
        return self._complete(admission_review, request, response, t0,
                              trace)

    def handle_bulk(self, reviews: list, deadline: float) -> list:
        """STREAMING ingest: many pre-parsed AdmissionReviews in, one
        response envelope (dict) per review out, in order — the
        backplane B-frame path for CI scanners and bulk authorizers.

        One prelude pass per review (short-circuits, decision cache,
        target mapping), then everything that needs evaluation joins
        the shared MicroBatcher in ONE submit_many enqueue, so a bulk
        batch seals together with whatever the HTTP frontends have in
        flight. Per-review failures map to the failure stance exactly
        as on the HTTP path; this method never raises per review."""
        outs: list = [None] * len(reviews)
        pend: list = []
        for i, ar in enumerate(reviews):
            if not isinstance(ar, dict):
                ar = {}
            t0 = time.monotonic()
            request = ar.get("request") or {}
            try:
                pre = self._prelude(request)
            except Exception as e:
                outs[i] = self._failure(ar, request, e, t0)
                continue
            if pre.response is not None:
                outs[i] = self._complete(ar, request, pre.response, t0)
            elif pre.want_trace:
                # traced requests keep their per-request path
                outs[i] = self.handle(ar, deadline=deadline)
            else:
                pend.append((i, ar, request, pre, t0))
        if pend:
            results = self.batcher.submit_many(
                [entry[3].gk_review for entry in pend],
                deadline=deadline)
            for (i, ar, request, pre, t0), res in zip(pend, results):
                if isinstance(res, Exception):
                    outs[i] = self._failure(ar, request, res, t0)
                    continue
                try:
                    response = self._finish(request, pre, res)
                    outs[i] = self._complete(ar, request, response, t0)
                except Exception as e:
                    outs[i] = self._failure(ar, request, e, t0)
        return outs

    # outcome mapping shared by handle() and handle_bulk() ------------

    def _failure(self, admission_review: dict, request: dict, e,
                 t0: float, trace=gtrace.NOOP) -> dict:
        if isinstance(e, AdmissionShed):
            status, code = "shed", 429
        elif isinstance(e, AdmissionDeadline):
            # answer per the failure stance BEFORE the API server's own
            # timeout fires — the caller gets our verdict, not a
            # connection error it has to map through failurePolicy
            status, code = "timeout", 504
        else:
            log.error("admission error", details=str(e))
            status, code = "error", 500
        response = {"allowed": not self.fail_closed,
                    "status": {"code": code, "message": str(e)}}
        return self._complete(admission_review, request, response, t0,
                              trace, status=status)

    def _complete(self, admission_review: dict, request: dict,
                  response: dict, t0: float, trace=gtrace.NOOP,
                  status: Optional[str] = None) -> dict:
        if status is None:
            status = "allow" if response.get("allowed") else "deny"
        metrics.report_request(status, time.monotonic() - t0)
        trace.set_status(status)
        response["uid"] = request.get("uid") or ""
        return _envelope(admission_review, response)

    # decision pipeline: prelude -> evaluate -> finish ----------------

    class _Prelim:
        __slots__ = ("response", "gk_review", "cache_key", "want_trace",
                     "want_dump", "ns_obj", "review")

        def __init__(self):
            self.response = None
            self.gk_review = None
            self.cache_key = None
            self.want_trace = False
            self.want_dump = False
            self.ns_obj = None
            self.review = None

    def _decide(self, request: dict,
                deadline: Optional[float] = None,
                fast: bool = False, trace=gtrace.NOOP) -> dict:
        pre = self._prelude(request, fast=fast, trace=trace)
        if pre.response is not None:
            return pre.response
        if pre.want_trace:
            # traced requests bypass the batcher: the trace is per-request
            # (reference policy.go:290-309)
            resps = self.opa.review(AugmentedReview(pre.review,
                                                    pre.ns_obj),
                                    tracing=True)
            for name, resp in sorted(resps.by_target.items()):
                log.info("request trace", target=name,
                         trace=resp.trace_dump())
            if pre.want_dump:
                log.info("state dump", dump=self.opa.dump())
            results = resps.results()
        else:
            results = self.batcher.submit(pre.gk_review,
                                          deadline=deadline,
                                          trace=trace)
        return self._finish(request, pre, results)

    def _prelude(self, request: dict, fast: bool = False,
                 trace=gtrace.NOOP) -> "_Prelim":
        """Everything before (possibly blocking) evaluation: short-
        circuits, gatekeeper-resource validation, DELETE mapping, the
        namespace sideload, target mapping, and the decision cache.
        Either `.response` is the finished verdict or `.gk_review` is
        ready for the batcher."""
        pre = self._Prelim()
        username = (request.get("userInfo") or {}).get("username")
        t_dec0 = time.monotonic() if trace.sampled else 0.0
        if username == SERVICE_ACCOUNT:
            pre.response = {"allowed": True}
            return pre
        rung = self.ladder.rung if self.ladder is not None else 0
        if rung >= 3:
            # fail-stance rung: the plane is past the point where
            # evaluating (or even consulting the cache) helps —
            # answer per the configured failure stance immediately.
            # Raising (not returning a response) routes through
            # _failure, so status=shed accounting and the stance
            # mapping stay on the one shared path.
            raise AdmissionShed(
                "degraded (fail_stance): admission answered per "
                "failure stance without evaluation")
        kind = request.get("kind") or {}
        group = kind.get("group") or ""
        if group in (TEMPLATE_GROUP, CONSTRAINT_GROUP):
            pre.response = self._validate_gatekeeper_resource(request,
                                                              group)
            return pre
        review = dict(request)
        if (request.get("operation") == "DELETE"
                and not request.get("object")
                and request.get("oldObject") is not None):
            # evaluate what is being deleted (policy.go:126-141)
            review["object"] = request.get("oldObject")
        pre.review = review
        ns_name = request.get("namespace")
        if ns_name and self.kube is not None:
            if fast:
                # the namespace fetch may hit the API server: not a
                # fast-path operation (a future informer cache would
                # lift this)
                raise NeedsEvaluation()
            try:
                pre.ns_obj = self.kube.get(("", "v1", "Namespace"),
                                           ns_name)
            except NotFound:
                pre.ns_obj = None
        handled, gk_review = self.opa.targets[
            "admission.k8s.gatekeeper.sh"].handle_review(
                AugmentedReview(review, pre.ns_obj))
        if not handled:
            pre.response = {"allowed": True}
            return pre
        pre.gk_review = gk_review
        pre.want_trace, pre.want_dump = trace_enabled(
            self.traces_provider(), username,
            (group, kind.get("version") or "", kind.get("kind") or ""))
        if self.cache is not None and not pre.want_trace:
            # generation read BEFORE evaluation: a library update racing
            # the eval stores the old verdict under the old generation,
            # which no future lookup consults
            pre.cache_key = (DecisionCache.request_key(request),
                             self.opa.generation,
                             DecisionCache.ns_key(pre.ns_obj))
            cached = self.cache.get(pre.cache_key)
            if cached is not None and (cached.get("allowed")
                                       or not self.log_denies):
                metrics.report_decision_cache("hit")
                if trace.sampled:
                    trace.add_span("cache_hit", t_dec0,
                                   time.monotonic())
                # shallow copy: the caller patches uid into the response
                pre.response = dict(cached)
                return pre
            if rung >= 2:
                # cache-only rung: hits (above) still serve at full
                # speed; a miss would need evaluation the degraded
                # plane is protecting — shed it, on the fast path too
                # (a shed needs no blocking work)
                raise AdmissionShed(
                    "degraded (cache_only): decision-cache miss shed "
                    "without evaluation")
            if fast:
                raise NeedsEvaluation()  # miss reported by the re-issue
            metrics.report_decision_cache("miss")
        elif self.cache is not None:
            if rung >= 2:
                raise AdmissionShed(
                    "degraded (cache_only): uncacheable request shed "
                    "without evaluation")
            if fast:
                raise NeedsEvaluation()
            metrics.report_decision_cache("bypass")
        if rung >= 2:
            raise AdmissionShed(
                "degraded (cache_only): evaluation path disabled")
        if fast:
            raise NeedsEvaluation()  # cache disabled: evaluation ahead
        return pre

    def _finish(self, request: dict, pre: "_Prelim",
                results: list) -> dict:
        username = (request.get("userInfo") or {}).get("username")
        if self.log_denies:
            for r in results:
                log.info(
                    "violation",
                    event_type="violation",
                    constraint_name=(r.constraint or {}).get(
                        "metadata", {}).get("name"),
                    constraint_kind=(r.constraint or {}).get("kind"),
                    constraint_action=r.enforcement_action,
                    resource_namespace=request.get("namespace"),
                    resource_name=request.get("name"),
                    request_username=username,
                    details=r.msg,
                )
        # enforcementAction: warn (reference policy.go:194-217 line):
        # the verdict stays allowed and the violation rides the
        # AdmissionReview warnings field, which kubectl surfaces as a
        # client-side Warning header — verdict_response owns the
        # mapping
        response = verdict_response(
            (r.enforcement_action, r.msg) for r in results)
        if pre.cache_key is not None and (not self.log_denies
                                          or not results):
            # under --log-denies a cached answer must not swallow audit
            # log lines: only violation-FREE responses are cached (deny,
            # warn, and dryrun results all log per request)
            self.cache.put(pre.cache_key, dict(response))
        return response

    def _validate_gatekeeper_resource(self, request: dict,
                                      group: str) -> dict:
        if request.get("operation") == "DELETE":
            return {"allowed": True}
        obj = request.get("object") or {}
        try:
            if group == TEMPLATE_GROUP:
                self.opa.create_crd(obj)
            else:
                action = (obj.get("spec") or {}).get("enforcementAction") \
                    or DEFAULT_ENFORCEMENT_ACTION
                if self.validate_enforcement:
                    validate_enforcement_action(action)
                self.opa.validate_constraint(obj)
        except Exception as e:
            return {"allowed": False,
                    "status": {"code": 422, "reason": str(e)}}
        return {"allowed": True}


class NamespaceLabelHandler:
    """The /v1/admitlabel logic (namespacelabel.go:63-87): only exempt
    namespaces may carry the ignore label."""

    def __init__(self, exempt_namespaces: tuple = ()):
        self.exempt = set(exempt_namespaces)

    def handle(self, admission_review: dict) -> dict:
        request = admission_review.get("request") or {}
        uid = request.get("uid") or ""
        obj = request.get("object") or {}
        name = (obj.get("metadata") or {}).get("name") or request.get("name")
        labels = (obj.get("metadata") or {}).get("labels") or {}
        allowed = True
        reason = ""
        if IGNORE_LABEL in labels and name not in self.exempt:
            allowed = False
            reason = (f"Only exempt namespaces may have the {IGNORE_LABEL} "
                      "label")
        response: dict[str, Any] = {"uid": uid, "allowed": allowed}
        if not allowed:
            response["status"] = {"code": 403, "reason": reason}
        return _envelope(admission_review, response)


class MutationHandler:
    """The /v1/mutate logic (reference pkg/webhook/mutation.go),
    transport-independent.

    Rides the same MicroBatcher as validation: handler threads enqueue
    gk-reviews; the flusher ships the whole batch through
    MutationSystem.mutate_batch, which computes applicability for the
    entire micro-batch in ONE vectorized matcher sweep (the same
    signature-grouped path the validation mask uses) and then applies
    each review's matched mutators on the host, pass after pass, to
    convergence. The response is an RFC-6902 JSONPatch (base64, as the
    API server expects) or a plain allow when nothing changed."""

    def __init__(self, system, kube=None,
                 batcher: Optional[MicroBatcher] = None,
                 fail_closed: bool = False,
                 batch_max_wait: float = 0.005,
                 max_queue: int = 0,
                 default_timeout: float = DEFAULT_WEBHOOK_TIMEOUT_S):
        self.system = system
        self.kube = kube
        self.batcher = batcher or MicroBatcher(
            None, max_wait=batch_max_wait, evaluate=self._evaluate_batch,
            max_queue=max_queue, plane="mutation")
        self.fail_closed = fail_closed
        self.default_timeout = default_timeout

    def _lookup_namespace(self, name: str):
        if self.kube is None:
            return None
        try:
            return self.kube.get(("", "v1", "Namespace"), name)
        except NotFound:
            return None

    def _evaluate_batch(self, reviews: list[dict]) -> list:
        return self.system.mutate_batch(reviews, self._lookup_namespace)

    def handle(self, admission_review: dict,
               deadline: Optional[float] = None,
               trace=gtrace.NOOP) -> dict:
        t0 = time.monotonic()
        request = admission_review.get("request") or {}
        uid = request.get("uid") or ""
        if deadline is None:
            deadline = request_deadline(request, self.default_timeout)
        status = "allow"
        try:
            response = self._decide(request, deadline, trace=trace)
        except AdmissionShed as e:
            status = "shed"
            response = {"allowed": not self.fail_closed,
                        "status": {"code": 429, "message": str(e)}}
        except AdmissionDeadline as e:
            status = "timeout"
            response = {"allowed": not self.fail_closed,
                        "status": {"code": 504, "message": str(e)}}
        except Exception as e:
            log.error("mutation error", details=str(e))
            status = "error"
            response = {"allowed": not self.fail_closed,
                        "status": {"code": 500, "message": str(e)}}
        metrics.report_mutation_request(status, time.monotonic() - t0)
        trace.set_status(status)
        response["uid"] = uid
        return _envelope(admission_review, response)

    def _decide(self, request: dict,
                deadline: Optional[float] = None,
                trace=gtrace.NOOP) -> dict:
        username = (request.get("userInfo") or {}).get("username")
        if username == SERVICE_ACCOUNT:
            return {"allowed": True}
        kind = request.get("kind") or {}
        if (kind.get("group") or "") in (TEMPLATE_GROUP, CONSTRAINT_GROUP,
                                         "mutations.gatekeeper.sh"):
            # gatekeeper's own resources are never mutated
            return {"allowed": True}
        obj = request.get("object")
        if not isinstance(obj, dict):
            return {"allowed": True}  # DELETE / subresource: nothing to patch
        if not self.system.active():
            # empty (or fully quarantined) mutator library: don't pay the
            # micro-batch wait — the MWC matches the whole cluster, so
            # this is the hot path until mutators are installed
            return {"allowed": True}
        # no per-request namespace prefetch: the batched matcher resolves
        # namespaces through _lookup_namespace only for mutators whose
        # match actually needs them (once per projection group, not per
        # request)
        mutated = self.batcher.submit(dict(request), deadline=deadline,
                                      trace=trace)
        if mutated is None:
            return {"allowed": True}
        from ..mutation.patch import json_patch

        patch = json_patch(obj, mutated)
        if not patch:
            return {"allowed": True}
        return {
            "allowed": True,
            "patchType": "JSONPatch",
            "patch": base64.b64encode(
                json.dumps(patch).encode()).decode(),
        }


# -------------------------------------------------- fast HTTP transport

_HTTP_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                 405: "Method Not Allowed", 500: "Internal Server Error",
                 503: "Service Unavailable"}


class FastHTTPServer:
    """Minimal threaded HTTP/1.1 POST server for the admission hot path.

    `BaseHTTPRequestHandler` costs ~1ms per request at webhook payload
    sizes (email-module header parsing, per-header writes, logging
    plumbing) — more than the whole admission decision. This hand-rolled
    loop parses the request line + the three headers that matter
    (Content-Length / Transfer-Encoding / Connection, plus a 100-
    continue Expect), reads the body, and answers with ONE sendall.
    Keep-alive by default (HTTP/1.1 semantics; Connection: close and
    HTTP/1.0 honored), TLS via the wrapped listening socket, an idle
    timeout so silent clients cannot pin threads forever, and in-flight
    accounting for the graceful-shutdown drain.

    `dispatch(path, body) -> (status, payload_bytes)` is the entire
    application surface."""

    def __init__(self, addr: tuple, dispatch, reuse_port: bool = False,
                 certfile: Optional[str] = None,
                 keyfile: Optional[str] = None,
                 idle_timeout: float = 60.0):
        import socket as _socket
        import socketserver

        outer = self
        self.dispatch = dispatch
        self.idle_timeout = idle_timeout
        self._inflight = 0
        self._inflight_lock = threading.Lock()

        class _Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True
            request_queue_size = 128

            def server_bind(self):
                if reuse_port:
                    self.socket.setsockopt(_socket.SOL_SOCKET,
                                           _socket.SO_REUSEPORT, 1)
                super().server_bind()

            def finish_request(self, request, client_address):
                outer._serve_connection(request)

            def handle_error(self, request, client_address):
                # keep-alive clients dropping a connection mid-request
                # (reset, broken pipe, idle timeout, TLS teardown) are
                # routine — one log line, not a traceback
                import sys as _sys
                exc = _sys.exc_info()[1]
                if isinstance(exc, (ConnectionError, TimeoutError,
                                    OSError, ssl.SSLError)):
                    log.info("client connection dropped",
                             details=str(exc))
                    return
                super().handle_error(request, client_address)

        self.server = _Server(addr, None)
        if certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile, keyfile)
            self.server.socket = ctx.wrap_socket(self.server.socket,
                                                 server_side=True)
        self.port = self.server.server_address[1]

    # one thread per connection; requests loop here until close
    def _serve_connection(self, conn) -> None:
        import socket as _socket

        try:
            conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except OSError:
            pass
        conn.settimeout(self.idle_timeout)
        rfile = conn.makefile("rb", 65536)
        try:
            while True:
                line = rfile.readline(65537)
                if not line:
                    return
                if line in (b"\r\n", b"\n"):
                    continue  # stray CRLF between pipelined requests
                try:
                    method, path, version = line.split(None, 2)
                except ValueError:
                    self._respond(conn, 400, b"", close=True)
                    return
                close_after = not version.strip().endswith(b"1.1")
                clen = 0
                chunked = False
                traceparent = None
                while True:
                    h = rfile.readline(65537)
                    if h in (b"\r\n", b"\n", b""):
                        break
                    key, _, value = h.partition(b":")
                    key = key.strip().lower()
                    value = value.strip()
                    if key == b"content-length":
                        try:
                            clen = int(value)
                        except ValueError:
                            clen = 0
                    elif key == b"transfer-encoding":
                        chunked = b"chunked" in value.lower()
                    elif key == b"traceparent":
                        # the one tracing header that matters: a W3C
                        # span context from the caller joins our trace
                        traceparent = value.decode("latin-1")
                    elif key == b"connection":
                        v = value.lower()
                        if b"close" in v:
                            close_after = True
                        elif b"keep-alive" in v:
                            close_after = False
                    elif key == b"expect" and \
                            value.lower().startswith(b"100-"):
                        conn.sendall(b"HTTP/1.1 100 Continue\r\n\r\n")
                body = (self._read_chunked(rfile) if chunked
                        else (rfile.read(clen) if clen > 0 else b""))
                if method != b"POST":
                    self._respond(conn, 405, b"", close_after)
                    if close_after:
                        return
                    continue
                # in-flight accounting for the graceful-shutdown drain:
                # idle keep-alive connections do NOT count (the thread
                # parks on readline between requests)
                with self._inflight_lock:
                    self._inflight += 1
                extra_headers = None
                try:
                    out = self.dispatch(path.decode("latin-1"), body,
                                        traceparent)
                    # dispatch returns (status, payload) or (status,
                    # payload, extra_headers) — the tracing path adds
                    # X-Trace-Id without taxing the untraced one
                    if len(out) == 3:
                        status, payload, extra_headers = out
                    else:
                        status, payload = out
                except Exception as e:  # a dispatch bug must still
                    # ANSWER (zero unanswered admissions), not drop the
                    # socket and leave the API server to its timeout
                    log.error("dispatch error", details=str(e))
                    status, payload = 500, b""
                finally:
                    with self._inflight_lock:
                        self._inflight -= 1
                self._respond(conn, status, payload, close_after,
                              extra_headers)
                if close_after:
                    return
        except (ConnectionError, TimeoutError, OSError, ssl.SSLError):
            return  # routine client teardown
        finally:
            try:
                rfile.close()
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _read_chunked(rfile) -> bytes:
        # minimal RFC 7230 §4.1 decoder (the API server normally sends
        # Content-Length; this keeps chunked senders working)
        out = bytearray()
        while True:
            size_line = rfile.readline(65537)
            if not size_line:
                raise ConnectionError("EOF inside chunked body")
            size = int(size_line.split(b";", 1)[0].strip() or b"0", 16)
            if size == 0:
                while rfile.readline(65537) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return bytes(out)
            out += rfile.read(size)
            rfile.readline(65537)  # chunk-terminating CRLF

    @staticmethod
    def _respond(conn, status: int, payload: bytes,
                 close: bool = False,
                 extra_headers: Optional[dict] = None) -> None:
        extra = ""
        if extra_headers:
            extra = "".join(f"{k}: {v}\r\n"
                            for k, v in extra_headers.items())
        head = ("HTTP/1.1 %d %s\r\n"
                "Content-Type: application/json\r\n"
                "Content-Length: %d\r\n%s%s\r\n"
                % (status, _HTTP_REASONS.get(status, "OK"), len(payload),
                   extra, "Connection: close\r\n" if close else ""))
        release = getattr(payload, "release", None)
        if release is None:
            conn.sendall(head.encode("ascii") + payload)
            return
        # reply-ring payload (control/shm.RingSlice): vectored write
        # straight from the shared segment, then release the slot back
        # to the engine's allocator — even when the client vanished
        try:
            mv = payload.mv
            try:
                # ssl.SSLSocket raises NotImplementedError (not
                # AttributeError) for sendmsg — TLS copies into its
                # encryption buffer anyway, so concat there
                sent = conn.sendmsg((head.encode("ascii"), mv))
            except (AttributeError, NotImplementedError):
                conn.sendall(head.encode("ascii") + bytes(mv))
                return
            total = len(head) + len(mv)
            if sent < total:
                conn.sendall(
                    memoryview(head.encode("ascii") + bytes(mv))[sent:])
        finally:
            release()

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    # socketserver API passthrough (bench/tests drive these directly)
    def serve_forever(self) -> None:
        self.server.serve_forever()

    def shutdown(self) -> None:
        self.server.shutdown()

    def server_close(self) -> None:
        self.server.server_close()


class WebhookServer:
    """HTTPS transport over the handlers (FastHTTPServer dispatch)."""

    def __init__(self, validation: Optional[ValidationHandler],
                 ns_label: Optional[NamespaceLabelHandler],
                 port: int = 8443, certfile: Optional[str] = None,
                 keyfile: Optional[str] = None, addr: str = "",
                 reuse_port: bool = False,
                 mutation: Optional[MutationHandler] = None,
                 preview=None):
        """reuse_port: bind with SO_REUSEPORT so multiple serving
        PROCESSES share one port (the kernel load-balances accepts) —
        the single-process Python frontend is GIL-bound, and this is
        how one node runs N webhook workers without a proxy.

        `preview` (a control.preview.PreviewEngine) serves the what-if
        /v1/preview endpoint when given."""
        self.validation = validation
        self.ns_label = ns_label
        self.mutation = mutation
        self.preview = preview
        self.http = FastHTTPServer((addr, port), self._dispatch,
                                   reuse_port=reuse_port,
                                   certfile=certfile, keyfile=keyfile)
        self.server = self.http.server  # legacy handle (bench/tests)
        self.port = self.http.port
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        name="webhook", daemon=True)

    def _dispatch(self, path: str, body: bytes,
                  traceparent: Optional[str] = None) -> tuple:
        tr = gtrace.TRACER.start(gtrace.ADMISSION, traceparent)
        t_parse0 = time.monotonic() if tr.sampled else 0.0
        try:
            review = jsonio.loads(body)
        except ValueError:
            tr.set_status("bad_request")
            tr.finish()
            return 400, b""
        if tr.sampled:
            tr.add_span("frontend_parse", t_parse0, time.monotonic())
        # admission.k8s.io/v1 carries NO timeoutSeconds in the request
        # body — a real API server conveys its webhook timeout only as
        # the ?timeout=5s URL query. Fold it into the request so
        # deadline propagation sees the REAL budget (a body field, e.g.
        # from tests or direct callers, wins)
        request = (review or {}).get("request") \
            if isinstance(review, dict) else None
        if isinstance(request, dict) and "timeoutSeconds" not in request:
            t = parse_timeout_query(path.partition("?")[2])
            if t is not None:
                request["timeoutSeconds"] = t
        # un-served endpoints 404 (an operation not requested must not
        # answer admission decisions for it)
        route = route_path(path)
        # the trace kwarg rides only on sampled requests: unsampled
        # calls stay signature-identical for handler stubs/embedders
        kw = {"trace": tr} if tr.sampled else {}
        if route == "preview" and self.preview is not None:
            # not an AdmissionReview: the preview engine answers its own
            # JSON (it may run for seconds — per-connection handler
            # threads mean admission requests are not behind it)
            status, payload = self.preview.handle_http(body)
            tr.set_status("preview")
            tr.finish()
            return status, payload
        if route == "admitlabel" and self.ns_label is not None:
            out = self.ns_label.handle(review)
        elif route == "admit" and self.validation is not None:
            out = self.validation.handle(review, **kw)
        elif route == "mutate" and self.mutation is not None:
            out = self.mutation.handle(review, **kw)
        else:
            tr.set_status("not_found")
            tr.finish()
            return 404, b""
        if not tr.sampled:
            return 200, encode_envelope(out)
        with tr.span("serialize"):
            payload = encode_envelope(out)
        tr.finish()
        return 200, payload, {"X-Trace-Id": tr.trace_id}

    def start(self) -> None:
        self._thread.start()

    def stop(self, drain_timeout: float = 10.0) -> None:
        """Graceful shutdown: stop accepting, let in-flight reviews
        finish (their batcher flushes answer them per the failure
        stance), then tear the pipeline down — SIGTERM must not drop
        sockets mid-review."""
        self.server.shutdown()  # stop the accept loop; handlers continue
        end = time.monotonic() + drain_timeout
        while time.monotonic() < end:
            if self.http.inflight() == 0:
                break
            time.sleep(0.02)
        for handler in (self.validation, self.mutation):
            if handler is not None:
                handler.batcher.drain(
                    max(0.5, end - time.monotonic()))
                handler.batcher.stop()
        self.server.server_close()
