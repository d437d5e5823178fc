"""Request-scoped tracing, latency attribution, and a flight recorder.

Split admission across four processes and five queues; a p99
number alone cannot say WHERE the time went. The reference line answers
with pprof through controller-runtime — the TPU-native analog here is a
zero-dependency span layer:

  * W3C `traceparent` is accepted at the HTTP edge and the trace id is
    echoed back as `X-Trace-Id`, so a trace started by the API server
    (or curl) joins ours;
  * a compact span context rides the backplane Q frames and is pinned
    to each MicroBatcher entry, so one admission decision decomposes
    into named stages (frontend_parse -> backplane_forward ->
    engine_queue -> batch_seal -> evaluate / cache_hit -> serialize ->
    respond) and one audit sweep decomposes into its phases
    (list_delta_apply -> encode -> device_sweep -> materialize ->
    status_writes);
  * completed traces feed three sinks: per-stage latency histograms
    (`gatekeeper_tpu_stage_duration_seconds{plane,stage}`), a bounded
    in-memory FLIGHT RECORDER that always retains the N slowest and N
    most recent complete traces per plane (dumped by /debug/traces),
    and structured slow-request log lines past --trace-slow-threshold.

Sampling is stride-based and the unsampled hot path pays near zero: a
preallocated no-op context is returned without allocating a single
span object (tests assert this via the module allocation counter).
Shed / timeout / fail-open decisions still produce (truncated) spans,
so a storm is diagnosable after the fact from the recorder alone.
"""

from __future__ import annotations

import heapq
import os
import threading
import time
from collections import deque
from typing import Optional

from .logging import logger

log = logger("trace")

# planes a trace can belong to (label value on the stage histograms)
ADMISSION = "admission"
AUDIT = "audit"

# allocation counter: bumped by every real Trace/Span construction so a
# test can assert the unsampled hot path allocates NO span objects
ALLOCATIONS = 0


def new_trace_id() -> str:
    """128-bit random trace id, lowercase hex (W3C trace-id format)."""
    return os.urandom(16).hex()


def parse_traceparent(header: Optional[str]) -> tuple[Optional[str], bool]:
    """(trace_id, sampled) from a W3C `traceparent` header value:
    `00-<32 hex trace-id>-<16 hex parent-id>-<2 hex flags>`. Malformed
    or all-zero ids return (None, False) — never raise on wire input."""
    if not header:
        return None, False
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None, False
    version, trace_id, parent_id, flags = parts[0], parts[1], parts[2], \
        parts[3]
    if len(version) != 2 or len(trace_id) != 32 or len(parent_id) != 16:
        return None, False
    trace_id = trace_id.lower()
    # STRICT hex digits only: int(x, 16) also accepts '0x', '_', sign,
    # and whitespace — ids that would later blow up bytes.fromhex when
    # the context rides the backplane frame
    if not _HEX_DIGITS.issuperset(trace_id):
        return None, False
    try:
        sampled = bool(int(flags[:2], 16) & 0x01)
    except ValueError:
        return None, False
    if trace_id == "0" * 32:
        return None, False
    return trace_id, sampled


_HEX_DIGITS = frozenset("0123456789abcdef")


def format_traceparent(trace_id: str, span_id: str = "",
                       sampled: bool = True) -> str:
    return "00-%s-%s-%s" % (trace_id, (span_id or os.urandom(8).hex()),
                            "01" if sampled else "00")


class Span:
    """One named stage of a trace. `t0`/`t1` are time.monotonic()
    instants (CLOCK_MONOTONIC is system-wide on Linux, so spans stamped
    in the frontend processes compare directly against engine spans).
    `remote` marks spans timed by ANOTHER process whose aggregated
    duration already ships separately (the frontends' S-frame stage
    deltas) — the metrics sink skips them to avoid double counting."""

    __slots__ = ("name", "t0", "t1", "remote")

    def __init__(self, name: str, t0: float, t1: float,
                 remote: bool = False):
        global ALLOCATIONS
        ALLOCATIONS += 1
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.remote = remote

    @property
    def duration(self) -> float:
        return max(0.0, self.t1 - self.t0)


class Trace:
    """One request's (or one audit sweep's) span collection. Not
    thread-safe per span — each stage is recorded by the one thread
    that ran it; finish() is called exactly once."""

    __slots__ = ("trace_id", "plane", "t0", "t1", "spans", "status",
                 "attrs", "_tracer", "_finished")

    sampled = True

    def __init__(self, tracer: "Tracer", plane: str, trace_id: str):
        global ALLOCATIONS
        ALLOCATIONS += 1
        self._tracer = tracer
        self.plane = plane
        self.trace_id = trace_id
        self.t0 = time.monotonic()
        self.t1 = 0.0
        self.spans: list[Span] = []
        self.status = ""
        self.attrs: dict = {}
        self._finished = False

    # ------------------------------------------------------------ spans

    def add_span(self, name: str, t0: float, t1: float,
                 remote: bool = False) -> None:
        self.spans.append(Span(name, t0, t1, remote=remote))

    def add_phase(self, name: str, seconds: float) -> None:
        """Duration-only span (synthesized from a PhaseTimers diff —
        audit phases overlap under the dispatch pipeline, so only the
        accumulated duration is meaningful, not wall-clock position).
        Anchored after the last recorded span for a readable dump."""
        if seconds < 0:
            seconds = 0.0
        anchor = self.spans[-1].t1 if self.spans else self.t0
        self.spans.append(Span(name, anchor, anchor + seconds))

    def span(self, name: str):
        """Context manager timing one stage:  with tr.span("encode"):"""
        return _SpanCtx(self, name)

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def set_status(self, status: str) -> None:
        """Outcome tag (allow/deny/shed/timeout/error): shed and
        timeout verdicts still finish their (truncated) trace, so a
        storm's flight-recorder dump shows where the budget went."""
        self.status = status

    # ----------------------------------------------------------- finish

    def finish(self) -> None:
        if self._finished:  # double finish (error path raced): first wins
            return
        self._finished = True
        self.t1 = time.monotonic()
        self._tracer._complete(self)

    def duration(self) -> float:
        return max(0.0, (self.t1 or time.monotonic()) - self.t0)

    def to_dict(self) -> dict:
        """Plain-container form for the recorder / JSON dump. Span
        times are RELATIVE to the trace start (monotonic instants mean
        nothing outside the process)."""
        return {
            "trace_id": self.trace_id,
            "plane": self.plane,
            "status": self.status,
            "duration_s": round(self.duration(), 6),
            "attrs": dict(self.attrs),
            "spans": [{"stage": s.name,
                       "start_s": round(s.t0 - self.t0, 6),
                       "duration_s": round(s.duration, 6)}
                      for s in self.spans],
        }


class _SpanCtx:
    __slots__ = ("_trace", "_name", "_t0")

    def __init__(self, trace: Trace, name: str):
        self._trace = trace
        self._name = name

    def __enter__(self):
        self._t0 = time.monotonic()
        return self._trace

    def __exit__(self, *exc):
        # gklint: allow(stage) reason=plumbing; the name was a checked literal at the span() call site
        self._trace.add_span(self._name, self._t0, time.monotonic())
        return False


class _NoopSpanCtx:
    __slots__ = ()

    def __enter__(self):
        return NOOP

    def __exit__(self, *exc):
        return False


_NOOP_SPAN_CTX = _NoopSpanCtx()


class NoopTrace:
    """Preallocated no-op context served to every unsampled request:
    all recorders are empty methods, `sampled` is False, and nothing is
    allocated on the hot path (the module-level singleton is returned
    by reference)."""

    __slots__ = ()

    sampled = False
    trace_id = ""
    plane = ""
    status = ""

    def add_span(self, name, t0, t1, remote=False):
        pass

    def add_phase(self, name, seconds):
        pass

    def span(self, name):
        return _NOOP_SPAN_CTX

    def set_attr(self, key, value):
        pass

    def set_status(self, status):
        pass

    def finish(self):
        pass

    def duration(self):
        return 0.0

    def to_dict(self):
        return {}


NOOP = NoopTrace()


class FlightRecorder:
    """Bounded in-memory trace retention, per plane: the N most RECENT
    complete traces (a ring) and the N SLOWEST (a min-heap keyed on
    duration, so the cheapest of the slow set is evicted first). Holds
    plain dicts, never live objects — a dumped trace cannot pin request
    bodies or device buffers in memory."""

    def __init__(self, keep: int = 32):
        self.keep = keep
        self._lock = threading.Lock()
        self._recent: dict[str, deque] = {}
        self._slow: dict[str, list] = {}  # plane -> [(dur, seq, dict)]
        self._seq = 0

    def record(self, trace: Trace) -> None:
        entry = trace.to_dict()
        dur = entry["duration_s"]
        with self._lock:
            self._seq += 1
            recent = self._recent.get(trace.plane)
            if recent is None:
                recent = self._recent[trace.plane] = deque(maxlen=self.keep)
            recent.append(entry)
            slow = self._slow.setdefault(trace.plane, [])
            if len(slow) < self.keep:
                heapq.heappush(slow, (dur, self._seq, entry))
            elif slow and dur > slow[0][0]:
                heapq.heapreplace(slow, (dur, self._seq, entry))

    def dump(self) -> dict:
        """JSON-ready dump for /debug/traces: per plane, the recent
        ring (oldest first) and the slow set (slowest first)."""
        with self._lock:
            planes = {}
            for plane in sorted(set(self._recent) | set(self._slow)):
                slow = sorted(self._slow.get(plane, []),
                              key=lambda e: (-e[0], e[1]))
                planes[plane] = {
                    "recent": list(self._recent.get(plane, ())),
                    "slowest": [e[2] for e in slow],
                }
            return {"planes": planes}

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slow.clear()


class Tracer:
    """Sampling decisions + completed-trace sinks.

    Stride sampling (1 of every round(1/rate)) instead of an RNG call:
    deterministic, testable, and the unsampled path costs one integer
    compare. An inbound `traceparent` with the sampled flag FORCES
    sampling — a caller who started a distributed trace gets our spans
    regardless of the local rate."""

    def __init__(self, sample_rate: float = 0.0,
                 slow_threshold_s: float = 1.0,
                 recorder: Optional[FlightRecorder] = None,
                 metrics_sink: bool = True):
        self.recorder = recorder or FlightRecorder()
        self.metrics_sink = metrics_sink
        self.slow_threshold_s = slow_threshold_s
        self._n = 0
        self.configure(sample_rate, slow_threshold_s)

    def configure(self, sample_rate: float,
                  slow_threshold_s: Optional[float] = None) -> None:
        self.sample_rate = max(0.0, min(1.0, float(sample_rate)))
        self._stride = (0 if self.sample_rate <= 0.0
                        else max(1, round(1.0 / self.sample_rate)))
        if slow_threshold_s is not None:
            self.slow_threshold_s = float(slow_threshold_s)

    # ----------------------------------------------------------- starts

    def start(self, plane: str, traceparent: Optional[str] = None,
              force: bool = False):
        """A Trace when this request samples, else the preallocated
        NOOP singleton (zero allocation)."""
        trace_id = None
        if traceparent is not None:
            trace_id, inbound_sampled = parse_traceparent(traceparent)
            force = force or (trace_id is not None and inbound_sampled)
        if not force:
            if not self._stride:
                return NOOP
            # benign data race under the GIL: a dropped increment skews
            # the effective rate immeasurably and costs no lock
            self._n += 1
            if self._n % self._stride:
                return NOOP
        return Trace(self, plane, trace_id or new_trace_id())

    def resume(self, plane: str, trace_id: str) -> Trace:
        """Engine-side continuation of a span context carried over the
        backplane: the frontend already made the sampling decision."""
        return Trace(self, plane, trace_id)

    def sample_context(self, traceparent: Optional[str] = None
                       ) -> Optional[str]:
        """Edge-side sampling WITHOUT allocating a trace: the trace id
        (hex) when this request samples, else None. The frontends use
        this — they forward the span context over the backplane and
        never own a recorder, so a full Trace object would be waste."""
        trace_id = None
        force = False
        if traceparent is not None:
            trace_id, force = parse_traceparent(traceparent)
        if not force:
            if not self._stride:
                return None
            self._n += 1
            if self._n % self._stride:
                return None
        return trace_id or new_trace_id()

    # ------------------------------------------------------------ sinks

    def _complete(self, trace: Trace) -> None:
        if self.metrics_sink:
            try:
                from . import metrics
                metrics.report_trace(trace.plane)
                for s in trace.spans:
                    if not s.remote:
                        # the trace id rides along as the histogram
                        # bucket's OpenMetrics exemplar: a slow p99
                        # bucket links straight to this trace's
                        # /debug/traces flight-recorder entry
                        # gklint: allow(stage) reason=sink plumbing; every span name was a checked literal where recorded
                        metrics.report_stage(trace.plane, s.name,
                                             s.duration,
                                             trace_id=trace.trace_id)
            except Exception:  # the sink must never fail a request
                pass
        try:
            self.recorder.record(trace)
        except Exception:
            pass
        # the slow log is a REQUEST sink: audit sweeps are force-traced
        # and routinely run past any request-scale threshold — every
        # sweep already logs its duration and phase stats on the
        # `audit complete` line, so slow-warning them here would spam
        # a warning per interval forever and bury real anomalies
        if self.slow_threshold_s > 0 and trace.plane != AUDIT and \
                trace.duration() >= self.slow_threshold_s:
            try:
                log.warning("slow request trace",
                            event_type="slow_trace", **trace.to_dict())
            except Exception:
                pass


# process-global tracer: main.py configures it from --trace-sample-rate
# / --trace-slow-threshold; frontends configure their own in
# frontend_main. Rate 0 = tracing off (every start() returns NOOP)
# until configured.
TRACER = Tracer(sample_rate=0.0)
