"""Metrics registry + Prometheus text exposition.

Metric-name parity with the reference's per-package stats reporters
(SURVEY.md §2.1): violations, audit_duration_seconds, audit_last_run_time
(pkg/audit/stats_reporter.go), request_count / request_duration_seconds
(pkg/webhook), constraints (constraint controller), constraint_templates +
ingestion duration (constrainttemplate controller), sync* (sync
controller), watch_manager_* (watch). Exported on --prometheus-port in the
text format (reference pkg/metrics/prometheus_exporter.go:17-43).
"""

from __future__ import annotations

import http.server
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Optional


class _Metric:
    def __init__(self, name: str, help_: str, kind: str):
        self.name = name
        self.help = help_
        self.kind = kind  # counter | gauge | histogram
        self.lock = threading.Lock()
        self.values: dict[tuple, float] = defaultdict(float)
        self.label_names: tuple = ()
        # histogram state
        self.buckets: tuple = ()
        self.bucket_counts: dict[tuple, list] = {}
        self.sums: dict[tuple, float] = defaultdict(float)
        self.counts: dict[tuple, int] = defaultdict(int)
        # OpenMetrics exemplars: per label-set, per bucket index, the
        # LATEST (trace_id, observed value, unix ts) that landed in
        # that bucket — a slow p99 bucket links straight to its
        # /debug/traces flight-recorder entry
        self.exemplars: dict[tuple, dict[int, tuple]] = {}


class Registry:
    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, help_: str, kind: str, labels: tuple) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = _Metric(name, help_, kind)
                m.label_names = labels
                self._metrics[name] = m
            return m

    # ------------------------------------------------------------ recorders

    def counter_add(self, name: str, help_: str, value: float = 1.0,
                    **labels) -> None:
        m = self._get(name, help_, "counter", tuple(sorted(labels)))
        with m.lock:
            m.values[_lv(labels)] += value

    def gauge_set(self, name: str, help_: str, value: float, **labels) -> None:
        m = self._get(name, help_, "gauge", tuple(sorted(labels)))
        with m.lock:
            m.values[_lv(labels)] = value

    @staticmethod
    def _freeze_buckets(m: _Metric, buckets) -> None:
        """Pin a histogram's bucket bounds at FIRST registration and
        raise on any later mismatch. Re-assigning per call (the old
        behavior) let two call sites with different bounds silently
        mis-bucket counts against each other's stale lists — the
        rendered cumulative histogram stayed plausible while every
        quantile computed from it was wrong."""
        if not m.buckets:
            m.buckets = tuple(buckets)
        elif m.buckets != tuple(buckets):
            raise ValueError(
                f"histogram {m.name} registered with buckets "
                f"{m.buckets}; observe called with {tuple(buckets)}")

    def observe(self, name: str, help_: str, value: float,
                buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30, 60,
                         300), exemplar: Optional[str] = None,
                **labels) -> None:
        """`exemplar` (a sampled trace id) attaches to the bucket this
        observation lands in; the OpenMetrics exposition renders it so
        a latency bucket links to its flight-recorder trace."""
        m = self._get(name, help_, "histogram", tuple(sorted(labels)))
        with m.lock:
            self._freeze_buckets(m, buckets)
            key = _lv(labels)
            if key not in m.bucket_counts:
                m.bucket_counts[key] = [0] * (len(buckets) + 1)
            counts = m.bucket_counts[key]
            idx = len(buckets)  # +Inf overflow by default
            for i, b in enumerate(buckets):
                if value <= b:
                    idx = i
                    break
            counts[idx] += 1
            m.sums[key] += value
            m.counts[key] += 1
            if exemplar:
                m.exemplars.setdefault(key, {})[idx] = (
                    str(exemplar), value, time.time())

    def observe_bucketed(self, name: str, help_: str, buckets: tuple,
                         bucket_counts: list, sum_: float, count: int,
                         **labels) -> None:
        """Merge a PRE-AGGREGATED histogram delta. `bucket_counts` must
        carry len(buckets)+1 entries — the last is the +Inf overflow
        bucket — and `count` must equal their sum, or the rendered
        cumulative histogram goes invalid (+Inf bucket < _count). The
        backplane frontends run in their own processes and ship their
        forward-latency histograms over the wire as aggregated deltas —
        replaying observations one by one would cost more than the
        latency being measured."""
        m = self._get(name, help_, "histogram", tuple(sorted(labels)))
        with m.lock:
            self._freeze_buckets(m, buckets)
            key = _lv(labels)
            if key not in m.bucket_counts:
                m.bucket_counts[key] = [0] * (len(buckets) + 1)
            counts = m.bucket_counts[key]
            for i, c in enumerate(bucket_counts[: len(counts)]):
                counts[i] += c
            m.sums[key] += sum_
            m.counts[key] += count

    # ----------------------------------------------------------- snapshot

    def snapshot(self, names: tuple) -> dict:
        """JSON-safe totals of the named metrics, for the N-engine
        plane's stats relay: an engine child answers the primary's poll
        with this, the primary diffs against the previous poll and
        merges the deltas into ITS registry — so /metrics on the
        primary aggregates shed counts, decisions, cache outcomes, and
        per-engine stage histograms across every engine process."""
        out = {}
        with self._lock:
            metrics = [self._metrics[n] for n in names
                       if n in self._metrics]
        for m in metrics:
            with m.lock:
                ent = {"kind": m.kind, "help": m.help,
                       "labels": list(m.label_names)}
                if m.kind in ("counter", "gauge"):
                    ent["values"] = [[list(k), v]
                                     for k, v in m.values.items()]
                else:
                    ent["buckets"] = list(m.buckets)
                    ent["hist"] = [
                        [list(k), list(m.bucket_counts[k]),
                         m.sums[k], m.counts[k]]
                        for k in m.bucket_counts]
                out[m.name] = ent
        return out

    def merge_snapshot_delta(self, cur: dict, prev: dict) -> None:
        """Merge (cur - prev) of a Registry.snapshot() into this
        registry. A restarted engine's counters reset to zero — any
        negative delta treats cur as the whole delta (counts since the
        restart are new work, not a rewind)."""
        prev = prev or {}
        for name, ent in cur.items():
            labels = tuple(ent.get("labels") or ())
            pent = prev.get(name) or {}
            if ent["kind"] == "gauge":
                # gauges merge by LAST VALUE, not delta — the relayed
                # series carry engine/worker labels so each child owns
                # its own series, and a delta-add would turn any dip
                # (queue draining, duty decaying) into garbage
                for k, v in ent.get("values") or []:
                    self.gauge_set(name, ent.get("help", ""), v,
                                   **dict(zip(labels, tuple(k))))
            elif ent["kind"] == "counter":
                pvals = {tuple(k): v
                         for k, v in (pent.get("values") or [])}
                for k, v in ent.get("values") or []:
                    kt = tuple(k)
                    d = v - pvals.get(kt, 0)
                    if d < 0:
                        d = v
                    if d:
                        self.counter_add(name, ent.get("help", ""), d,
                                         **dict(zip(labels, kt)))
            else:
                phist = {tuple(k): (c, s, n)
                         for k, c, s, n in (pent.get("hist") or [])}
                buckets = tuple(ent.get("buckets") or ())
                for k, counts, sum_, n in ent.get("hist") or []:
                    kt = tuple(k)
                    pc, ps, pn = phist.get(kt, ([0] * len(counts),
                                                0.0, 0))
                    dn = n - pn
                    if dn < 0:  # engine restarted
                        dc, ds, dn = list(counts), sum_, n
                    else:
                        dc = [c - p for c, p in zip(counts, pc)]
                        ds = sum_ - ps
                    if dn:
                        self.observe_bucketed(
                            name, ent.get("help", ""), buckets, dc,
                            ds, dn, **dict(zip(labels, kt)))

    # ------------------------------------------------------------- render

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition; `openmetrics=True` renders the
        OpenMetrics dialect instead: per-bucket EXEMPLARS
        (`... # {trace_id="<id>"} <value> <ts>`), the terminating
        `# EOF`, and SPEC-COMPLIANT counter naming — OpenMetrics
        requires counter samples to be `<family>_total` with the
        family (HELP/TYPE) named WITHOUT the suffix, and strict
        scrapers (Prometheus's openmetrics parser included) reject the
        whole exposition otherwise. Our `*_total` counters keep their
        sample names (family drops the suffix); legacy reference-named
        counters (`request_count`, ...) gain `_total` on the sample in
        this dialect only. The plain text format is byte-identical to
        what it always was — exemplars and the renames exist only in
        the negotiated dialect."""
        out = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            name = m.name
            if openmetrics and m.kind == "counter":
                family = name[:-6] if name.endswith("_total") else name
                sample = family + "_total"
            else:
                family = sample = name
            out.append(f"# HELP {family} {m.help}")
            out.append(f"# TYPE {family} {m.kind}")
            with m.lock:
                if m.kind in ("counter", "gauge"):
                    for key, v in sorted(m.values.items()):
                        out.append(f"{sample}{_fmt(m.label_names, key)} {_num(v)}")
                else:
                    for key in sorted(m.bucket_counts):
                        ex = m.exemplars.get(key, {}) if openmetrics \
                            else {}
                        cum = 0
                        for i, b in enumerate(m.buckets):
                            cum += m.bucket_counts[key][i]
                            out.append(
                                f"{m.name}_bucket"
                                f"{_fmt(m.label_names, key, le=_num(b))} {cum}"
                                + _exemplar_suffix(ex.get(i)))
                        cum += m.bucket_counts[key][-1]
                        out.append(
                            f"{m.name}_bucket"
                            f"{_fmt(m.label_names, key, le='+Inf')} {cum}"
                            + _exemplar_suffix(ex.get(len(m.buckets))))
                        out.append(
                            f"{m.name}_sum{_fmt(m.label_names, key)} "
                            f"{_num(m.sums[key])}")
                        out.append(
                            f"{m.name}_count{_fmt(m.label_names, key)} "
                            f"{m.counts[key]}")
        if openmetrics:
            out.append("# EOF")
        return "\n".join(out) + "\n"


def _lv(labels: dict) -> tuple:
    return tuple(str(labels[k]) for k in sorted(labels))


def _esc(v) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline). Without it one kind name carrying a quote breaks every
    scraper parsing the whole exposition."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(names: tuple, values: tuple, **extra) -> str:
    pairs = [f'{n}="{_esc(v)}"' for n, v in zip(names, values)]
    pairs += [f'{k}="{v}"' for k, v in extra.items()]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _num(v: float) -> str:
    if v == int(v):
        return str(int(v))
    return repr(v)


def _exemplar_suffix(ex: Optional[tuple]) -> str:
    """OpenMetrics exemplar clause for one bucket sample line (empty
    when the bucket never saw a sampled observation)."""
    if not ex:
        return ""
    trace_id, value, ts = ex
    return f' # {{trace_id="{_esc(trace_id)}"}} {_num(value)} {ts:.3f}'


REGISTRY = Registry()

# OpenMetrics content negotiation: the media type a scraper sends in
# Accept to request the exemplar-bearing dialect, and what we answer
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
TEXT_CONTENT_TYPE = "text/plain; version=0.0.4"


def negotiate_exposition(accept_header: Optional[str],
                         registry: Registry = REGISTRY
                         ) -> tuple[bytes, str]:
    """(body, content_type) for one /metrics scrape, honoring the
    Accept header: `application/openmetrics-text` gets the OpenMetrics
    dialect (bucket exemplars + # EOF); everything else gets the
    classic text format."""
    om = bool(accept_header) and \
        "application/openmetrics-text" in accept_header
    body = registry.render(openmetrics=om).encode()
    return body, OPENMETRICS_CONTENT_TYPE if om else TEXT_CONTENT_TYPE


# ------------------------------------------------- process self-metrics

_PROCESS_START_TIME: Optional[float] = None
_GC_SEEN: dict[tuple, float] = {}
# serializes the GC-delta read-modify-write: the exposition server is
# threaded, and two concurrent scrapes would both read the stale seen
# value and double-add the delta — permanently overcounting exactly
# the counters meant to prove gc.freeze held
_GC_SEEN_LOCK = threading.Lock()


def _process_start_time() -> float:
    """Unix timestamp of process start: /proc/self/stat field 22 (clock
    ticks since boot) + /proc/stat btime, the same derivation the
    official prometheus clients use; import time of this module as the
    fallback off Linux."""
    global _PROCESS_START_TIME
    if _PROCESS_START_TIME is not None:
        return _PROCESS_START_TIME
    try:
        with open("/proc/self/stat") as f:
            # comm may contain spaces/parens: fields start after ')'
            fields = f.read().rpartition(")")[2].split()
        ticks = float(fields[19])  # starttime is field 22 overall
        with open("/proc/stat") as f:
            btime = next(float(line.split()[1]) for line in f
                         if line.startswith("btime "))
        hz = os.sysconf("SC_CLK_TCK")
        _PROCESS_START_TIME = btime + ticks / hz
    except Exception:
        _PROCESS_START_TIME = _IMPORT_TIME
    return _PROCESS_START_TIME


def update_process_metrics(registry: Registry = REGISTRY) -> None:
    """Refresh the standard process/runtime self-metrics. Called on
    every scrape (the values are reads of /proc and gc state, not
    accumulation): process start time, RSS, open FDs, thread count,
    and Python GC generation counts + collection totals — the GC
    series exist specifically to PROVE the serving processes'
    gc.freeze tuning held (a frozen heap shows near-zero gen-2
    collections under load)."""
    import gc

    registry.gauge_set("process_start_time_seconds",
                       "Start time of the process since unix epoch in "
                       "seconds", _process_start_time())
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        registry.gauge_set("process_resident_memory_bytes",
                           "Resident memory size in bytes",
                           rss_pages * os.sysconf("SC_PAGE_SIZE"))
    except Exception:
        pass
    try:
        registry.gauge_set("process_open_fds",
                           "Number of open file descriptors",
                           len(os.listdir("/proc/self/fd")))
    except Exception:
        pass
    registry.gauge_set("process_threads",
                       "Live Python threads in this process",
                       threading.active_count())
    for gen, count in enumerate(gc.get_count()):
        registry.gauge_set("python_gc_objects_tracked",
                           "Objects tracked by the Python GC per "
                           "generation (collection pressure; stays "
                           "flat when gc.freeze held)",
                           count, generation=str(gen))
    for gen, stats in enumerate(gc.get_stats()):
        for field, metric, help_ in (
                ("collections", "python_gc_collections_total",
                 "GC collections per generation"),
                ("collected", "python_gc_objects_collected_total",
                 "Objects collected by the GC per generation")):
            cur = float(stats.get(field, 0))
            key = (metric, gen)
            with _GC_SEEN_LOCK:
                delta = cur - _GC_SEEN.get(key, 0.0)
                _GC_SEEN[key] = cur
            if delta > 0:
                registry.counter_add(metric, help_, delta,
                                     generation=str(gen))


_IMPORT_TIME = time.time()


# ------------------------------------------------- saturation probes

# scrape-time gauge refreshers: each is a zero-arg callable that sets
# its own gauges (queue depths, duty cycles, stream backlog) against
# the live objects it closed over — sampled state, not accumulation,
# so refreshing per scrape is both cheap and always current. Probes
# must never fail a scrape; errors are swallowed per probe.
_SATURATION_PROBES: dict[str, Callable[[], None]] = {}
_PROBES_LOCK = threading.Lock()


def register_saturation_probe(name: str, probe) -> None:
    """Install (or replace) a named scrape-time gauge refresher."""
    with _PROBES_LOCK:
        _SATURATION_PROBES[name] = probe


def unregister_saturation_probe(name: str) -> None:
    with _PROBES_LOCK:
        _SATURATION_PROBES.pop(name, None)


def run_saturation_probes() -> None:
    """Refresh every registered saturation gauge (called on each
    /metrics scrape, and directly by tests)."""
    with _PROBES_LOCK:
        probes = list(_SATURATION_PROBES.values())
    for probe in probes:
        try:
            probe()
        except Exception:
            pass  # a dead probe must never fail the scrape


def serve(port: int, registry: Registry = REGISTRY, addr: str = "",
          debug_providers: Optional[dict] = None
          ) -> http.server.ThreadingHTTPServer:
    """Start the /metrics endpoint (reference --prometheus-port 8888).

    `debug_providers` maps endpoint names to callables taking the raw
    query string and returning a JSON-serializable object; each is
    served at /debug/<name> (the flight recorder dump, per-template
    compile state, and the device-profile armer ride here)."""

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            path, _, query = self.path.partition("?")
            path = path.rstrip("/")
            if path in ("", "/metrics"):
                update_process_metrics(registry)
                run_saturation_probes()
                body, ctype = negotiate_exposition(
                    self.headers.get("Accept"), registry)
                self._reply(200, body, ctype)
                return
            if path.startswith("/debug/") and debug_providers:
                body, status = render_debug(
                    debug_providers, path[len("/debug/"):], query)
                self._reply(status, body, "application/json")
                return
            self.send_response(404)
            self.end_headers()

        def _reply(self, status: int, body: bytes, ctype: str):
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    server = http.server.ThreadingHTTPServer((addr, port), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def render_debug(providers: dict, name: str, query: str
                 ) -> tuple[bytes, int]:
    """Shared /debug/<name> dispatch (the metrics server and the
    health server both mount the same provider registry): returns
    (json_body, http_status). Provider errors answer 500 with the
    error text instead of dropping the connection."""
    from . import jsonio

    provider = providers.get(name)
    if provider is None:
        return (jsonio.dumps_bytes(
            {"error": f"unknown debug endpoint {name!r}",
             "available": sorted(providers)}), 404)
    try:
        return jsonio.dumps_bytes(provider(query)), 200
    except Exception as e:
        return jsonio.dumps_bytes({"error": str(e)}), 500


# convenience recorders with reference metric names


def report_violations(action: str, count: int) -> None:
    REGISTRY.gauge_set("violations", "Total violations detected by the last "
                       "audit run", count, enforcement_action=action)


def report_audit_duration(seconds: float) -> None:
    REGISTRY.observe("audit_duration_seconds", "Latency of audit operation",
                     seconds)


def report_audit_last_run(ts: Optional[float] = None) -> None:
    REGISTRY.gauge_set("audit_last_run_time", "Timestamp of last audit run",
                       ts if ts is not None else time.time())


# which engine process this registry lives in ("0" = the primary /
# in-process engine; "1".. = spawned engine children; "" = a process
# that serves no admission engine). Stamped into the per-engine stage
# and request metrics so an N-engine plane decomposes per chip.
_ENGINE_ID = ""


def set_engine_id(engine_id: str) -> None:
    global _ENGINE_ID
    _ENGINE_ID = str(engine_id)


def engine_id() -> str:
    return _ENGINE_ID


def report_request(admission_status: str, seconds: float) -> None:
    REGISTRY.counter_add("request_count", "Count of admission requests",
                         admission_status=admission_status)
    REGISTRY.observe("request_duration_seconds",
                     "Latency of admission requests", seconds,
                     admission_status=admission_status)
    if _ENGINE_ID:
        # per-engine decomposition of the same counter: the aggregate
        # stays label-compatible with every dashboard built on it while
        # the N-engine plane remains attributable per chip
        REGISTRY.counter_add("gatekeeper_tpu_engine_requests_total",
                             "Admission requests decided, by owning "
                             "engine process",
                             admission_status=admission_status,
                             engine=_ENGINE_ID)


# batch economics: how full micro-batches seal and WHY they sealed.
# A plane whose seals are reason=deadline|max_wait at fill ~0.01 is
# edge-bound (trickle traffic never fills a batch); reason=full at
# fill 1.0 means the engine is the bottleneck and batching is earning
# its latency cost.
FILL_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0)

BATCH_SEAL_REASONS = ("deadline", "full", "max_wait", "drain")


def report_batch_seal(reason: str, fill: float,
                      plane: str = "admission") -> None:
    """One sealed micro-batch: `reason` says what closed the collection
    window (full = max_batch reached, deadline = a member's propagated
    deadline forced an early seal, max_wait = the window elapsed,
    drain = shutdown flush), `fill` is len(batch)/max_batch. `plane`
    separates the validating and mutating batchers — the edge-vs-
    engine attribution read must not mix a mutation trickle's
    near-empty seals into the admission series."""
    if reason not in BATCH_SEAL_REASONS:
        reason = "max_wait"
    REGISTRY.counter_add("gatekeeper_tpu_batch_seal_total",
                         "Sealed micro-batches by seal reason and plane",
                         reason=reason, plane=plane)
    REGISTRY.observe("gatekeeper_tpu_batch_fill_ratio",
                     "Fill ratio (members / max_batch) of each sealed "
                     "micro-batch, by plane", min(1.0, max(0.0, fill)),
                     buckets=FILL_BUCKETS, plane=plane)


def report_queue_depth(queue: str, depth: int,
                       engine: str = "") -> None:
    """Sampled depth of one serving-plane queue (scrape-time gauge):
    admission / mutation = MicroBatcher in-flight (queued + sealed +
    flushing, the --admission-max-queue bound's own counter),
    backplane_engine = engine-side evaluations in flight. `engine`
    distinguishes co-resident BackplaneEngine instances — without it
    two engines in one process would overwrite one series and one
    engine's teardown zero would hide the other's live backlog."""
    REGISTRY.gauge_set("gatekeeper_tpu_queue_depth",
                       "Sampled serving-plane queue depth by queue "
                       "(and owning engine, where applicable)",
                       depth, queue=queue, engine=engine)


def report_backplane_inflight(worker: str, inflight: int) -> None:
    """Per-frontend forwarded-and-unanswered review count (shipped in
    the frontend's S-frame stats): the router's least-load signal,
    exported so 'one frontend saturated, others idle' is readable."""
    REGISTRY.gauge_set("gatekeeper_tpu_backplane_inflight",
                       "Reviews a frontend has forwarded over the "
                       "backplane and not yet had answered",
                       inflight, worker=worker)


def report_duty_cycle(duty: float, engine: Optional[str] = None) -> None:
    """Busy-fraction EMA of one engine's evaluator (device sweeps +
    batched admission evals + interpreter fallback, from the driver's
    eval wall clock): ~0 while admission p99 climbs means the EDGE is
    saturated, not the engine — the attribution ROADMAP item 5 needs."""
    REGISTRY.gauge_set("gatekeeper_tpu_device_duty_cycle",
                       "Fraction of wall clock this engine's evaluator "
                       "spent busy (EMA over scrape intervals)",
                       min(1.0, max(0.0, duty)),
                       engine=engine if engine is not None else _ENGINE_ID
                       or "0")


def zero_engine_gauges(engine: str) -> None:
    """Zero one engine child's relayed engine-labeled saturation
    gauges (queue depth, duty cycle). The child's own registry dies
    with its process, but the PRIMARY keeps the last relayed values —
    a dead engine would export its final (possibly saturated) depth
    and duty until its respawn's first stats poll, or forever if the
    respawn keeps failing. The EngineSupervisor calls this on death
    detection and at stop (the stale-export discipline applied
    to the relay path)."""
    for queue in ("admission", "mutation", "backplane_engine"):
        report_queue_depth(queue, 0, engine=str(engine))
    report_duty_cycle(0.0, engine=str(engine))


def report_stream_pending(pending: int) -> None:
    """Streaming-audit backlog: tracker dirty keys buffered ahead of
    the next flush (refreshed per flush AND per scrape) — growth here
    means detection latency is about to follow."""
    REGISTRY.gauge_set("gatekeeper_tpu_audit_stream_pending_events",
                       "Watch events buffered (dirty keys) ahead of the "
                       "next streaming-audit flush", pending)


def report_build_info() -> None:
    """The standard build-info join gauge, emitted once at boot:
    version/torch/CUDA/device/device-count as labels, value always 1."""
    from .. import __version__
    torch_version = cuda_version = device = "unknown"
    device_count = 0
    try:
        import torch
        torch_version = torch.__version__
        cuda_version = torch.version.cuda or "none"
        device_count = torch.cuda.device_count()
        device = (torch.cuda.get_device_name(0) if device_count
                  else "cpu")
    except Exception:
        pass
    REGISTRY.gauge_set("gatekeeper_tpu_build_info",
                       "Build/runtime identity (value is always 1; the "
                       "labels are the payload — join dashboards on "
                       "them)", 1.0,
                       version=__version__, torch_version=torch_version,
                       cuda_version=cuda_version, device=device,
                       device_count=str(device_count))


def report_batch_timeout(n: int = 1) -> None:
    """A MicroBatcher.submit() waiter gave up before its batch flushed
    (the entry is dropped from the queue so the flush never evaluates a
    request nobody is waiting for)."""
    REGISTRY.counter_add("admission_batch_timeouts",
                         "Admission requests that timed out waiting for "
                         "their micro-batch to flush", n)


def report_admission_shed(n: int = 1) -> None:
    """A submit() was refused at enqueue time: the micro-batch queue was
    at --admission-max-queue depth, so the request was answered per the
    failure stance immediately instead of queueing into certain
    timeout."""
    REGISTRY.counter_add("admission_requests_shed_total",
                         "Admission requests shed by the bounded "
                         "micro-batch queue", n)


# bounded label-value sets: every reporter that takes a label value
# from a caller folds unknowns to a stable bucket, so a bug (or a
# version-skewed peer over the wire) can never mint an unbounded
# series set — the registry never forgets a label set. Enforced
# statically by gklint's metrics_hygiene checker.
DECISION_CACHE_OUTCOMES = ("hit", "miss", "bypass")
RING_PATHS = ("ring", "inline")
ADAPTIVE_KNOBS = ("batch_max_wait", "batch_max_batch", "shed_depth",
                  "engine_fanout", "prewarm")
ADAPTIVE_DIRECTIONS = ("up", "down", "restore")
DEGRADATION_RUNGS = ("normal", "tighten_shed", "cache_only",
                     "fail_stance")
KUBE_WRITE_OUTCOMES = ("ok", "retried_ok", "failed", "breaker_open",
                       "budget_exhausted", "not_leader")
INGESTION_STATUSES = ("ok", "error", "active")
DEMOTION_REASONS = ("audit-eval", "review-eval", "join-eval",
                    "lowering", "join-lowering")
COMPILE_OUTCOMES = ("ok", "error")
AUDIT_SWEEP_PATHS = ("incremental", "full_resync", "full", "stream")
MATERIALIZE_PATHS = ("vectorized", "exact", "capped")
CACHE_OUTCOMES = ("hit", "miss")
STREAM_FLUSH_OUTCOMES = ("ok", "error", "skipped")
PREVIEW_OUTCOMES = ("ok", "error", "invalid")
SNAPSHOT_OUTCOMES = ("ok", "error", "missing", "fallback")
SCAN_OUTCOMES = ("allow", "deny", "error", "dedup", "skip")
SCAN_TIERS = ("inproc", "backplane", "grpc")

LABEL_FOLD = "other"


def report_adaptive_actuation(knob: str, direction: str,
                              n: int = 1) -> None:
    """One adaptive-controller knob movement (or a kill-switch
    baseline restore): which declared knob moved and which way. The
    aggregate oscillation read — sustained up/down alternation on one
    knob is the flip-flop the bench gate forbids."""
    if knob not in ADAPTIVE_KNOBS:
        knob = LABEL_FOLD
    if direction not in ADAPTIVE_DIRECTIONS:
        direction = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_adaptive_actuations_total",
                         "Adaptive-controller actuations by knob and "
                         "direction", n, knob=knob, direction=direction)


def report_adaptive_knob(knob: str, value: float) -> None:
    """Current value of one adaptive-controller knob (set on every
    actuation and at arm/restore): the convergence read — CI and the
    bench compare this against the hand-tuned optimum."""
    if knob not in ADAPTIVE_KNOBS:
        knob = LABEL_FOLD
    REGISTRY.gauge_set("gatekeeper_tpu_adaptive_knob_value",
                       "Current value of each adaptive-controller "
                       "knob", float(value), knob=knob)


def report_degradation_rung(rung: int) -> None:
    """Current degradation-ladder rung, twice over: a plain gauge
    (0=normal .. 3=fail_stance, the alerting read) and a per-rung
    transition counter (how often the plane ENTERED each rung)."""
    idx = min(len(DEGRADATION_RUNGS) - 1, max(0, int(rung)))
    name = DEGRADATION_RUNGS[idx]
    if name not in DEGRADATION_RUNGS:
        name = LABEL_FOLD  # unreachable; keeps the fold discipline
    REGISTRY.gauge_set("gatekeeper_tpu_degradation_rung",
                       "Current degradation-ladder rung (0=normal, "
                       "1=tighten_shed, 2=cache_only, 3=fail_stance)",
                       idx)
    REGISTRY.counter_add("gatekeeper_tpu_degradation_transitions_total",
                         "Degradation-ladder entries by rung",
                         rung=name)


def report_decision_cache(outcome: str, n: int = 1) -> None:
    """One admission decision-cache consultation: hit (verdict served
    without evaluation), miss (evaluated and cached), or bypass (the
    request is uncacheable — traced, or a deny under --log-denies where
    every denial must re-log)."""
    if outcome not in DECISION_CACHE_OUTCOMES:
        outcome = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_admission_decision_cache_total",
                         "Admission decision cache lookups by outcome",
                         n, outcome=outcome)


def report_admission_workers(configured: int, connected: int) -> None:
    """Serving-plane topology gauge: --admission-workers as configured
    and the number of frontend processes currently connected to the
    engine backplane (equal when the plane is healthy)."""
    REGISTRY.gauge_set("gatekeeper_tpu_admission_workers",
                       "Admission frontend worker processes",
                       configured, state="configured")
    REGISTRY.gauge_set("gatekeeper_tpu_admission_workers",
                       "Admission frontend worker processes",
                       connected, state="connected")


def report_admission_engines(configured: int, alive: int) -> None:
    """N-engine plane topology gauge: --admission-engines as configured
    and the number of engine processes currently alive (the in-process
    engine counts; a crashed child dips this until its respawn)."""
    REGISTRY.gauge_set("gatekeeper_tpu_admission_engines",
                       "Admission engine processes (one per chip)",
                       configured, state="configured")
    REGISTRY.gauge_set("gatekeeper_tpu_admission_engines",
                       "Admission engine processes (one per chip)",
                       alive, state="alive")


# chaos & recovery: the orchestrator's recovery clock and the
# supervisors' respawn-storm rate limiting, exported as data so MTTR
# is a dashboard read, not a log grep. Bounded label sets with the
# fold discipline like every other enumerated label.
RECOVERY_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0,
                    60.0, 120.0)
CHAOS_COMPONENTS = ("frontend", "engine", "audit_shard", "leader",
                    "apiserver", "backplane", "state")
CHAOS_FAULT_KINDS = ("kill", "pause", "death", "wedge", "flap", "wire",
                     "corrupt", "disk")
SUPERVISOR_KINDS = ("frontend", "engine", "audit")


def report_fault_recovery(component: str, fault: str,
                          seconds: float) -> None:
    """One completed recovery: the wall clock from fault detection (a
    child seen dead/wedged, a flap's first error) to the plane healthy
    again (respawned AND resynced / breaker closed). The MTTR series
    bench config 15 distills into its headline matrix."""
    if component not in CHAOS_COMPONENTS:
        component = LABEL_FOLD
    if fault not in CHAOS_FAULT_KINDS:
        fault = LABEL_FOLD
    REGISTRY.observe("gatekeeper_tpu_fault_recovery_seconds",
                     "Fault-to-recovered wall clock by component and "
                     "fault kind", seconds, buckets=RECOVERY_BUCKETS,
                     component=component, fault=fault)


def report_respawn_backoff(supervisor: str, seconds: float) -> None:
    """Current respawn-backoff delay one supervisor is holding (0 when
    its children are healthy): a sustained non-zero value is a child
    stuck in a crash loop, rate-limited instead of hot-looping."""
    if supervisor not in SUPERVISOR_KINDS:
        supervisor = LABEL_FOLD
    REGISTRY.gauge_set("gatekeeper_tpu_respawn_backoff_seconds",
                       "Current jittered-exponential respawn delay per "
                       "supervisor (0 = healthy)", seconds,
                       supervisor=supervisor)


def report_crashloop_breaker(supervisor: str, tripped: bool) -> None:
    """Crash-loop breaker state per supervisor: 1 after a child has
    died CRASHLOOP_TRIP consecutive times faster than the healthy
    threshold (respawns continue at the capped delay); back to 0 once
    a child survives past it."""
    if supervisor not in SUPERVISOR_KINDS:
        supervisor = LABEL_FOLD
    REGISTRY.gauge_set("gatekeeper_tpu_crashloop_breaker",
                       "1 while a supervisor's child is in a detected "
                       "crash loop (respawn delay capped)",
                       1.0 if tripped else 0.0, supervisor=supervisor)


def zero_supervisor_gauges(supervisor: str) -> None:
    """Teardown zeroing for the supervisor-labeled chaos gauges (the
    stale-export discipline): a stopped supervisor must not
    export its last backoff/breaker state forever."""
    report_respawn_backoff(supervisor, 0.0)
    report_crashloop_breaker(supervisor, False)


def gauge_series(name: str) -> dict[tuple, float]:
    """Label-values-tuple -> current value for one gauge family (empty
    when the family never registered). The chaos verifier's stale-gauge
    invariant reads the gklint lifecycle families through this after
    teardown: every series must be zero."""
    m = REGISTRY._metrics.get(name)
    if m is None:
        return {}
    with m.lock:
        return dict(m.values)


# counters/histograms an engine child relays to the primary over the
# backplane M frame (all monotonic — the delta merge assumes it), so
# shed accounting, decision counts, cache outcomes, and per-engine
# stage histograms stay GLOBAL on the primary's /metrics across every
# engine process
ENGINE_RELAY_METRICS = (
    "request_count",
    "request_duration_seconds",
    "admission_requests_shed_total",
    "admission_batch_timeouts",
    "gatekeeper_tpu_admission_decision_cache_total",
    "gatekeeper_tpu_engine_requests_total",
    "gatekeeper_tpu_stage_duration_seconds",
    "gatekeeper_tpu_traces_total",
    # batch economics relay so per-chip seal reasons / fill ratios
    # aggregate on the primary's /metrics like every other counter
    "gatekeeper_tpu_batch_seal_total",
    "gatekeeper_tpu_batch_fill_ratio",
    # saturation GAUGES (engine-/worker-labeled series, merged by
    # last-value): per-chip duty cycle and queue depth must read off
    # the primary's one scrape, not just for engine 0
    "gatekeeper_tpu_queue_depth",
    "gatekeeper_tpu_device_duty_cycle",
    "gatekeeper_tpu_backplane_inflight",
    # frontends ship S-frame deltas to whichever engine answers; a
    # child that received them relays the merged result up
    "gatekeeper_tpu_backplane_forward_duration_seconds",
    "gatekeeper_tpu_backplane_errors_total",
    # shm-ring path counts (counter) + per-frontend request-ring fill
    # (gauge, merged by last value like the other saturation gauges)
    "gatekeeper_tpu_backplane_ring_total",
    "gatekeeper_tpu_backplane_ring_fill_ratio",
)


def engine_stats_snapshot() -> dict:
    """What an engine child answers the primary's M-frame poll with."""
    return REGISTRY.snapshot(ENGINE_RELAY_METRICS)


def merge_engine_stats(cur: dict, prev: dict) -> None:
    """Primary-side merge of one engine child's polled totals."""
    REGISTRY.merge_snapshot_delta(cur, prev)


# frontends bucket their forward latencies locally with these bounds and
# ship aggregated deltas over the backplane stats frame
FORWARD_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 5.0)


def report_backplane_forward(worker: str, bucket_counts: list,
                             sum_: float, count: int) -> None:
    """Merge one frontend's forward-latency histogram delta (enqueue on
    the frontend to verdict bytes received back over the backplane)."""
    REGISTRY.observe_bucketed(
        "gatekeeper_tpu_backplane_forward_duration_seconds",
        "Frontend-observed latency of one review forwarded over the "
        "backplane to the engine and answered", FORWARD_BUCKETS,
        bucket_counts, sum_, count, worker=worker)


def report_backplane_error(worker: str, n: int = 1) -> None:
    REGISTRY.counter_add(
        "gatekeeper_tpu_backplane_errors_total",
        "Reviews a frontend answered per the failure stance because the "
        "engine backplane was unreachable", n, worker=worker)


def report_backplane_ring(worker: str, path: str, n: int = 1) -> None:
    """Shared-memory ring usage per forwarded review: path=ring means
    the review crossed the backplane as a descriptor (zero payload
    copies on the socket), path=inline means it fell back to the
    payload frame (ring exhausted by a burst, oversized review, or the
    engine declined the attach). A rising inline share under load is
    the 'grow --admission-shm-ring-mb' signal."""
    if path not in RING_PATHS:
        path = LABEL_FOLD
    REGISTRY.counter_add(
        "gatekeeper_tpu_backplane_ring_total",
        "Backplane forwards by payload path (ring descriptor vs inline "
        "fallback)", n, worker=worker, path=path)


def report_ring_fill(worker: str, fill: float) -> None:
    """Sampled used fraction of one frontend's request ring (shipped
    in its S-frame stats; zeroed when the frontend's connection dies).
    Sustained values near the allocation watermark mean bursts are
    spilling to the inline path."""
    REGISTRY.gauge_set(
        "gatekeeper_tpu_backplane_ring_fill_ratio",
        "Used fraction of a frontend's request ring (sampled per stats "
        "interval)", min(1.0, max(0.0, fill)), worker=worker)


_BREAKER_STATES = {"closed": 0, "half_open": 1, "open": 2}


def report_breaker(name: str, state: str) -> None:
    """Circuit breaker state gauge (0=closed, 1=half-open, 2=open) plus
    a transition counter so open->half-open->close cycles stay visible
    after the fact."""
    REGISTRY.gauge_set("gatekeeper_tpu_circuit_breaker_state",
                       "Circuit breaker state (0=closed, 1=half-open, "
                       "2=open)", _BREAKER_STATES.get(state, 2),
                       breaker=name)
    REGISTRY.counter_add("gatekeeper_tpu_circuit_breaker_transitions_total",
                         "Circuit breaker transitions by target state",
                         breaker=name, to=state)


def report_kube_write(outcome: str) -> None:
    """One guarded kube write by outcome: ok, retried_ok, failed,
    breaker_open (refused locally), budget_exhausted (retry budget
    empty)."""
    if outcome not in KUBE_WRITE_OUTCOMES:
        outcome = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_kube_writes_total",
                         "Guarded kube API writes by outcome",
                         outcome=outcome)


def report_template_quarantine(kind: str, quarantined: bool) -> None:
    """Device-path quarantine flag per template kind: 1 while the
    compiled program is benched (reviews serve from the interpreter), 0
    once the probe sweep succeeds and the device path is restored."""
    REGISTRY.gauge_set("gatekeeper_tpu_template_quarantined",
                       "1 while the template's device program is "
                       "quarantined after eval failures (interpreter "
                       "fallback serves its reviews)",
                       1 if quarantined else 0, kind=kind)


def report_mutation_request(admission_status: str, seconds: float) -> None:
    """One /v1/mutate decision (reference mutation stats reporter
    metric names)."""
    REGISTRY.counter_add("mutation_request_count",
                         "Count of mutation admission requests",
                         admission_status=admission_status)
    REGISTRY.observe("mutation_request_duration_seconds",
                     "Latency of mutation admission requests", seconds,
                     admission_status=admission_status)


def report_mutator_ingestion(status: str, seconds: float) -> None:
    if status not in INGESTION_STATUSES:
        status = LABEL_FOLD
    REGISTRY.counter_add("mutator_ingestion_count",
                         "Count of mutator ingestion actions by outcome",
                         status=status)
    REGISTRY.observe("mutator_ingestion_duration_seconds",
                     "Latency of mutator ingestion", seconds, status=status)


def report_mutators(counts: dict) -> None:
    """Cached-mutator gauges: per-kind counts plus the schema-conflict
    quarantine size ({"Assign": n, ..., "conflicting": n})."""
    for key, count in counts.items():
        if key == "conflicting":
            REGISTRY.gauge_set("mutator_conflicting_count",
                               "Mutators quarantined by the schema "
                               "conflict detector", count)
        else:
            REGISTRY.gauge_set("mutators",
                               "Current number of cached mutators", count,
                               kind=key)


def report_constraints(action: str, count: int) -> None:
    REGISTRY.gauge_set("constraints", "Current number of known constraints",
                       count, enforcement_action=action)


def report_constraint_templates(status: str, count: int) -> None:
    if status not in INGESTION_STATUSES:
        status = LABEL_FOLD
    REGISTRY.gauge_set("constraint_templates",
                       "Number of observed constraint templates", count,
                       status=status)


def report_template_ingestion(status: str, seconds: float) -> None:
    if status not in INGESTION_STATUSES:
        status = LABEL_FOLD
    REGISTRY.observe("constraint_template_ingestion_duration_seconds",
                     "Latency of constraint template ingestion", seconds,
                     status=status)


def report_sync(status: str, kind: str, count: int) -> None:
    if status not in INGESTION_STATUSES:
        status = LABEL_FOLD
    REGISTRY.gauge_set("sync", "Total number of resources replicated into "
                       "OPA", count, status=status, kind=kind)


def report_sync_duration(seconds: float) -> None:
    REGISTRY.observe("sync_duration_seconds", "Latency of sync operation",
                     seconds)


def report_last_sync(ts: Optional[float] = None) -> None:
    REGISTRY.gauge_set("sync_last_run_time", "Timestamp of last sync",
                       ts if ts is not None else time.time())


def report_compile_fallback(kind: str, reason: str) -> None:
    """One template kind falling back to the interpreter at ingestion,
    labeled by the stable Uncompilable reason CODE (ir/compile.py
    REASON_CODES — a bounded set, never free prose). Operators read
    this next to /debug/templates' per-kind fallback detail to see WHY
    a kind audits at Python speed instead of the device path."""
    # gklint: allow(metrics) reason=reason is Uncompilable.code, folded to the bounded REASON_CODES set in ir/compile.py (unknown->internal)
    REGISTRY.counter_add("gatekeeper_tpu_compile_fallback_total",
                         "Template kinds that fell back to the "
                         "interpreter at ingestion, by Uncompilable "
                         "reason code", kind=kind, reason=reason)


def report_device_demotion(kind: str, reason: str) -> None:
    if reason not in DEMOTION_REASONS:
        reason = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_device_demotions_total",
                         "Templates demoted from the device path to the "
                         "interpreter (a ~10^4x per-eval slowdown; should "
                         "stay 0 in steady state)", kind=kind, reason=reason)


def report_device_programs(warm: int, compiling: int) -> None:
    REGISTRY.gauge_set("gatekeeper_tpu_device_programs_warm",
                       "Device sweep programs whose XLA compilation has "
                       "completed (audits at these shapes run on the "
                       "device)", warm)
    REGISTRY.gauge_set("gatekeeper_tpu_device_programs_compiling",
                       "Device sweep programs currently compiling in the "
                       "background (audits serve from the host meanwhile)",
                       compiling)


def report_compile(source: str, outcome: str, seconds: float) -> None:
    """One device-program acquisition: source "aot" (deserialized from
    the AOT program store), "cache" (lower+compile answered by the
    persistent XLA cache), or "fresh" (cold XLA compile)."""
    if outcome not in COMPILE_OUTCOMES:
        outcome = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_compile_total",
                         "Device program acquisitions by source "
                         "(aot=deserialized executable, cache=persistent-"
                         "XLA-cache compile, fresh=cold compile) and "
                         "outcome", source=source, outcome=outcome)
    if outcome == "ok":
        REGISTRY.observe("gatekeeper_tpu_compile_seconds",
                         "Seconds spent acquiring device programs "
                         "(AOT deserialize or lower+compile)", seconds,
                         source=source)


def report_compile_cache(enabled: bool) -> None:
    REGISTRY.gauge_set("gatekeeper_tpu_compile_cache_enabled",
                       "1 when the persistent XLA compilation cache is "
                       "active; 0 means every restart recompiles (check "
                       "the cache dir volume/permissions)",
                       1.0 if enabled else 0.0)


def report_aot_store(enabled: bool, programs: int = 0) -> None:
    REGISTRY.gauge_set("gatekeeper_tpu_aot_store_enabled",
                       "1 when the AOT serialized-program store is "
                       "active (warm boots deserialize device programs "
                       "instead of recompiling)", 1.0 if enabled else 0.0)
    REGISTRY.gauge_set("gatekeeper_tpu_aot_store_programs",
                       "Serialized device programs in the AOT store",
                       programs)


def report_audit_sweep(path: str) -> None:
    """One audit sweep took `path`: "incremental" (delta-applied encoded
    inventory), "full_resync" (the periodic from-scratch re-encode
    backstop), or "full" (discovery / cache sweep without delta
    tracking)."""
    if path not in AUDIT_SWEEP_PATHS:
        path = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_audit_sweeps_total",
                         "Audit sweeps by evaluation path", path=path)


def report_materialize_pairs(path: str, n: int) -> None:
    """Firing (review, constraint) pairs the audit materialized, by
    message path: "vectorized" (numpy plan assembly, ir/vecmat.py),
    "exact" (per-pair evaluator — plan-less kinds and vetoed pairs),
    "capped" (past the per-constraint status cap: counted, message
    skipped)."""
    if path not in MATERIALIZE_PATHS:
        path = LABEL_FOLD
    if n > 0:
        REGISTRY.counter_add("gatekeeper_tpu_audit_materialize_pairs_total",
                             "Materialized firing pairs by message path",
                             float(n), path=path)


def report_msg_template_cache(outcome: str) -> None:
    """Message-plan cache lookup for one materialize batch: "hit" (plan
    reused), "miss" (plan compiled from the template head this call)."""
    if outcome not in CACHE_OUTCOMES:
        outcome = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_audit_msg_template_cache_total",
                         "Message-template plan cache lookups",
                         outcome=outcome)


def report_audit_dirty(dirty: int, total: int, vocab_grown: int = 0) -> None:
    """Incremental audit delta stats: dirty-set size, tracked inventory
    size, encoded-row cache hit ratio, and vocab growth this sweep."""
    REGISTRY.gauge_set("gatekeeper_tpu_audit_dirty_objects",
                       "Objects re-encoded by the last incremental audit "
                       "sweep (adds + updates + deletes applied)", dirty)
    REGISTRY.gauge_set("gatekeeper_tpu_audit_inventory_objects",
                       "Objects in the audit's tracked encoded inventory",
                       total)
    REGISTRY.gauge_set("gatekeeper_tpu_audit_cache_hit_ratio",
                       "Fraction of the inventory served from the encoded "
                       "cache by the last incremental sweep",
                       1.0 if total <= 0 else max(0.0, 1.0 - dirty / total))
    REGISTRY.gauge_set("gatekeeper_tpu_intern_strings_added",
                       "Strings interned during the last audit sweep "
                       "(vocabulary growth from churned label values)",
                       vocab_grown)


# violation detection latency: watch-event receipt -> the status write
# (or no-op confirmation) that published the verdict. Sub-second when
# the streaming audit is on; ~audit-interval/2 + sweep time without it.
DETECTION_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0, 60.0, 300.0)


def report_violation_detection(seconds: float, n: int = 1) -> None:
    """One (or n batched) watch events fully detected: received,
    evaluated against the encoded inventory, and reflected in
    constraint status — the streaming audit's headline latency."""
    for _ in range(n):
        REGISTRY.observe("gatekeeper_tpu_violation_detection_seconds",
                         "Latency from watch-event receipt to the "
                         "constraint-status write reflecting it "
                         "(event -> status)", seconds,
                         buckets=DETECTION_BUCKETS)


def report_stream_flush(outcome: str, n: int = 1) -> None:
    """One streaming-audit flush by outcome: ok (evaluated + statuses
    current), error (evaluation or write failed; the interval backstop
    repairs), or skipped (follower replica drained without writing)."""
    if outcome not in STREAM_FLUSH_OUTCOMES:
        outcome = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_stream_flushes_total",
                         "Streaming-audit dirty-row flushes by outcome",
                         n, outcome=outcome)


def report_backstop_drift(writes: int) -> None:
    """Status writes the interval reconciliation sweep had to issue
    while the streaming path was supposed to keep statuses current —
    each one is drift the event pipeline missed (or an external
    clobber it repaired). Should stay 0 in steady state."""
    if writes > 0:
        REGISTRY.counter_add("gatekeeper_tpu_audit_backstop_drift_total",
                             "Constraint-status drift repaired by the "
                             "interval reconciliation sweep while "
                             "streaming detection was active", writes)


def report_preview(outcome: str, seconds: float) -> None:
    """One what-if preview evaluation (candidate template/constraint
    swept against the full encoded inventory) by outcome."""
    if outcome not in PREVIEW_OUTCOMES:
        outcome = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_preview_requests_total",
                         "What-if preview evaluations by outcome",
                         outcome=outcome)
    if outcome == "ok":
        REGISTRY.observe("gatekeeper_tpu_preview_duration_seconds",
                         "Wall clock of one what-if preview sweep over "
                         "the cached inventory", seconds,
                         buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                                  10.0, 30.0, 60.0, 300.0))


def report_audit_status_writes(written: int, skipped: int) -> None:
    """Constraint-status write deltas: PATCHes issued vs skipped because
    the constraint's violation set was unchanged since the last write."""
    REGISTRY.counter_add("gatekeeper_tpu_audit_status_writes_total",
                         "Constraint status updates by outcome",
                         written, result="written")
    REGISTRY.counter_add("gatekeeper_tpu_audit_status_writes_total",
                         "Constraint status updates by outcome",
                         skipped, result="skipped")


def report_snapshot(op: str, outcome: str) -> None:
    """One state-snapshot save or restore by outcome. Save outcomes:
    ok | error (previous snapshot kept). Restore outcomes: ok | missing
    (no snapshot; plain cold start) | fallback (snapshot present but
    corrupt/stale/unusable — the pod proceeds down the cold path, never
    crash-loops)."""
    if outcome not in SNAPSHOT_OUTCOMES:
        outcome = LABEL_FOLD
    name = ("gatekeeper_tpu_snapshot_save_total" if op == "save"
            else "gatekeeper_tpu_snapshot_restore_total")
    REGISTRY.counter_add(name, f"State snapshot {op}s by outcome",
                         outcome=outcome)


def report_snapshot_age(seconds: float) -> None:
    REGISTRY.gauge_set("gatekeeper_tpu_snapshot_age_seconds",
                       "Age of the newest durable state snapshot (0 "
                       "right after a save; restart data-loss window is "
                       "bounded by this)", seconds)


def report_leader(is_leader: bool) -> None:
    """Leader-election state: both label series are kept so a flip is a
    visible edge on each (alerting on sum(gatekeeper_tpu_leader{
    is_leader=\"true\"}) != 1 catches split/no leader)."""
    REGISTRY.gauge_set("gatekeeper_tpu_leader",
                       "1 when this replica holds the leader lease "
                       "(audit sweep + status writers run here)",
                       1 if is_leader else 0, is_leader="true")
    REGISTRY.gauge_set("gatekeeper_tpu_leader",
                       "1 when this replica holds the leader lease "
                       "(audit sweep + status writers run here)",
                       0 if is_leader else 1, is_leader="false")


# per-stage latency bounds: admission stages live in the sub-ms to
# seconds range, audit phases run to minutes — one bound set covers
# both planes (the metric is shared, and bucket bounds are frozen at
# first registration)
STAGE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                 30.0, 60.0, 120.0)

_STAGE_HELP = ("Latency of one named pipeline stage of a SAMPLED "
               "request (admission plane) or sweep phase (audit "
               "plane), from the request-scoped trace layer")


def _stage_engine(plane: str, engine) -> str:
    """Admission-plane stages carry the recording engine process's id
    (multi-engine planes decompose per chip); audit-plane phases are
    plane-global (their per-shard twin is the audit_shard histogram)."""
    if engine is not None:
        return str(engine)
    return _ENGINE_ID if plane == "admission" else ""


def report_stage(plane: str, stage: str, seconds: float,
                 engine: Optional[str] = None,
                 trace_id: Optional[str] = None) -> None:
    """One span of a sampled trace: the per-stage latency histogram
    that decomposes an admission p99 (or an audit sweep duration) into
    its pipeline stages. `trace_id` attaches as the bucket's
    OpenMetrics exemplar, so a slow bucket resolves to its
    /debug/traces flight-recorder entry."""
    REGISTRY.observe("gatekeeper_tpu_stage_duration_seconds",
                     _STAGE_HELP, seconds, buckets=STAGE_BUCKETS,
                     exemplar=trace_id,
                     plane=plane, stage=stage,
                     engine=_stage_engine(plane, engine))


def report_stage_bucketed(plane: str, stage: str, bucket_counts: list,
                          sum_: float, count: int,
                          engine: Optional[str] = None) -> None:
    """Merge a frontend's pre-aggregated stage-histogram delta (the
    frontends time their own stages — frontend_parse, the backplane
    forward — and ship them over the S frame like the forward-latency
    histogram; replaying spans one at a time over the wire would cost
    more than the stages being measured)."""
    REGISTRY.observe_bucketed("gatekeeper_tpu_stage_duration_seconds",
                              _STAGE_HELP, STAGE_BUCKETS, bucket_counts,
                              sum_, count, plane=plane, stage=stage,
                              engine=_stage_engine(plane, engine))


def report_scan_manifests(outcome: str, n: int = 1) -> None:
    """Fleet-scan manifest accounting by outcome: allow/deny verdicts,
    error records (malformed or unevaluated manifests — never silently
    dropped), dedup rejoins (verdict served by content hash without a
    wire trip), and skipped non-k8s documents."""
    if outcome not in SCAN_OUTCOMES:
        outcome = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_scan_manifests_total",
                         "Fleet-scan manifests by outcome",
                         n, outcome=outcome)


def report_scan_batch(tier: str, seconds: float) -> None:
    """One fleet-scan bulk batch round trip (begin to verdict receipt)
    on one wire tier — the feed-side read of whether the loader
    pipeline keeps the engine saturated (compare against the engine's
    own evaluate stage)."""
    if tier not in SCAN_TIERS:
        tier = LABEL_FOLD
    REGISTRY.counter_add("gatekeeper_tpu_scan_batches_total",
                         "Fleet-scan bulk batches completed per wire "
                         "tier", tier=tier)
    REGISTRY.observe("gatekeeper_tpu_scan_batch_duration_seconds",
                     "Fleet-scan bulk batch round-trip latency",
                     seconds, buckets=STAGE_BUCKETS, tier=tier)


def report_audit_shard(stage: str, shard: int, seconds: float) -> None:
    """Per-SHARD audit stage timing from the mesh slab loop: how one
    data shard's violation materialization (or its share of the sweep)
    costs, so a skewed shard — one device's slab carrying all the
    violating rows — is visible instead of averaged away."""
    REGISTRY.observe("gatekeeper_tpu_audit_shard_duration_seconds",
                     "Per-data-shard latency of one audit pipeline "
                     "stage in the mesh slab loop",
                     seconds, buckets=STAGE_BUCKETS,
                     stage=stage, shard=str(shard))


def report_audit_shard_fleet(configured: int, alive: int) -> None:
    """The sharded inventory plane's process census (AuditShard-
    Supervisor): configured vs currently-alive shard children. A
    sustained gap means a shard is crash-looping and its partition is
    being re-swept by the leader every round."""
    REGISTRY.gauge_set("gatekeeper_tpu_audit_shard_processes",
                       "Configured audit shard processes",
                       configured, state="configured")
    REGISTRY.gauge_set("gatekeeper_tpu_audit_shard_processes",
                       "Configured audit shard processes",
                       alive, state="alive")


def report_audit_shard_ownership(shard: int, objects: int) -> None:
    """Objects currently owned by one audit shard's inventory slice.
    Watch the SKEW, not the level: consistent hashing balances
    (GVK, namespace) partitions, so one towering shard means one hot
    namespace or a cluster-scoped kind pinning its whole population."""
    REGISTRY.gauge_set("gatekeeper_tpu_audit_shard_owned_objects",
                       "Inventory objects owned per audit shard",
                       objects, shard=str(shard))


def report_audit_shard_map(version: int, shards: int) -> None:
    """The leader's current shard-map assignment epoch. Bumps on every
    (re)build of the consistent-hash ring — a map that keeps bumping
    is a plane that keeps resizing."""
    REGISTRY.gauge_set("gatekeeper_tpu_audit_shard_map_version",
                       "Audit shard map assignment epoch", version)
    REGISTRY.gauge_set("gatekeeper_tpu_audit_shard_map_shards",
                       "Audit shard count in the active map", shards)


def report_audit_shard_rebalanced(moved: int) -> None:
    REGISTRY.counter_add("gatekeeper_tpu_audit_shard_rebalanced_total",
                         "Partitions moved between audit shards by "
                         "shard-map rebalances", float(moved))


def report_audit_shard_resync(shard: int) -> None:
    REGISTRY.counter_add("gatekeeper_tpu_audit_shard_resyncs_total",
                         "Full slice resyncs per audit shard (respawn "
                         "heals and replication-failure repairs)",
                         shard=str(shard))


def report_audit_shard_sweep(shard: int, seconds: float,
                             reviews: int) -> None:
    """One shard PROCESS's slice sweep (distinct from the mesh slab
    histogram above, which times device shards within one process)."""
    REGISTRY.observe("gatekeeper_tpu_audit_shard_sweep_seconds",
                     "Wall time of one audit shard process's slice "
                     "sweep", seconds, buckets=STAGE_BUCKETS,
                     shard=str(shard))
    REGISTRY.gauge_set("gatekeeper_tpu_audit_shard_swept_reviews",
                       "Reviews evaluated in the last slice sweep per "
                       "audit shard", reviews, shard=str(shard))


def report_trace(plane: str) -> None:
    REGISTRY.counter_add("gatekeeper_tpu_traces_total",
                         "Sampled traces completed per plane",
                         plane=plane)


def report_watch_manager(gvk_count: int, intended: int) -> None:
    REGISTRY.gauge_set("watch_manager_watched_gvk",
                       "Total number of watched GroupVersionKinds",
                       gvk_count)
    REGISTRY.gauge_set("watch_manager_intended_watch_gvk",
                       "Total number of GroupVersionKinds the watch manager "
                       "intends to watch", intended)
