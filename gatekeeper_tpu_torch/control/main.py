"""Process entrypoint.

Counterpart of the reference main.go:99-252: flag surface, logging setup,
client construction over the card's driver (TorchDriver, --device),
controller/watch/webhook/audit/upgrade/metrics wiring, graceful
teardown. The same process serves either or both operations (--operation
webhook / audit; both when unset, main.go:114-118).

Run:  python -m gatekeeper_tpu_torch.control.main --operation audit ...

Without a card, `--device cpu` evaluates with the kernels' plain
versions; the default, `cuda`, raises at Runtime construction there.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from ..client import Backend
from ..target import K8sValidationTarget
from . import chaos as chaos_debug
from . import health
from . import logging as glog
from . import metrics
from . import trace as gtrace
from .audit import (
    DEFAULT_AUDIT_INTERVAL,
    DEFAULT_CONSTRAINT_VIOLATIONS_LIMIT,
    DEFAULT_FULL_RESYNC_EVERY,
    AuditManager,
)
from ..utils.faults import FAULTS
from .certs import CertRotator
from .controllers import ControllerManager
from .kube import FakeKube, RestKubeClient
from .resilience import CircuitBreaker, GuardedKube, RetryBudget
from .upgrade import UpgradeManager
from .webhook import (
    MicroBatcher,
    MutationHandler,
    NamespaceLabelHandler,
    ValidationHandler,
    WebhookServer,
)

log = glog.logger("main")

# a warm boot's audit loop waits at most this long for the restored rows'
# load and the program store's prewarm before its first sweep
# (Runtime._start_audit)
RESTORE_GATE_S = 120.0


def _child_device_args(args) -> list:
    """The primary's --device for its engine and audit-shard children.
    On the card each child keeps the supervisor's `--device k` (card k
    modulo the visible cards); a primary elsewhere (`cpu`, `cuda:1`)
    passes its own, after `--device k` on the child's command line, so
    the child's parser takes it."""
    device = getattr(args, "device", "cuda")
    return [] if device == "cuda" else ["--device", device]


def _card_count(driver) -> int:
    """The cards an engine plane can pin: torch.cuda.device_count() for
    a driver on the card, 1 for a driver on the CPU."""
    if getattr(getattr(driver, "device", None), "type", "cpu") != "cuda":
        return 1
    import torch

    return torch.cuda.device_count()


def _parse_fail_closed(value: str) -> bool:
    """--fail-closed value parser: booleans or the webhook
    failurePolicy spellings, so deploy templating can feed the one
    failurePolicy value to both the API object and this process."""
    v = str(value).strip().lower()
    if v in ("true", "1", "yes", "fail"):
        return True
    if v in ("false", "0", "no", "ignore"):
        return False
    raise argparse.ArgumentTypeError(
        f"cannot parse {value!r}; use true/false or Fail/Ignore")


def _parse_bool(value: str) -> bool:
    """Plain boolean flag values (chart templating renders YAML bools
    as True/False; accept every common spelling)."""
    v = str(value).strip().lower()
    if v in ("true", "1", "yes", "on"):
        return True
    if v in ("false", "0", "no", "off"):
        return False
    raise argparse.ArgumentTypeError(f"cannot parse {value!r} as a bool")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gatekeeper-tpu",
        description="Kubernetes admission/audit policy engine on an "
                    "NVIDIA card (PyTorch/CUDA)",
    )
    # flag parity with the reference (SURVEY.md §5 config/flag system)
    p.add_argument("--operation", action="append", default=None,
                   choices=["webhook", "audit", "mutation-webhook"],
                   help="operations to run; repeatable; webhook+audit "
                        "when unset (mutation-webhook must be requested "
                        "explicitly)")
    p.add_argument("--port", type=int, default=8443)
    p.add_argument("--cert-dir", default="/certs")
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--metrics-backend", default="prometheus")
    p.add_argument("--prometheus-port", type=int, default=8888)
    p.add_argument("--health-addr", default=":9090")
    p.add_argument("--audit-interval", type=float,
                   default=DEFAULT_AUDIT_INTERVAL)
    p.add_argument("--constraint-violations-limit", type=int,
                   default=DEFAULT_CONSTRAINT_VIOLATIONS_LIMIT)
    p.add_argument("--audit-from-cache", default="false")
    p.add_argument("--audit-incremental", default="false",
                   help="maintain a persistent watch-fed encoded "
                        "inventory and audit only the delta each sweep "
                        "(steady-state sweeps patch dirty rows instead "
                        "of re-encoding the cluster)")
    p.add_argument("--audit-full-resync-every", type=int,
                   default=DEFAULT_FULL_RESYNC_EVERY,
                   help="with --audit-incremental: every Nth sweep "
                        "re-lists and re-encodes the whole inventory "
                        "from scratch (self-healing backstop); 0 "
                        "disables the periodic re-encode (the first "
                        "sweep still encodes from scratch)")
    p.add_argument("--audit-shards", type=int, default=1,
                   help="partition the audit inventory across N audit "
                        "engine processes by consistent hash of (GVK, "
                        "namespace). Each shard owns its slice end to "
                        "end — encoded feature rows, delta cache, "
                        "incremental sweep state — in its own process "
                        "pinned to its own device; the leader tracks "
                        "per-slice watches, broadcasts join-relevant "
                        "columns, and composes per-shard sweeps into "
                        "one bit-equal audit round. 1 = unsharded")
    p.add_argument("--stream-audit", nargs="?", const=True,
                   default=False, type=_parse_bool,
                   help="with --audit-incremental: evaluate dirty rows "
                        "AS WATCH EVENTS ARRIVE (micro-batched by "
                        "--stream-window-ms) and publish changed "
                        "constraint statuses immediately — violation "
                        "detection latency (event -> status, the "
                        "gatekeeper_tpu_violation_detection_seconds "
                        "histogram) drops from up to a full "
                        "--audit-interval to milliseconds. The interval "
                        "sweep is demoted to a reconciliation backstop "
                        "that reports any drift it had to repair "
                        "(gatekeeper_tpu_audit_backstop_drift_total)")
    p.add_argument("--stream-window-ms", type=float, default=25.0,
                   help="streaming-audit debounce: after the first "
                        "buffered watch event, wait this long for the "
                        "burst to coalesce before flushing (a full "
                        "--stream-max-batch flushes early)")
    p.add_argument("--stream-max-batch", type=int, default=512,
                   help="streaming-audit early-flush threshold: pending "
                        "dirty events at or beyond this count flush "
                        "without waiting out the window")
    p.add_argument("--preview-endpoint", nargs="?", const=True,
                   default=True, type=_parse_bool,
                   help="serve POST /v1/preview (what-if evaluation of "
                        "a candidate ConstraintTemplate/Constraint over "
                        "the full cached inventory, without enforcing "
                        "it) on the webhook port; see also "
                        "--preview-port for audit-only pods")
    p.add_argument("--preview-port", type=int, default=0,
                   help="ALSO serve /v1/preview on this dedicated "
                        "plaintext port (audit pods have no webhook "
                        "port but own the freshest inventory); 0 "
                        "disables the dedicated listener")
    p.add_argument("--log-denies", action="store_true")
    p.add_argument("--fail-closed", nargs="?", const=True, default=False,
                   type=_parse_fail_closed,
                   help="internal webhook errors DENY instead of the "
                        "default fail-open allow (match this to the "
                        "deployed failurePolicy); errored decisions are "
                        "reported as status=error either way. Bare flag "
                        "or a value: true/false or the failurePolicy "
                        "spelling Fail/Ignore. Applies to every webhook "
                        "unless --mutation-fail-closed overrides the "
                        "mutating one")
    p.add_argument("--mutation-fail-closed", nargs="?", const=True,
                   default=None, type=_parse_fail_closed,
                   help="failure stance of the MUTATING webhook only "
                        "(same value forms as --fail-closed; defaults "
                        "to --fail-closed when unset). The chart "
                        "templates --mutation-fail-closed="
                        "{{ .Values.mutations.failurePolicy }} so the "
                        "MutatingWebhookConfiguration and the process "
                        "flip together without touching the validating "
                        "webhook's stance")
    p.add_argument("--mutation-max-iterations", type=int, default=10,
                   help="convergence pass budget for the mutating "
                        "webhook; a review whose matched mutators still "
                        "change the object after N full passes errors "
                        "instead of admitting a half-mutated object")
    p.add_argument("--mutation-batch-max-wait", type=float, default=0.005,
                   help="mutating webhook micro-batch collection window "
                        "(seconds)")
    p.add_argument("--admission-max-queue", type=int, default=4096,
                   help="micro-batch queue depth beyond which admission "
                        "requests are SHED immediately with the failure-"
                        "stance verdict (status=shed) instead of "
                        "queueing into certain timeout; 0 = unbounded. "
                        "With --admission-workers > 1 the bound lives on "
                        "the ENGINE side of the backplane, so it stays "
                        "global across all frontends")
    p.add_argument("--admission-workers", type=int, default=1,
                   help="pre-forked HTTP frontend processes over the "
                        "shared batching backplane: each binds the "
                        "webhook port with SO_REUSEPORT and does accept/"
                        "TLS/parse only, forwarding reviews (with their "
                        "deadlines) over a Unix socket to THIS process — "
                        "the one engine owning the card and the micro-"
                        "batcher, so requests from all workers coalesce "
                        "into shared device micro-batches. 1 = serve "
                        "HTTP in-process (no backplane)")
    p.add_argument("--backplane-socket", default="",
                   help="Unix socket path for the frontend<->engine "
                        "backplane (default: a per-process path under "
                        "the system temp dir); only used with "
                        "--admission-workers > 1 or --admission-engines "
                        "> 1 (engine k > 0 listens on <socket>.<k>)")
    p.add_argument("--admission-engines", type=int, default=1,
                   help="admission ENGINE processes, one per chip: this "
                        "process stays engine 0; engines 1..N-1 are "
                        "spawned children (gatekeeper_tpu_torch."
                        "control.engine), each pinning card k and "
                        "owning its own Client/MicroBatcher behind its "
                        "own backplane socket. Frontends route reviews "
                        "by least-load (request-hash fallback) across "
                        "all engines and fail over mid-burst when one "
                        "dies, so admission_rps scales with chips. "
                        "Library mutations fan out to every engine "
                        "(each bumps its own decision-cache generation); "
                        "--admission-max-queue is divided across "
                        "engines so the shed bound stays global. "
                        "0 = one engine per visible device. Values > 1 "
                        "imply the backplane even with "
                        "--admission-workers 1")
    p.add_argument("--admission-shm-ring-mb", type=float, default=8.0,
                   help="shared-memory ring size (MB) per admission "
                        "frontend: review bytes ride a /dev/shm ring "
                        "and the backplane socket carries (offset, "
                        "length) descriptors only — zero payload "
                        "copies across the backplane on the happy "
                        "path, with automatic inline-frame fallback "
                        "when a burst outruns the engine. 0 disables "
                        "the rings (inline payload frames as before)")
    p.add_argument("--ingest-grpc", action="store_true",
                   help="serve the bulk gRPC/HTTP2 streaming ingest "
                        "endpoint (gatekeeper.v1.Policy ReviewStream/"
                        "ReviewBatch, evaluation-only surface) on "
                        "--ingest-port: CI scanners and service-mesh "
                        "authorizers pipeline pre-batched reviews "
                        "straight into the micro-batcher, skipping "
                        "HTTP/1.1 framing entirely")
    p.add_argument("--ingest-port", type=int, default=50061,
                   help="port for the --ingest-grpc streaming ingest "
                        "listener")
    p.add_argument("--admission-decision-cache", type=int, default=4096,
                   help="entries in the generation-keyed admission "
                        "decision cache (identical retries and object "
                        "storms skip evaluation; any template/"
                        "constraint/synced-data change invalidates via "
                        "the library generation). 0 disables")
    p.add_argument("--admission-default-timeout", type=float, default=10.0,
                   help="deadline (seconds) assumed for AdmissionReviews "
                        "that carry no request.timeoutSeconds; the "
                        "verdict ships before this minus a safety "
                        "margin, matching the API server's 10s webhook "
                        "default")
    p.add_argument("--kube-breaker-threshold", type=int, default=5,
                   help="consecutive kube WRITE failures that open the "
                        "shared circuit breaker (status writes defer, "
                        "readiness reports the open breaker)")
    p.add_argument("--kube-breaker-reset", type=float, default=30.0,
                   help="seconds an open kube-write breaker waits "
                        "before half-opening for a probe write")
    p.add_argument("--kube-retry-budget", type=float, default=10.0,
                   help="shared token budget for kube write RETRIES "
                        "(first attempts are free); refills at 1/s — "
                        "bounds retry amplification during API-server "
                        "outages")
    p.add_argument("--fault-injection", default="",
                   help="arm chaos faults, e.g. "
                        "'kube.write:error:503@0.5,webhook.flush:sleep:2'"
                        " (see gatekeeper_tpu_torch/utils/faults.py; "
                        "also via "
                        "GATEKEEPER_TPU_FAULTS)")
    p.add_argument("--state-dir", default="",
                   help="directory for durable state snapshots (the "
                        "warm-restart path: encoded inventory + watch-"
                        "resume resourceVersions, template/constraint/"
                        "mutator library, strtab vocab). Empty disables "
                        "snapshotting; a corrupt or stale snapshot "
                        "falls back to the cold start path, never a "
                        "crash loop")
    p.add_argument("--compile-cache-dir", default="",
                   help="persistent Triton kernel cache directory "
                        "(TRITON_CACHE_DIR; an explicit TRITON_CACHE_DIR "
                        "env var still wins). Point it at a volume so "
                        "restarts skip kernel compile time; pair with "
                        "--state-dir for the full warm boot from the "
                        "program store")
    p.add_argument("--aot-dir", default="",
                   help="program store directory (ir/aot.py): "
                        "compiled kernel variants are persisted here "
                        "and warm boots load them instead of "
                        "recompiling. Defaults to "
                        "<state-dir>/aot when --state-dir is set; empty "
                        "with no --state-dir disables the store (the "
                        "compile cache above still applies)")
    p.add_argument("--snapshot-interval", type=float, default=60.0,
                   help="seconds between periodic state snapshots "
                        "(also taken on SIGTERM drain; SIGHUP forces "
                        "one immediately); <= 0 disables the periodic "
                        "loop")
    p.add_argument("--leader-elect", nargs="?", const=True, default=False,
                   type=_parse_bool,
                   help="coordination.k8s.io/v1 Lease-based leader "
                        "election: only the lease holder runs the audit "
                        "sweep and controller/cert status writers, so "
                        "the deployment scales to replicas > 1 (every "
                        "replica still serves admission)")
    p.add_argument("--leader-lease-duration", type=float, default=15.0,
                   help="leader lease duration (seconds); failover after "
                        "a leader crash completes within one duration "
                        "(graceful shutdown releases the lease "
                        "immediately)")
    p.add_argument("--pod-name", default="",
                   help="stable pod identity for byPod statuses and the "
                        "leader lease (wire the downward-API "
                        "metadata.name here; falls back to $POD_NAME / "
                        "$HOSTNAME)")
    p.add_argument("--pod-namespace", default="",
                   help="namespace for the leader lease and status "
                        "bookkeeping (downward-API metadata.namespace; "
                        "falls back to $POD_NAMESPACE)")
    p.add_argument("--trace-sample-rate", type=float, default=0.01,
                   help="fraction of admission requests traced end to "
                        "end (stride-sampled; near-zero hot-path cost "
                        "when unsampled). Sampled requests answer "
                        "X-Trace-Id, decompose into per-stage spans in "
                        "gatekeeper_tpu_stage_duration_seconds, and "
                        "land in the /debug/traces flight recorder. An "
                        "inbound W3C traceparent with the sampled flag "
                        "always traces. Audit sweeps are always traced. "
                        "0 disables admission tracing")
    p.add_argument("--trace-slow-threshold", type=float, default=1.0,
                   help="seconds beyond which a completed trace also "
                        "logs a structured slow-request line with its "
                        "full stage decomposition; <= 0 disables")
    p.add_argument("--slo-admission-p99", type=float, default=0.1,
                   help="admission-latency SLO threshold (seconds): the "
                        "objective promises 99%% of admission decisions "
                        "complete under this, compiled against the "
                        "request_duration_seconds histogram into the "
                        "gatekeeper_tpu_slo_burn_rate{slo=\"admission_"
                        "p99_latency\"} gauges (5m/1h windows). Should "
                        "be one of the histogram's bucket bounds")
    p.add_argument("--slo-availability-target", type=float, default=0.999,
                   help="admission availability SLO target: at most "
                        "1-target of requests may end shed/timeout/"
                        "error (reads request_count). Burn rate 1.0 = "
                        "consuming the error budget exactly at the "
                        "sustained-compliance rate")
    p.add_argument("--slo-detection-p99", type=float, default=1.0,
                   help="violation-detection SLO threshold (seconds): "
                        "99%% of streaming-audit detections (watch "
                        "event -> status write) must complete under "
                        "this (reads gatekeeper_tpu_violation_"
                        "detection_seconds). Should be one of that "
                        "histogram's bucket bounds")
    p.add_argument("--slo-sample-interval", type=float, default=15.0,
                   help="seconds between SLO totals samples (the ring "
                        "spans the longest burn window at this "
                        "cadence); <= 0 disables the SLO engine, "
                        "burn-rate gauges, and /debug/slo")
    p.add_argument("--adaptive-control", nargs="?", const=True,
                   default=False, type=_parse_bool,
                   help="arm the closed-loop serving controller "
                        "(control/adaptive.py): samples burn rates, "
                        "seal mix/fill, queue depth, duty cycle and "
                        "actuates batch max_wait/max_batch, shed "
                        "depth, engine fan-out, and AOT pre-warm "
                        "inside declared bounds with hysteresis + "
                        "per-knob cooldowns, plus the degradation "
                        "ladder (normal -> tighten_shed -> cache_only "
                        "-> fail_stance). false (the default) is the "
                        "kill switch: knobs hold the configured "
                        "baselines bit-exactly")
    p.add_argument("--adaptive-interval", type=float, default=1.0,
                   help="seconds between adaptive-controller ticks")
    p.add_argument("--adaptive-hysteresis", type=float, default=10.0,
                   help="minimum seconds before a knob may reverse "
                        "direction (the anti-oscillation window); "
                        "same-direction steps wait out the per-knob "
                        "cooldown instead")
    p.add_argument("--debug-endpoints", nargs="?", const=True,
                   default=True, type=_parse_bool,
                   help="serve /debug/traces (flight-recorder dump), "
                        "/debug/templates (per-template compile state, "
                        "quarantine, eval counts), and /debug/profile"
                        "?seconds=N (arm a torch.profiler device-trace "
                        "window) on the metrics and health ports")
    p.add_argument("--disable-cert-rotation", action="store_true")
    p.add_argument("--disable-enforcementaction-validation",
                   action="store_true")
    p.add_argument("--exempt-namespace", action="append", default=[])
    p.add_argument("--webhook-reuse-port", action="store_true",
                   help="bind the webhook port with SO_REUSEPORT so "
                        "multiple worker processes share it (the kernel "
                        "load-balances accepts; one GIL-bound Python "
                        "frontend per worker)")
    p.add_argument("--fake-kube", action="store_true",
                   help="in-memory cluster (development/testing)")
    p.add_argument("--device", default="cuda",
                   help="torch device the policy driver evaluates on: "
                        "cuda (the card, the default; raises where no "
                        "card is visible) or cpu (the kernels' plain "
                        "versions, for tests and development)")
    return p


class Runtime:
    """Everything main() builds, exposed for tests and embedding."""

    def __init__(self, args, kube=None):
        self.args = args
        operations = set(args.operation or ["webhook", "audit"])
        self.operations = operations
        # stable pod identity (downward API via flags): byPod statuses
        # and the leader lease must survive pod replacement under the
        # SAME id, so a restarted pod overwrites its own slot
        from .util import pod_namespace, set_pod_identity
        set_pod_identity(getattr(args, "pod_name", ""),
                         getattr(args, "pod_namespace", ""))
        self.kube = kube if kube is not None else (
            FakeKube() if args.fake_kube else RestKubeClient())
        if isinstance(self.kube, FakeKube):
            self._register_builtin_kinds()
        if getattr(args, "fault_injection", ""):
            FAULTS.configure(args.fault_injection)
            log.warning("fault injection armed",
                        details={"points": FAULTS.armed()})
        # request tracing: the process-global tracer feeds the stage
        # histograms, the flight recorder (/debug/traces), and the
        # slow-request log. With --admission-workers > 1 the FRONTENDS
        # are the sampling edge (the rate rides their spawn args); this
        # engine-side tracer still samples the in-process server and
        # records every audit sweep.
        gtrace.TRACER.configure(
            getattr(args, "trace_sample_rate", 0.01),
            getattr(args, "trace_slow_threshold", 1.0))
        # SLO layer: declarative objectives compiled against the
        # existing request/detection series into 5m/1h burn-rate
        # gauges + /debug/slo (control/slo.py). Sample interval <= 0
        # disables the whole layer.
        self.slo = None
        slo_interval = getattr(args, "slo_sample_interval", 15.0) or 0
        if slo_interval > 0:
            from .slo import SloEngine, default_objectives
            try:
                self.slo = SloEngine(
                    default_objectives(
                        admission_p99_s=getattr(
                            args, "slo_admission_p99", 0.1),
                        availability_target=getattr(
                            args, "slo_availability_target", 0.999),
                        detection_p99_s=getattr(
                            args, "slo_detection_p99", 1.0)),
                    sample_interval_s=slo_interval)
            except ValueError as e:
                # a nonsense target (e.g. 1.0) disables the layer
                # loudly instead of crash-looping the pod
                log.warning("SLO objectives invalid; SLO layer "
                            "disabled", details=str(e))
        # a debug profile window must not run twice concurrently
        self._profile_until = 0.0
        self._profile_lock = threading.Lock()
        # HA: Lease-based leader election — only the lease holder runs
        # the audit sweep and the in-cluster status/CRD/cert writers;
        # every replica serves admission. The elector itself talks to
        # the RAW client (its lease writes must not be fenced by the
        # leadership gate they implement)
        self.elector = None
        if getattr(args, "leader_elect", False):
            from .kube import LeaseElector
            # one lease PER DEPLOYMENT (operation set), not one global:
            # the audit and webhook deployments both elect, and a
            # webhook pod holding a shared lease would starve the audit
            # sweep forever (its own audit loop does not exist)
            lease_name = ("gatekeeper-tpu-leader-"
                          + "-".join(sorted(operations)))
            self.elector = LeaseElector(
                self.kube, lease_name=lease_name,
                namespace=pod_namespace(),
                lease_duration=getattr(args, "leader_lease_duration",
                                       15.0))
        # shared write-resilience: one breaker + retry budget for every
        # control-loop writer (audit status PATCHes, cert secret/CA
        # injection); readiness surfaces the open breaker
        self.write_breaker = CircuitBreaker(
            "kube-writes",
            failure_threshold=getattr(args, "kube_breaker_threshold", 5),
            reset_timeout=getattr(args, "kube_breaker_reset", 30.0))
        budget = RetryBudget(getattr(args, "kube_retry_budget", 10.0))
        self.kube_guard = GuardedKube(self.kube, self.write_breaker,
                                      budget)
        # leadership-fenced guard for the audit + controller writers: a
        # deposed leader's in-flight status writes abort at the proxy
        # (resilience.NotLeader) instead of racing the new leader. With
        # election off it IS the plain guard.
        self.kube_gated = self.kube_guard
        if self.elector is not None:
            self.kube_gated = GuardedKube(
                self.kube, self.write_breaker, budget,
                write_gate=lambda: self.elector.is_leader)
        # cold-start elimination: the compile-cache flag feeds
        # enable_compile_cache (driver construction) through the env
        # hook, and the AOT serialized-program store colocates with the
        # state snapshots (<state-dir>/aot) so ONE volume carries the
        # whole deserialize-and-go warm boot
        import os as _os
        cc_dir = getattr(args, "compile_cache_dir", "") or ""
        if cc_dir:
            _os.environ.setdefault("TRITON_CACHE_DIR", cc_dir)
        aot_dir = getattr(args, "aot_dir", "") or ""
        state_dir = getattr(args, "state_dir", "") or ""
        if not aot_dir and state_dir:
            aot_dir = _os.path.join(state_dir, "aot")
        # no fallback: the default device is the card, and without one
        # TorchDriver raises here (--device cpu is the only way onto the
        # host). Imported here, not with the module: the scan's spawned
        # loaders re-import this module as their __main__ under `python
        # -m ...control.main scan`, and must not load torch
        from ..ir import TorchDriver

        driver = TorchDriver(device=getattr(args, "device", "cuda"),
                             aot_dir=aot_dir or None)
        self.opa = Backend(driver).new_client([K8sValidationTarget()])
        self.mutation_system = None
        if "mutation-webhook" in operations:
            from ..mutation import MutationSystem
            self.mutation_system = MutationSystem(
                max_iterations=getattr(args, "mutation_max_iterations", 10))
        # controllers ride the guarded client too: byPod status writes
        # and CRD applies share the one breaker/retry discipline (reads
        # and watches pass straight through the proxy). Deliberately
        # UNGATED even under leader election: byPod slots are keyed by
        # pod id (only the owning pod can write its slot — e.g. a
        # follower surfacing its own device-eval quarantine), and CRD/
        # finalizer applies are idempotent with conflict retries, so
        # fencing them would suppress per-pod state for no safety gain.
        self.manager = ControllerManager(
            self.kube_guard, self.opa,
            validate_actions=not args.disable_enforcementaction_validation,
            mutation_system=self.mutation_system)
        # the driver's device-eval quarantine surfaces on the owning
        # template's byPod status through the template controller
        if hasattr(driver, "on_quarantine"):
            driver.on_quarantine = self.manager.template_ctrl.note_quarantine
        self.audit = None
        self.audit_shards = None   # sharded plane: shard-process supervisor
        self._shard_plane = None
        if "audit" in operations:
            shards = max(1, int(getattr(args, "audit_shards", 1) or 1))
            if shards > 1:
                # sharded inventory plane: N audit engine children, each
                # owning a consistent-hash slice of the inventory; this
                # process stays the leader (watches, routing, status
                # writes, composition)
                from .audit import ShardedAuditPlane
                from .backplane import (
                    AuditShardSupervisor,
                    default_socket_path,
                )

                asock = (getattr(args, "backplane_socket", "")
                         or default_socket_path()) + ".audit"
                shard_spawn = ["--log-level",
                               getattr(args, "log_level", "INFO")]
                if getattr(args, "fault_injection", ""):
                    shard_spawn += ["--fault-injection",
                                    args.fault_injection]
                shard_spawn += _child_device_args(args)
                self.audit_shards = AuditShardSupervisor(
                    shards,
                    socket_for=lambda k, s=asock: f"{s}.{k}",
                    spawn_args=shard_spawn,
                    snapshot_provider=self._audit_shard_snapshot)
                self._shard_plane = ShardedAuditPlane(
                    self.kube_gated, self.opa, self.audit_shards,
                    shards)
            # the guarded client: status writes ride the shared breaker/
            # retry budget; reads and the tracker's watches pass through.
            # Under leader election only the lease holder sweeps.
            self.audit = AuditManager(
                self.kube_gated, self.opa, interval=args.audit_interval,
                constraint_violations_limit=args.constraint_violations_limit,
                audit_from_cache=str(args.audit_from_cache).lower() == "true",
                incremental=str(getattr(args, "audit_incremental",
                                        "false")).lower() == "true",
                full_resync_every=getattr(args, "audit_full_resync_every",
                                          DEFAULT_FULL_RESYNC_EVERY),
                write_breaker=self.write_breaker,
                leader_check=(None if self.elector is None
                              else lambda: self.elector.is_leader),
                stream_audit=getattr(args, "stream_audit", False),
                stream_window_s=getattr(args, "stream_window_ms",
                                        25.0) / 1000.0,
                stream_max_batch=getattr(args, "stream_max_batch", 512),
                shard_plane=self._shard_plane)
        # what-if preview (POST /v1/preview + the dedicated
        # --preview-port listener): candidate templates/constraints
        # evaluated over this process's cached inventory, compiled
        # out-of-band under alias kinds so the serving library is
        # untouched
        self.preview_engine = None
        self.preview_server = None
        if getattr(args, "preview_endpoint", True):
            from .preview import PreviewEngine
            self.preview_engine = PreviewEngine(self.opa)
        self.webhook = None
        self.cert_rotator = None
        # serving plane (--admission-workers > 1): pre-forked HTTP
        # frontends over the shared batching backplane; this process is
        # the engine
        self.backplane = None
        self.frontends = None
        self.engines = None  # N-engine plane: supervisor of engines 1..N-1
        self.validation_handler = None
        self.mutation_handler = None
        if "webhook" in operations or "mutation-webhook" in operations:
            fail_closed = getattr(args, "fail_closed", False)
            validation = ns_label = None
            max_queue = getattr(args, "admission_max_queue", 4096)
            default_timeout = getattr(args, "admission_default_timeout",
                                      10.0)
            if "webhook" in operations:
                # a mutation-only process must NOT serve /v1/admit — a
                # leftover VWC would get decisions from an operation the
                # operator turned off (unserved endpoints 404)
                batcher = MicroBatcher(self.opa, max_queue=max_queue)
                validation = ValidationHandler(
                    self.opa, kube=self.kube, batcher=batcher,
                    log_denies=args.log_denies,
                    validate_enforcement=not
                    args.disable_enforcementaction_validation,
                    traces_provider=lambda:
                    self.manager.config_ctrl.traces,
                    fail_closed=fail_closed,
                    default_timeout=default_timeout,
                    decision_cache_size=getattr(
                        args, "admission_decision_cache", 4096))
                ns_label = NamespaceLabelHandler(
                    tuple(args.exempt_namespace))
            mutation = None
            mut_fail_closed = getattr(args, "mutation_fail_closed", None)
            if self.mutation_system is not None:
                mutation = MutationHandler(
                    self.mutation_system, kube=self.kube,
                    fail_closed=fail_closed if mut_fail_closed is None
                    else mut_fail_closed,
                    batch_max_wait=getattr(args, "mutation_batch_max_wait",
                                           0.005),
                    max_queue=max_queue,
                    default_timeout=default_timeout)
            self.validation_handler = validation
            self.mutation_handler = mutation
            certfile = keyfile = None
            if not args.disable_cert_rotation:
                # guarded: secret persistence and CA-bundle injection
                # retry under the shared breaker/budget
                self.cert_rotator = CertRotator(self.kube_guard,
                                                args.cert_dir)
                try:
                    self.cert_rotator.refresh_certs()
                    certfile = f"{args.cert_dir}/tls.crt"
                    keyfile = f"{args.cert_dir}/tls.key"
                except Exception as e:
                    log.warning("cert bootstrap failed; serving plaintext",
                                details=str(e))
            workers = getattr(args, "admission_workers", 1) or 1
            engines = getattr(args, "admission_engines", 1)
            if engines == 0:
                # auto: one engine per visible card
                engines = max(1, _card_count(driver))
            if engines > 1 or workers > 1:
                from .backplane import (
                    BackplaneEngine,
                    EngineSupervisor,
                    FrontendSupervisor,
                    default_socket_path,
                )

                sock = getattr(args, "backplane_socket", "") \
                    or default_socket_path()
                serve = []
                if validation is not None:
                    serve += ["admit", "admitlabel"]
                if mutation is not None:
                    serve += ["mutate"]
                if self.preview_engine is not None:
                    # frontends forward /v1/preview over the backplane;
                    # the router pins it to engine 0 (this process — the
                    # one whose tracker feeds the live inventory)
                    serve += ["preview"]
                # N-engine plane: this process is engine 0; engines
                # 1..N-1 are child processes, each pinned to its own
                # chip with its own Client/MicroBatcher/socket. The
                # queue bound is divided so it stays GLOBAL: N engines
                # each bounding max_queue/N in-flight admissions.
                if engines > 1:
                    n_dev = _card_count(driver)
                    if n_dev and engines > n_dev:
                        # device pinning wraps modulo the device count:
                        # over-provisioned engines time-share chips,
                        # which degrades instead of scales — say so
                        log.warning(
                            "--admission-engines exceeds visible "
                            "devices; engines will time-share chips",
                            details={"engines": engines,
                                     "devices": n_dev})
                    share = max(1, max_queue // engines) if max_queue \
                        else 0
                    for handler in (validation, mutation):
                        if handler is not None:
                            handler.batcher.max_queue = share
                    metrics.set_engine_id("0")
                    spawn_args = ["--serve", ",".join(serve),
                                  "--admission-max-queue", str(share),
                                  "--admission-default-timeout",
                                  str(default_timeout),
                                  "--admission-decision-cache",
                                  str(getattr(args,
                                              "admission_decision_cache",
                                              4096)),
                                  "--log-level",
                                  getattr(args, "log_level", "INFO"),
                                  "--trace-sample-rate",
                                  str(getattr(args, "trace_sample_rate",
                                              0.01)),
                                  "--trace-slow-threshold",
                                  str(getattr(args,
                                              "trace_slow_threshold",
                                              1.0))]
                    if args.log_denies:
                        spawn_args += ["--log-denies"]
                    if fail_closed:
                        spawn_args += ["--fail-closed"]
                    if mut_fail_closed is not None:
                        spawn_args += ["--mutation-fail-closed",
                                       "true" if mut_fail_closed
                                       else "false"]
                    spawn_args += ["--mutation-max-iterations",
                                   str(getattr(args,
                                               "mutation_max_iterations",
                                               10))]
                    for ns in args.exempt_namespace:
                        spawn_args += ["--exempt-namespace", ns]
                    spawn_args += _child_device_args(args)
                    self.engines = EngineSupervisor(
                        range(1, engines),
                        socket_for=lambda k, s=sock: f"{s}.{k}",
                        spawn_args=spawn_args,
                        snapshot_provider=self._engine_sync_snapshot)
                    # every library mutation the controllers (or tests)
                    # apply through THIS client fans out to the engine
                    # children; each child's Client bumps its own
                    # generation when the op lands, keeping decision-
                    # cache keys coherent per engine
                    self.opa.on_change = \
                        lambda op, obj: self.engines.replicate(op, obj)
                    if self.mutation_system is not None:
                        self.mutation_system.on_change = \
                            lambda op, obj: self.engines.replicate(op,
                                                                   obj)
                self.backplane = BackplaneEngine(
                    sock, validation=validation, ns_label=ns_label,
                    mutation=mutation, default_timeout=default_timeout,
                    engine_id="0", preview=self.preview_engine)
                self.backplane.configured_workers = workers
                self.frontends = FrontendSupervisor(
                    workers,
                    [sock] + [f"{sock}.{k}" for k in range(1, engines)],
                    port=args.port,
                    certfile=certfile, keyfile=keyfile,
                    serve=tuple(serve), fail_closed=fail_closed,
                    mutation_fail_closed=mut_fail_closed,
                    default_timeout=default_timeout,
                    trace_sample_rate=getattr(args, "trace_sample_rate",
                                              0.01),
                    shm_ring_mb=getattr(args, "admission_shm_ring_mb",
                                        8.0))
            else:
                self.webhook = WebhookServer(
                    validation, ns_label, port=args.port,
                    certfile=certfile, keyfile=keyfile,
                    reuse_port=getattr(args, "webhook_reuse_port", False),
                    mutation=mutation, preview=self.preview_engine)
        # bulk gRPC/HTTP2 streaming ingest (--ingest-grpc): the
        # service/ layer's evaluation-only surface over THIS process's
        # client, so streamed batches share the library, caches, and
        # device programs with the admission plane
        self.ingest_server = None
        if getattr(args, "ingest_grpc", False):
            try:
                from ..service import INGEST_METHODS, make_server

                self.ingest_server, ingest_port = make_server(
                    client=self.opa,
                    address="0.0.0.0:%d" % getattr(args, "ingest_port",
                                                   50061),
                    expose=INGEST_METHODS)
                log.info("grpc streaming ingest configured",
                         details={"port": ingest_port})
            except Exception as e:
                # a missing grpcio / occupied port degrades the ingest
                # endpoint, never the admission plane
                log.warning("grpc streaming ingest unavailable",
                            details=str(e))
                self.ingest_server = None
        preview_port = getattr(args, "preview_port", 0) or 0
        if preview_port and self.preview_engine is not None:
            # dedicated plaintext preview listener: audit-only pods
            # have no webhook port but own the freshest tracker-fed
            # inventory — a WebhookServer with only the preview engine
            # attached 404s every admission route
            self.preview_server = WebhookServer(
                None, None, port=preview_port,
                preview=self.preview_engine)
        if self._shard_plane is not None:
            # AFTER the engines block above: attach() chains onto
            # whatever on_change hook is installed (the admission-engine
            # fan-out when --admission-engines > 1), so both planes see
            # every library op
            self._shard_plane.attach()
        # closed-loop adaptive serving controller (--adaptive-control):
        # samples the SLO/saturation signals and steers the declared
        # knobs; the flag defaulting OFF is the kill switch — disarm
        # restores every captured baseline bit-exactly. Built AFTER the
        # engines block so baselines capture the divided queue share.
        self.adaptive = None
        if getattr(args, "adaptive_control", False) \
                and self.validation_handler is not None:
            from .adaptive import AdaptiveController
            self.adaptive = AdaptiveController(
                batcher=self.validation_handler.batcher,
                engines=self.engines,
                slo=self.slo,
                generation=lambda: self.opa.generation,
                prewarm=self._adaptive_prewarm,
                interval=getattr(args, "adaptive_interval", 1.0),
                hysteresis_s=getattr(args, "adaptive_hysteresis",
                                     10.0),
                on_actuate=self._on_adaptive_actuation)
            # the ladder gates the admission pipeline: rung >= 2
            # serves cache hits only, rung >= 3 answers per stance
            self.validation_handler.ladder = self.adaptive.ladder
        self.upgrade = UpgradeManager(self.kube)
        self.metrics_server = None
        self.health = None
        self._ready = False
        # durable state snapshots (--state-dir): restore on boot (cold
        # fallback on any corruption), snapshot periodically / on
        # SIGTERM drain / on SIGHUP
        self.statestore = None
        self.snapshots = None
        # a warm boot's off-path loads (_restore_state) and the thread
        # that starts the audit loop once they are in (_start_audit)
        self._rows_restore = None
        self._audit_gate = None
        self._audit_gate_lock = threading.Lock()
        self._stopping = False
        self.restore_gate_s = None
        self._build_statestore()
        self._restore_state()

    # ---------------------------------------------------- durable state

    def _build_statestore(self) -> None:
        state_dir = getattr(self.args, "state_dir", "") or ""
        if not state_dir:
            return
        from . import statestore as ss
        try:
            self.statestore = ss.StateStore(state_dir)
        except OSError as e:
            log.warning("state dir unusable; snapshots disabled",
                        details={"dir": state_dir, "error": str(e)})
            return
        providers, blobs = self._snapshot_providers()
        self.snapshots = ss.SnapshotManager(
            self.statestore, providers, blob_providers=blobs,
            interval_s=getattr(self.args, "snapshot_interval", 60.0),
            # the inventory payload is plain containers by construction
            # (_deep_plain); marshal loads ~2x faster than pickle and
            # restore latency is the warm boot
            blob_codecs={"inventory": "marshal"})
        if self._shard_plane is not None:
            # observability section: which ring/fleet produced the
            # tracker slices riding the inventory blob. restore_state
            # discards slices saved under a different shard count, so
            # operators can read WHY a warm boot went cold here.
            plane, sup = self._shard_plane, self.audit_shards
            self.snapshots.add_provider(
                "audit_shards",
                lambda: {"shard_count": plane.shard_count,
                         "map_version": plane.map.version,
                         "generations": {str(k): v for k, v
                                         in sup.generation.items()}})

    def _snapshot_providers(self) -> tuple:
        driver = getattr(self.opa, "driver", None)
        providers = {}
        if hasattr(driver, "vocab_snapshot"):
            providers["vocab"] = driver.vocab_snapshot

        def library():
            snap = self.opa.snapshot_library()
            if self.mutation_system is not None:
                snap["mutators"] = self.mutation_system.sources()
            return snap

        providers["library"] = library
        blobs = {}
        if self.audit is not None and (self.audit.incremental
                                       or self._shard_plane is not None):
            # the inventory rides the BLOB (pickle) path: the frozen
            # in-memory tree round-trips without the O(cluster)
            # re-freeze a JSON restore would pay
            def inventory():
                tracker = self.audit.snapshot_state()
                if tracker is None:
                    return None  # no sweep yet: nothing worth saving
                tree = None
                if hasattr(driver, "inventory_snapshot"):
                    tree = driver.inventory_snapshot()
                return {"tree": tree or {}, "tracker": tracker}

            blobs["inventory"] = inventory
            if hasattr(driver, "encoded_rows_snapshot"):
                blobs["rows"] = driver.encoded_rows_snapshot
        return providers, blobs

    def _restore_state(self) -> None:
        if self.statestore is None:
            return
        from .statestore import restore_section
        driver = getattr(self.opa, "driver", None)
        vocab_ok = False
        if hasattr(driver, "vocab_restore"):
            # vocab FIRST: restored encoded rows hold interned ids, and
            # library re-ingestion interns — the append-only table must
            # replay before anything else touches it
            vocab_ok = restore_section(self.statestore, "vocab",
                                       driver.vocab_restore)

        def apply_library(snap):
            out = self.opa.restore_library(snap)
            if self.mutation_system is not None:
                for m in snap.get("mutators") or []:
                    try:
                        self.mutation_system.upsert(m)
                    except Exception:
                        out["errors"] = out.get("errors", 0) + 1
            log.info("library restored", details=out)

        restore_section(self.statestore, "library", apply_library)
        if self.audit is not None and (self.audit.incremental
                                       or self._shard_plane is not None):
            def apply_inventory(snap):
                n = 0
                if hasattr(driver, "inventory_restore"):
                    n = driver.inventory_restore(snap.get("tree") or {})
                self.audit.restore_state(snap.get("tracker") or {})
                log.info("inventory restored; watches resume from "
                         "persisted resourceVersions",
                         details={"objects": n})

            if restore_section(self.statestore, "inventory",
                               apply_inventory, blob=True) and vocab_ok \
                    and hasattr(driver, "encoded_rows_restore"):
                # encoded rows are a first-audit optimization, not a
                # readiness dependency: load them OFF the boot path.
                # The staleness-guard generation is pinned HERE (before
                # the thread starts) so a delta applied while the blob
                # loads invalidates the stash; adoption also requires a
                # cand match, so a racing sweep just re-extracts.
                driver.mark_rows_restore_base()
                self._rows_restore = threading.Thread(
                    target=lambda: restore_section(
                        self.statestore, "rows",
                        driver.encoded_rows_restore, blob=True),
                    name="rows-restore", daemon=True)
                self._rows_restore.start()

    def _start_audit(self) -> None:
        """Start the audit loop. After a warm restore its first sweep
        waits, on a thread of its own, for the restored rows' load and
        the driver's prewarm of the stored K2 variants (at most
        RESTORE_GATE_S): a sweep racing them would re-extract the rows
        and serve the kinds not yet adopted from the host. /readyz's
        state-restore check holds meanwhile, and the audit loop's
        liveness passes until it starts. restore_gate_s records the
        wait."""
        if self.audit.tracker is None:
            self.audit.start()
            return

        def gate():
            t0 = time.monotonic()
            if self._rows_restore is not None:
                self._rows_restore.join(RESTORE_GATE_S)
            wait = getattr(getattr(self.opa, "driver", None),
                           "wait_prewarm", None)
            if wait is not None:
                wait(max(0.0, RESTORE_GATE_S - (time.monotonic() - t0)))
            with self._audit_gate_lock:
                self.restore_gate_s = time.monotonic() - t0
                if self._stopping:
                    return
                self.audit.start()
            log.info("restored state loaded; audit loop started",
                     details={"waited_s": round(self.restore_gate_s, 3)})

        self._audit_gate = threading.Thread(target=gate,
                                            name="restore-gate",
                                            daemon=True)
        self._audit_gate.start()

    # ------------------------------------------------- N-engine plane

    def _engine_sync_snapshot(self) -> dict:
        """The full-library sync op the EngineSupervisor sends a fresh
        (or healed) engine child: templates/constraints, the synced
        inventory tree, and mutator sources. The child replays it
        through its own Client, so its decision-cache generation
        reflects the library it actually evaluates."""
        snap = {"library": self.opa.snapshot_library()}
        driver = getattr(self.opa, "driver", None)
        if hasattr(driver, "inventory_snapshot"):
            snap["data"] = driver.inventory_snapshot()
        if self.mutation_system is not None:
            snap["mutators"] = self.mutation_system.sources()
        return snap

    def _audit_shard_snapshot(self, k: int) -> dict:
        """The per-shard sync op the AuditShardSupervisor sends a fresh
        (or respawned) shard child: full library + that shard's
        inventory slice rebuilt from the leader's tree (owned objects
        whole, join partners column-pruned). The slice heals without a
        cluster re-list — tracker state never left the leader."""
        return self._shard_plane.sync_snapshot(k)

    # ---------------------------------------------------- debug endpoints

    def debug_providers(self) -> dict:
        """The /debug/* registry mounted on BOTH the metrics and the
        health servers: the flight-recorder dump, the per-template
        compile/quarantine/eval-count state, and the device-profile
        armer."""
        return {
            "traces": lambda q: gtrace.TRACER.recorder.dump(),
            "templates": self._debug_templates,
            "profile": self._debug_profile,
            "slo": lambda q: (self.slo.status() if self.slo is not None
                              else {"disabled": True,
                                    "hint": "--slo-sample-interval > 0 "
                                            "enables the SLO engine"}),
            "adaptive": lambda q: (self.adaptive.status(q)
                                   if self.adaptive is not None
                                   else {"disabled": True,
                                         "hint": "--adaptive-control "
                                                 "arms the controller"}),
            # the chaos ledger: active/last schedule + what fired, plus
            # the fault injector's armed/fired snapshots (answers even
            # with no orchestrator — a GATEKEEPER_TPU_FAULTS game day
            # still shows its armed points here)
            "chaos": chaos_debug.debug_snapshot,
        }

    def _on_adaptive_actuation(self, act) -> None:
        """Controller actuation hook: batcher-knob movements replicate
        to the engine children so the fleet's batch economics stay
        coherent (set_knobs only records the payload — the supervisor's
        monitor loop does the socket work, keeping the control loop
        no-block)."""
        if self.engines is None or self.validation_handler is None:
            return
        if act.knob in ("batch_max_wait", "batch_max_batch",
                        "shed_depth"):
            self.engines.set_knobs(
                self.validation_handler.batcher.knob_values())

    def _adaptive_prewarm(self) -> int:
        """Churn-triggered off-path AOT pre-warm over every known
        template kind (runs on the controller's one-shot thread, never
        on the control loop)."""
        driver = getattr(self.opa, "driver", None)
        if not hasattr(driver, "prewarm_templates"):
            return 0
        return driver.prewarm_templates(self.opa.template_kinds())

    def _debug_templates(self, query: str) -> dict:
        driver = getattr(self.opa, "driver", None)
        if hasattr(driver, "templates_debug"):
            return driver.templates_debug()
        # interpreter-only driver (tests/embedders): still answer with
        # the known template kinds rather than 500
        return {"templates": {k: {"state": "interpreter"}
                              for k in self.opa.template_kinds()}}

    def _debug_profile(self, query: str) -> dict:
        """Arm a torch.profiler device-trace window (?seconds=N,
        capped): the card's pprof analog — the Chrome trace
        (*.pt.trace.json) written into the directory opens in Perfetto
        or chrome://tracing with the device timeline."""
        from urllib.parse import parse_qsl
        seconds = 5.0
        for k, v in parse_qsl(query, keep_blank_values=True):
            if k == "seconds":
                try:
                    seconds = float(v)
                except ValueError:
                    pass
        # capped at 30s: the window thread is deliberately NON-daemon
        # (a daemon profiler thread skips the profiler's thread-state
        # teardown and the interpreter segfaults at exit), so the cap
        # bounds how long an in-flight window can delay process exit —
        # strictly UNDER the manifests' 60s terminationGracePeriodSeconds
        # so a window armed right before pod deletion still leaves the
        # SIGTERM drain room to finish before the kubelet SIGKILLs
        seconds = min(max(seconds, 0.5), 30.0)
        with self._profile_lock:
            now = time.monotonic()
            if now < self._profile_until:
                return {"armed": False,
                        "error": "a profile window is already running",
                        "remaining_s": round(self._profile_until - now,
                                             1)}
            self._profile_until = now + seconds
        import tempfile
        log_dir = tempfile.mkdtemp(prefix="gatekeeper-tpu-trace-")

        def run():
            try:
                from ..utils.profiling import device_trace
                with device_trace(log_dir):
                    time.sleep(seconds)
                log.info("device profile window captured",
                         details={"log_dir": log_dir,
                                  "seconds": seconds})
            except Exception as e:
                log.error("device profile window failed",
                          details=str(e))
            finally:
                with self._profile_lock:
                    self._profile_until = 0.0

        threading.Thread(target=run, name="debug-profile",
                         daemon=False).start()
        return {"armed": True, "seconds": seconds, "log_dir": log_dir,
                "viewer": "load <log_dir>/*.pt.trace.json in Perfetto "
                          "(or chrome://tracing) for the device timeline"}

    def snapshot_now(self) -> None:
        """Force an immediate snapshot (SIGHUP): runs off-thread, safe
        from a signal context; save_now serializes concurrent passes."""
        if self.snapshots is None:
            return
        threading.Thread(target=self.snapshots.save_now,
                         name="snapshot-now", daemon=True).start()

    def _register_builtin_kinds(self) -> None:
        for gvk, namespaced in [
            (("", "v1", "Namespace"), False),
            (("", "v1", "Pod"), True),
            (("", "v1", "Service"), True),
            (("", "v1", "Secret"), True),
            (("apps", "v1", "Deployment"), True),
            (("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate"),
             False),
            (("config.gatekeeper.sh", "v1alpha1", "Config"), True),
            (("apiextensions.k8s.io", "v1beta1",
              "CustomResourceDefinition"), False),
            (("admissionregistration.k8s.io", "v1beta1",
              "ValidatingWebhookConfiguration"), False),
            (("admissionregistration.k8s.io", "v1beta1",
              "MutatingWebhookConfiguration"), False),
            (("mutations.gatekeeper.sh", "v1alpha1", "Assign"), False),
            (("mutations.gatekeeper.sh", "v1alpha1", "AssignMetadata"),
             False),
            (("mutations.gatekeeper.sh", "v1alpha1", "ModifySet"), False),
            (("coordination.k8s.io", "v1", "Lease"), True),
        ]:
            self.kube.register_kind(gvk, namespaced=namespaced)

    def _register_saturation_probes(self) -> None:
        """Scrape-time gauge refreshers for the capacity-attribution
        read: admission/mutation queue depth (the --admission-max-queue
        counter itself) and the engine's eval duty cycle. The
        backplane engine and the streaming audit register their own
        probes; frontends ship per-worker in-flight over S frames."""
        if self.validation_handler is not None:
            batcher = self.validation_handler.batcher
            metrics.register_saturation_probe(
                "admission-queue",
                lambda: metrics.report_queue_depth(
                    "admission", batcher.pending()))
        if self.mutation_handler is not None:
            mbatcher = self.mutation_handler.batcher
            metrics.register_saturation_probe(
                "mutation-queue",
                lambda: metrics.report_queue_depth(
                    "mutation", mbatcher.pending()))
        driver = getattr(self.opa, "driver", None)
        if hasattr(driver, "duty_cycle"):
            metrics.register_saturation_probe(
                "engine-duty-cycle",
                lambda: metrics.report_duty_cycle(driver.duty_cycle()))

    def start(self) -> None:
        # build identity FIRST: every scrape of this process carries
        # the version/torch/CUDA/card/device-count join gauge
        metrics.report_build_info()
        self._register_saturation_probes()
        debug = (self.debug_providers()
                 if getattr(self.args, "debug_endpoints", True) else None)
        if self.args.metrics_backend == "prometheus":
            try:
                self.metrics_server = metrics.serve(
                    self.args.prometheus_port, debug_providers=debug)
            except OSError as e:
                log.warning("metrics port unavailable", details=str(e))
        # healthz/readyz on --health-addr (reference main.go:205-212)
        health_addr = getattr(self.args, "health_addr", "")
        addr = health.parse_addr(health_addr)
        if addr is not None:
            try:
                self.health = health.HealthServer(*addr)
                self.health.add_readiness("runtime", lambda: self._ready)
                if self.webhook is None and self.backplane is None:
                    # audit/controller-only pods surface the open
                    # kube-write breaker through readiness. Webhook
                    # pods must NOT: every replica shares one API
                    # server, so a cluster-wide write brownout would
                    # open every replica's breaker at once and pull
                    # ALL admission endpoints — turning a partial
                    # degradation (serving works, writes don't) into a
                    # full admission outage. There the breaker stays
                    # observable via metrics and logs.
                    self.health.add_readiness(
                        "kube-writes",
                        lambda: not self.write_breaker.is_open)
                if self.webhook:
                    self.health.add_readiness(
                        "webhook",
                        lambda: self.webhook._thread.is_alive())
                if self.backplane is not None:
                    # the engine listener and every pre-forked frontend
                    # must be up for the plane to serve (a crashed
                    # frontend is respawned by the supervisor; readiness
                    # dips meanwhile)
                    self.health.add_readiness("backplane-engine",
                                              self.backplane.alive)
                    self.health.add_readiness("admission-frontends",
                                              self.frontends.alive)
                if self.engines is not None:
                    # DELIBERATELY not all-engines-alive: one dead
                    # engine child is a degraded-but-serving state —
                    # frontends fail its requests over to the survivors
                    # and the supervisor respawns it. Pulling the pod
                    # from the Service for that would turn a partial
                    # capacity dip into a full endpoint outage.
                    # Readiness only requires the supervisor itself to
                    # still be monitoring/respawning.
                    self.health.add_readiness(
                        "engine-supervisor", self.engines.monitoring)
                # liveness watchdogs: a wedged micro-batch pipeline
                # (dead flusher, hung evaluation with a growing queue)
                # fails /healthz so k8s restarts the pod — the
                # handlers exist in both the in-process and the
                # backplane serving modes
                if self.validation_handler is not None:
                    self.health.add_liveness(
                        "admission-batcher",
                        self.validation_handler.batcher.healthy)
                if self.mutation_handler is not None:
                    self.health.add_liveness(
                        "mutation-batcher",
                        self.mutation_handler.batcher.healthy)
                if self.adaptive is not None:
                    # a dead armed control loop means knobs freeze at
                    # whatever the last tick left them — not baselines,
                    # not steered; restart the pod (disarm-on-shutdown
                    # restores the baselines first)
                    self.health.add_liveness("adaptive-controller",
                                             self.adaptive.healthy)
                if self.audit_shards is not None:
                    # same contract as the admission-engine supervisor:
                    # a dead shard mid-respawn is degraded-but-healing;
                    # only a dead MONITOR (nothing left to respawn it)
                    # pulls readiness
                    self.health.add_readiness(
                        "audit-shard-supervisor",
                        self.audit_shards.monitoring)
                if self.audit:
                    self.health.add_liveness("audit-loop",
                                             self.audit.healthy)
                if self.audit and self.statestore is not None:
                    # warm restart: hold readiness until restored state
                    # has been re-validated against a live list (a cold
                    # or non-restored boot passes trivially)
                    self.health.add_readiness("state-restore",
                                              self.audit.restore_ready)
                if self.elector is not None:
                    # a dead elector loop means leadership can silently
                    # never arrive (or never lapse); surface it. NOT
                    # being leader is a healthy state — followers stay
                    # Ready and serve admission.
                    self.health.add_readiness("leader-elector",
                                              self.elector.healthy)
                if debug:
                    # same registry as the metrics server: an audit-only
                    # pod scraped by nothing still dumps its recorder
                    for name, provider in debug.items():
                        self.health.add_debug(name, provider)
                self.health.start()
            except OSError as e:
                log.warning("health port unavailable", details=str(e))
        elif health_addr and health_addr != "0":
            # a typo'd flag silently dropping liveness probes would
            # crash-loop the deployment with no hint in the logs
            log.warning("--health-addr not understood; health endpoints "
                        "disabled", details={"health_addr": health_addr})
        if self.elector is not None:
            self.elector.start()
        self.upgrade.upgrade()
        self.manager.start()
        if self.audit_shards is not None:
            # shard children before the audit loop: the supervisor's
            # first resync fills each slice, and the first sweep's
            # dispatch retries through any shard still syncing
            self.audit_shards.start()
        if self.audit:
            self._start_audit()
        if self.cert_rotator:
            self.cert_rotator.start(watch_manager=self.manager.wm)
        if self.webhook:
            self.webhook.start()
        if self.preview_server is not None:
            self.preview_server.start()
        if self.backplane is not None:
            # engines first: frontends connect eagerly on boot
            self.backplane.start()
            if self.engines is not None:
                self.engines.start()
                metrics.report_admission_engines(
                    1 + len(self.engines.engine_ids),
                    1 + self.engines.alive_count())
            self.frontends.start()
            metrics.report_admission_workers(
                self.backplane.configured_workers,
                self.backplane.connected)
        if self.ingest_server is not None:
            try:
                self.ingest_server.start()
                log.info("grpc streaming ingest serving")
            except Exception as e:
                log.warning("grpc streaming ingest failed to start",
                            details=str(e))
                self.ingest_server = None
        if self.snapshots is not None:
            self.snapshots.start()
        if self.slo is not None:
            self.slo.start()
        if self.adaptive is not None:
            # AFTER slo.start(): the first tick reads a seeded export
            self.adaptive.arm()
        self._ready = True
        # long-lived-server GC tuning: everything built so far (engine,
        # policy caches, codegen closures) is effectively permanent;
        # freezing it out of the collector's scan set keeps multi-ms
        # gen-2 pauses out of the admission tail
        import gc
        gc.collect()
        gc.freeze()
        log.info("gatekeeper-tpu started",
                 details={"operations": sorted(self.operations)})

    def stop(self) -> None:
        self._ready = False
        if self.adaptive is not None:
            # FIRST: no actuation may race the teardown below, and the
            # baseline restore leaves the knobs as configured for any
            # still-serving embedder/test plane
            self.adaptive.disarm()
        if self.slo is not None:
            self.slo.stop()
        for probe in ("admission-queue", "mutation-queue",
                      "engine-duty-cycle"):
            metrics.unregister_saturation_probe(probe)
        # the gauges are SET-only: zero the stopped plane's depths (and
        # its duty cycle) so a still-running process (embedders, tests)
        # doesn't export the last sampled value forever
        if self.validation_handler is not None:
            metrics.report_queue_depth("admission", 0)
        if self.mutation_handler is not None:
            metrics.report_queue_depth("mutation", 0)
        if hasattr(getattr(self.opa, "driver", None), "duty_cycle"):
            metrics.report_duty_cycle(0.0)
        if self.elector is not None:
            # graceful lease release FIRST: the surviving replica takes
            # over immediately instead of waiting out the lease duration
            self.elector.stop()
        if self.webhook:
            self.webhook.stop()
        if self.ingest_server is not None:
            try:
                self.ingest_server.stop(grace=2.0).wait(timeout=10)
            except Exception:
                pass
        if self.preview_server is not None:
            self.preview_server.stop(drain_timeout=1.0)
        if self.backplane is not None:
            # frontends FIRST: each stops accepting and finishes its
            # in-flight HTTP requests (verdicts still flow over the
            # backplane), THEN the engines drain their batchers
            self.frontends.stop()
            if self.engines is not None:
                self.engines.stop()
            self.backplane.stop()
        if self.audit:
            with self._audit_gate_lock:
                self._stopping = True
            self.audit.stop()
        if self.audit_shards is not None:
            # after the audit loop: no sweep can be dispatched into a
            # stopping fleet
            self.audit_shards.stop()
        if self.snapshots is not None:
            # SIGTERM drain snapshot: the replacement pod warm-boots
            # from state at most seconds old
            self.snapshots.stop()
            try:
                self.snapshots.save_now()
            except Exception as e:
                log.error("drain snapshot failed", details=str(e))
        if self.cert_rotator:
            self.cert_rotator.stop()
        self.manager.stop()
        if self.metrics_server:
            self.metrics_server.shutdown()
        if self.health:
            self.health.shutdown()
        log.info("gatekeeper-tpu stopped")


def warm_cache_main(argv=None) -> int:
    """`gatekeeper-tpu warm-cache`: prepack the compile caches.

    Restores the library/vocab/inventory snapshots from a state dir and
    runs one full audit with INLINE compilation, so every kernel variant
    the restored workload needs lands in Triton's kernel cache and the
    program store (<state-dir>/aot). Run it at image build time or from
    an initContainer against the state volume: the serving pod that
    follows loads instead of compiling. Prints one JSON summary line."""
    import json
    import os

    p = argparse.ArgumentParser(
        prog="gatekeeper-tpu warm-cache",
        description="pre-compile + store kernel variants for a "
                    "snapshotted workload (bake warm caches into "
                    "images/volumes)")
    p.add_argument("--state-dir", required=True,
                   help="state dir holding the snapshots to prepack "
                        "for; the program store is written to "
                        "<state-dir>/aot unless --aot-dir overrides")
    p.add_argument("--aot-dir", default="")
    p.add_argument("--compile-cache-dir", default="",
                   help="persistent Triton kernel cache dir to populate "
                        "(TRITON_CACHE_DIR equivalent)")
    p.add_argument("--device", default="cuda",
                   help="torch device to compile for: cuda (the card, "
                        "the default) or cpu")
    p.add_argument("--enabled", default="true",
                   help="false = exit 0 without prepacking (lets the "
                        "chart's prewarm initContainer stay templated "
                        "unconditionally and gate on the value)")
    p.add_argument("--log-level", default="INFO")
    args = p.parse_args(argv)
    glog.setup(args.log_level)
    if str(args.enabled).strip().lower() in ("false", "0", "no", "off"):
        print(json.dumps({"skipped": "prewarm disabled"}))
        return 0
    if args.compile_cache_dir:
        os.environ.setdefault("TRITON_CACHE_DIR", args.compile_cache_dir)
    from ..ir import TorchDriver
    from .statestore import StateStore, restore_section
    store = StateStore(args.state_dir)
    driver = TorchDriver(device=args.device,
                         aot_dir=args.aot_dir or store.aot_dir())
    # this run IS the compile pass: no background warm, no host
    # fallback — compile inline and persist everything (the store saves
    # a variant Triton's cache answered like a fresh one, so there is
    # nothing to mint)
    driver.async_warm = False
    client = Backend(driver).new_client([K8sValidationTarget()])
    restored = {}
    if hasattr(driver, "vocab_restore"):
        restored["vocab"] = restore_section(store, "vocab",
                                            driver.vocab_restore)
    restored["library"] = restore_section(
        store, "library", lambda snap: client.restore_library(snap))
    objects = 0

    def apply_inventory(snap):
        nonlocal objects
        if hasattr(driver, "inventory_restore"):
            objects = driver.inventory_restore(snap.get("tree") or {})

    restored["inventory"] = restore_section(store, "inventory",
                                            apply_inventory, blob=True)
    violations = None
    audit_s = None
    if objects:
        t0 = time.monotonic()
        violations = len(client.audit().results())
        audit_s = round(time.monotonic() - t0, 2)
    else:
        log.warning("no inventory snapshot to sweep; only ingestion-"
                    "time programs were prepacked — run against a "
                    "state dir with snapshots for full coverage")
    summary = {
        "restored": restored, "objects": objects,
        "violations": violations, "audit_s": audit_s,
        "aot": driver.aot.stats_snapshot(),
        "programs_stored": driver.aot.programs_count(),
        "compile_cache_enabled": driver.compile_cache_enabled,
    }
    print(json.dumps(summary))
    return 0


def preview_main(argv=None) -> int:
    """`gatekeeper-tpu preview`: what-if a candidate policy.

    POSTs a constraint (plus, optionally, a not-yet-installed
    ConstraintTemplate) to a running instance's /v1/preview and prints
    the violation counts + capped samples as JSON — the full cached
    inventory is swept on-device without enforcing anything. Point it at
    the webhook port (TLS, self-signed accepted) or an audit pod's
    --preview-port plaintext listener."""
    import json
    import ssl
    import urllib.request

    p = argparse.ArgumentParser(
        prog="gatekeeper-tpu preview",
        description="evaluate a candidate ConstraintTemplate/Constraint "
                    "against a running instance's cached inventory "
                    "without enforcing it")
    p.add_argument("--url", default="https://localhost:8443",
                   help="base URL of a running gatekeeper-tpu (webhook "
                        "port — TLS, self-signed accepted — or "
                        "http://host:port for an audit pod's plaintext "
                        "--preview-port)")
    p.add_argument("--constraint", required=True,
                   help="constraint manifest (YAML or JSON file; '-' "
                        "for stdin)")
    p.add_argument("--template", default="",
                   help="candidate ConstraintTemplate manifest (YAML or "
                        "JSON); omit to preview against the kind's "
                        "already-ingested template")
    p.add_argument("--limit", type=int, default=20,
                   help="violation samples to return (cap 500)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="request timeout (a cold preview may wait out "
                        "one kernel compile)")
    args = p.parse_args(argv)

    def load_manifest(path: str) -> dict:
        raw = sys.stdin.read() if path == "-" else open(path).read()
        try:
            import yaml
            doc = yaml.safe_load(raw)
        except ImportError:
            doc = json.loads(raw)
        if not isinstance(doc, dict):
            raise SystemExit(f"{path}: expected one manifest object")
        return doc

    payload = {"constraint": load_manifest(args.constraint),
               "limit": args.limit}
    if args.template:
        payload["template"] = load_manifest(args.template)
    req = urllib.request.Request(
        args.url.rstrip("/") + "/v1/preview",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    ctx = None
    if args.url.startswith("https"):
        # the webhook serves a self-signed rotating cert; the preview
        # payload carries no secrets, so unverified TLS is the useful
        # default for an operator poking from a laptop
        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    try:
        with urllib.request.urlopen(req, timeout=args.timeout,
                                    context=ctx) as resp:
            body, status = resp.read(), resp.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    except OSError as e:
        print(json.dumps({"error": str(e)}), file=sys.stderr)
        return 2
    try:
        print(json.dumps(json.loads(body), indent=2))
    except ValueError:
        sys.stdout.write(body.decode("utf-8", "replace") + "\n")
    return 0 if status == 200 else 1


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["warm-cache"]:
        return warm_cache_main(argv[1:])
    if argv[:1] == ["preview"]:
        return preview_main(argv[1:])
    if argv[:1] == ["scan"]:
        from .scan import scan_main

        return scan_main(argv[1:])
    args = build_parser().parse_args(argv)
    glog.setup(args.log_level)
    runtime = Runtime(args)
    stop = threading.Event()

    def handle_signal(*_):
        stop.set()

    signal.signal(signal.SIGTERM, handle_signal)
    signal.signal(signal.SIGINT, handle_signal)
    if hasattr(signal, "SIGHUP"):
        # operator escape hatch: force an immediate state snapshot
        # (e.g. right before a node drain) without restarting
        signal.signal(signal.SIGHUP,
                      lambda *_: runtime.snapshot_now())
    runtime.start()
    stop.wait()
    runtime.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
