"""One admission ENGINE process of the N-engine serving plane.

`python -m gatekeeper_tpu_torch.control.engine --socket S --engine-id K
--device K ...` builds a full evaluation stack — TorchDriver pinned to
ONE card, Client, MicroBatcher, validation/mutation handlers — behind a
BackplaneEngine on its own Unix socket. Frontends route reviews across
all engines (least-load, request-hash fallback), so `admission_rps`
scales with chips instead of saturating one GIL + one device queue.

The engine owns no kube connection and no controllers: the PRIMARY
process (engine 0) watches the cluster and replicates every library
mutation here over L frames — templates, constraints, synced data,
mutators — applied through this process's own Client, which bumps its
own generation per op, keeping the decision cache's generation keys
coherent with the library this engine actually evaluates. A fresh or
healed engine receives a full `sync` op first (library snapshot +
inventory tree + mutator sources, with stale extras diffed away).

The serving contracts hold unchanged because the serving path IS
BackplaneEngine: deadlines pin at frame receipt, `--admission-max-queue`
arrives pre-divided by the engine count (the bound stays global), shed
and decision metrics accumulate in this process's registry and relay to
the primary over M-frame polls, and SIGTERM drains the batcher.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from . import logging as glog
from . import metrics
from . import trace as gtrace
from .backplane import BackplaneEngine
from .webhook import (
    DEFAULT_WEBHOOK_TIMEOUT_S,
    MicroBatcher,
    MutationHandler,
    NamespaceLabelHandler,
    ValidationHandler,
)

log = glog.logger("engine")


def _template_kind(tpl: dict) -> str:
    spec = tpl.get("spec") or {}
    names = ((spec.get("crd") or {}).get("spec") or {}).get("names") or {}
    return names.get("kind") or (tpl.get("metadata") or {}).get("name", "")


class LibrarySink:
    """Applies replicated library ops to this engine's Client (and
    MutationSystem). Ops arrive in send order on the primary's one
    control connection; `sync` reconciles the full state — replaying
    the snapshot through normal ingestion (semantic-equal dedupe makes
    it idempotent) and removing templates/constraints/mutators the
    primary no longer carries."""

    def __init__(self, client, mutation_system=None):
        self.client = client
        self.mutation_system = mutation_system
        # flips on the first full sync: the backplane answers admission
        # Q frames NOT_READY until then, so a respawned engine never
        # issues verdicts from its empty pre-sync library
        self.synced = False
        # serving-knob receiver (adaptive controller fan-out): main()
        # binds this to the batcher's set_knobs so the primary's
        # actuations keep every engine's batch economics coherent
        self.on_knobs = None

    def __call__(self, op: dict) -> None:
        kind = op.get("op")
        obj = op.get("obj")
        client = self.client
        if kind == "sync":
            self._sync(op)
        elif kind == "knobs":
            if self.on_knobs is not None:
                self.on_knobs(obj or {})
        elif kind == "add_template":
            client.add_template(obj)
        elif kind == "remove_template":
            client.remove_template(obj)
        elif kind == "add_constraint":
            client.add_constraint(obj)
        elif kind == "remove_constraint":
            client.remove_constraint(obj)
        elif kind == "add_data":
            client.add_data(obj)
        elif kind == "remove_data":
            client.remove_data(obj)
        elif kind == "upsert_mutator":
            if self.mutation_system is not None:
                self.mutation_system.upsert(obj)
        elif kind == "remove_mutator":
            if self.mutation_system is not None:
                self.mutation_system.remove(
                    (obj.get("kind"), (obj.get("metadata") or {})
                     .get("name")))
        else:
            raise ValueError(f"unknown library op {kind!r}")

    def _sync(self, op: dict) -> None:
        client = self.client
        lib = op.get("library") or {}
        snap_kinds = {_template_kind(t)
                      for t in lib.get("templates") or []}
        snap_cons = {((c.get("kind") or ""),
                      ((c.get("metadata") or {}).get("name") or ""))
                     for c in lib.get("constraints") or []}
        # drop extras FIRST (a removed template must stop enforcing
        # even though the snapshot replay would never mention it)
        index = client.library_index()
        for tk, names in index.items():
            if tk not in snap_kinds:
                try:
                    client.remove_template(client.get_template(tk))
                except Exception:
                    pass
                continue
            for name in names:
                if (tk, name) not in snap_cons:
                    try:
                        client.remove_constraint(
                            client.get_constraint(tk, name))
                    except Exception:
                        pass
        out = client.restore_library(lib)
        data = op.get("data")
        n_data = 0
        driver = getattr(client, "driver", None)
        if data and hasattr(driver, "inventory_restore"):
            n_data = driver.inventory_restore(data)
        ms = self.mutation_system
        if ms is not None:
            keep = set()
            for m in op.get("mutators") or []:
                ms.upsert(m)
                keep.add(((m.get("kind") or ""),
                          ((m.get("metadata") or {}).get("name") or "")))
            for mut in ms.mutators():
                if tuple(mut.id) not in keep:
                    ms.remove(mut.id)
        self.synced = True
        log.info("library synced",
                 details={**out, "data_objects": n_data})


def engine_device(flag: str) -> str:
    """The torch device of `--device`: card index k as
    cuda:{k % torch.cuda.device_count()} (-1: the current card), else
    the device string itself (`cpu`, `cuda:1`). With no card visible an
    index gives `cuda`, on which TorchDriver raises: a child never
    evaluates on the host unless asked to."""
    try:
        k = int(flag)
    except ValueError:
        return flag
    import torch

    n = torch.cuda.device_count()
    return f"cuda:{k % n}" if k >= 0 and n else "cuda"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gatekeeper-tpu-engine")
    p.add_argument("--socket", required=True)
    p.add_argument("--engine-id", default="1")
    p.add_argument("--device", default="-1",
                   help="the card this engine pins its evaluation to: "
                        "an index k (cuda:k modulo the visible cards; "
                        "-1 = the current card), or cpu (the kernels' "
                        "plain versions, for tests). No fallback: a card "
                        "asked for where none is visible fails the "
                        "start")
    p.add_argument("--serve", default="admit,admitlabel",
                   help="operations this engine evaluates "
                        "(admit,admitlabel,mutate,auditslice)")
    p.add_argument("--audit-shard-id", type=int, default=-1,
                   help="this process's slice of the sharded audit "
                        "plane (with --serve auditslice); -1 = unsharded")
    p.add_argument("--audit-shard-count", type=int, default=1)
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--log-denies", action="store_true")
    p.add_argument("--fail-closed", action="store_true")
    p.add_argument("--mutation-fail-closed", default="unset",
                   choices=["true", "false", "unset"])
    p.add_argument("--mutation-max-iterations", type=int, default=10)
    p.add_argument("--mutation-batch-max-wait", type=float, default=0.005)
    p.add_argument("--admission-max-queue", type=int, default=4096,
                   help="THIS engine's share of the global bound (the "
                        "primary divides --admission-max-queue by the "
                        "engine count)")
    p.add_argument("--admission-default-timeout", type=float,
                   default=DEFAULT_WEBHOOK_TIMEOUT_S)
    p.add_argument("--admission-decision-cache", type=int, default=4096)
    p.add_argument("--exempt-namespace", action="append", default=[])
    p.add_argument("--trace-sample-rate", type=float, default=0.0)
    p.add_argument("--trace-slow-threshold", type=float, default=1.0)
    p.add_argument("--fault-injection", default="")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    glog.setup(args.log_level)
    metrics.set_engine_id(args.engine_id)
    gtrace.TRACER.configure(args.trace_sample_rate,
                            args.trace_slow_threshold)
    if args.fault_injection:
        from ..utils.faults import FAULTS

        FAULTS.configure(args.fault_injection)
    from ..client import Backend
    from ..ir import TorchDriver
    from ..target import K8sValidationTarget

    serve = frozenset(s for s in args.serve.split(",") if s)
    driver = TorchDriver(device=engine_device(args.device))
    client = Backend(driver).new_client([K8sValidationTarget()])
    fail_closed = args.fail_closed
    validation = ns_label = mutation = mutation_system = None
    if "admit" in serve:
        batcher = MicroBatcher(client,
                               max_queue=args.admission_max_queue)
        validation = ValidationHandler(
            client, kube=None, batcher=batcher,
            log_denies=args.log_denies, fail_closed=fail_closed,
            default_timeout=args.admission_default_timeout,
            decision_cache_size=args.admission_decision_cache)
        ns_label = NamespaceLabelHandler(tuple(args.exempt_namespace))
    if "mutate" in serve:
        from ..mutation import MutationSystem

        mutation_system = MutationSystem(
            max_iterations=args.mutation_max_iterations)
        mutation = MutationHandler(
            mutation_system, kube=None,
            fail_closed=(fail_closed if args.mutation_fail_closed
                         == "unset"
                         else args.mutation_fail_closed == "true"),
            batch_max_wait=args.mutation_batch_max_wait,
            max_queue=args.admission_max_queue,
            default_timeout=args.admission_default_timeout)
    auditor = None
    if "auditslice" in serve:
        from .audit import AuditSliceServer

        # scope this driver's review building to its consistent-hash
        # slice; the leader feeds it owned objects + the broadcast set
        if args.audit_shard_id >= 0 and args.audit_shard_count > 1:
            driver.set_audit_shard(args.audit_shard_id,
                                   args.audit_shard_count)
        auditor = AuditSliceServer(client,
                                   shard_id=max(args.audit_shard_id, 0),
                                   shard_count=args.audit_shard_count)
    sink = LibrarySink(client, mutation_system)
    if validation is not None:
        # replicated serving-knob ops land on this engine's batcher
        # (unknown keys dropped: a version-skewed primary must not
        # TypeError the control stream)
        sink.on_knobs = lambda kn: validation.batcher.set_knobs(
            **{key: v for key, v in (kn or {}).items()
               if key in ("max_wait", "max_batch", "max_queue")})
    if auditor is not None:
        # a respawned shard must 503 sweeps until its slice resync
        # lands — an empty-library sweep would silently drop this
        # partition's violations from the composed round
        auditor.ready = lambda: sink.synced
    # saturation probes, same set the primary registers: this child has
    # no /metrics server, so the probes refresh on each M-frame stats
    # poll instead and the gauges relay to the primary (engine-labeled
    # series — per-chip duty cycle / queue depth must be readable off
    # the primary's one scrape, not just for engine 0)
    if validation is not None:
        metrics.register_saturation_probe(
            "admission-queue",
            lambda b=validation.batcher: metrics.report_queue_depth(
                "admission", b.pending(), engine=args.engine_id))
    if mutation is not None:
        metrics.register_saturation_probe(
            "mutation-queue",
            lambda b=mutation.batcher: metrics.report_queue_depth(
                "mutation", b.pending(), engine=args.engine_id))
    if hasattr(driver, "duty_cycle"):
        metrics.register_saturation_probe(
            "engine-duty-cycle",
            lambda: metrics.report_duty_cycle(driver.duty_cycle()))

    def stats_source():
        metrics.run_saturation_probes()
        return metrics.engine_stats_snapshot()

    engine = BackplaneEngine(
        args.socket, validation=validation, ns_label=ns_label,
        mutation=mutation,
        default_timeout=args.admission_default_timeout,
        engine_id=args.engine_id,
        library_sink=sink,
        stats_source=stats_source,
        auditor=auditor)
    # refuse admission until the supervisor's first full sync lands:
    # the frontends' router fails those requests over to synced engines
    engine.ready_check = lambda: sink.synced
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    engine.start()
    # long-lived-server GC tuning, same rationale as the frontends
    import gc

    gc.collect()
    gc.freeze()
    print("READY", flush=True)
    try:
        stop.wait()
    finally:
        engine.stop()
        # mirror teardown for the probes registered above: a final
        # stats poll racing shutdown must relay zeros, not the last
        # burst's depth/duty (the supervisor also zeroes the relayed
        # series on child death — this covers the graceful path)
        for probe in ("admission-queue", "mutation-queue",
                      "engine-duty-cycle"):
            metrics.unregister_saturation_probe(probe)
        if validation is not None:
            metrics.report_queue_depth("admission", 0,
                                       engine=args.engine_id)
        if mutation is not None:
            metrics.report_queue_depth("mutation", 0,
                                       engine=args.engine_id)
        metrics.report_duty_cycle(0.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
