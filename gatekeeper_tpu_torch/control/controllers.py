"""Reconcile control plane: template / constraint / config / sync.

Counterparts of the reference pkg/controller/* reconcilers, level-
triggered over the watch manager:

  * TemplateController (constrainttemplate_controller.go:176-388): on
    upsert — CreateCRD + AddTemplate into the Client, create/update the
    per-template constraint CRD in-cluster, register a dynamic watch for
    the generated constraint kind; on delete — remove watch then template;
    byPod status + finalizer handling; TearDownState at shutdown
    (:466-556).
  * ConstraintController (constraint_controller.go:155-278): events for
    any generated kind arrive via the shared registrar with the GVK packed
    into the request (util/pack.go); AddConstraint/RemoveConstraint with
    semantic-equal dedupe inside the Client, byPod status, per-action
    constraint-count metrics.
  * ConfigController (config_controller.go:165-287): singleton
    gatekeeper-system/config; computes the syncOnly GVK set, wipes driver
    data, ReplaceWatch on the sync registrar, replays cached objects.
  * SyncController (sync_controller.go:128-210): AddData/RemoveData per
    event into the driver inventory with sync metrics.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

from ..client import Client, ClientError
from ..target.handler import WipeData
from . import metrics
from .audit import AUDIT_STATUS_KEYS
from .kube import GVK, FakeKube, KubeError, NotFound, WatchEvent, gvk_of
from .logging import logger
from .resilience import NotLeader, guarded_status_update
from .util import (
    DEFAULT_ENFORCEMENT_ACTION,
    VALID_ENFORCEMENT_ACTIONS,
    by_pod_status_unchanged,
    set_by_pod_status,
)
from .watch import WatchManager

TEMPLATE_GVK = ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
CONFIG_GVK = ("config.gatekeeper.sh", "v1alpha1", "Config")
CRD_GVK = ("apiextensions.k8s.io", "v1beta1", "CustomResourceDefinition")
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
MUTATOR_GROUP = "mutations.gatekeeper.sh"
MUTATOR_GVKS = tuple((MUTATOR_GROUP, "v1alpha1", kind)
                     for kind in ("Assign", "AssignMetadata", "ModifySet"))
FINALIZER = "finalizers.gatekeeper.sh/constrainttemplate"

log = logger("controller")


def _retry_status_update(kube, obj: dict, attempts: int = 5) -> None:
    """Status write with conflict retry (reference retry loops, e.g.
    constrainttemplate_controller.go:548-555), riding the shared
    breaker-aware protocol in resilience.guarded_status_update."""

    def refresh(cur_obj):
        try:
            cur = kube.get(gvk_of(cur_obj),
                           (cur_obj.get("metadata") or {}).get("name")
                           or "",
                           (cur_obj.get("metadata") or {}).get("namespace")
                           or "")
        except KubeError:
            return None
        # a conflict means another writer landed first: put back every
        # key of this write but the audit's, which stay as they live
        # (a byPod write prepared before an audit sweep's status write
        # must not erase its totals)
        live = cur.get("status") or {}
        status = {k: v for k, v in (cur_obj.get("status") or {}).items()
                  if k not in AUDIT_STATUS_KEYS}
        status.update((k, live[k]) for k in AUDIT_STATUS_KEYS if k in live)
        cur["status"] = status
        return cur

    guarded_status_update(kube, obj, refresh, attempts)


class _Worker:
    """Queue-draining reconcile loop shared by all controllers."""

    def __init__(self, name: str, registrar, handle) -> None:
        self.name = name
        self.registrar = registrar
        self.handle = handle
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"ctrl-{name}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout=2.0):
        self._thread.join(timeout)

    def idle(self) -> bool:
        """No queued events AND no popped-but-unhandled event:
        unfinished_tasks increments at put() and only decrements at the
        loop's task_done() after handle() returns, so there is no
        window where an event is in flight but invisible."""
        return self.registrar.events.unfinished_tasks == 0

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                event = self.registrar.events.get(timeout=0.1)
            except Exception:
                continue
            try:
                self.handle(event)
            except Exception as e:  # reconcile must never die
                log.error(f"{self.name}: reconcile error: {e}",
                          event_type=event.type)
            finally:
                self.registrar.events.task_done()


# ------------------------------------------------------------------ template


class TemplateController:
    def __init__(self, kube, opa: Client, wm: WatchManager,
                 constraint_ctrl: "ConstraintController"):
        self.kube = kube
        self.opa = opa
        self.wm = wm
        self.constraint_ctrl = constraint_ctrl
        self.registrar = wm.registrar("constrainttemplate")
        self.worker = _Worker("constrainttemplate", self.registrar,
                              self.reconcile)
        self._tracked: dict[str, GVK] = {}  # template name -> constraint gvk

    def start(self) -> None:
        self.registrar.add_watch(TEMPLATE_GVK)
        self.worker.start()

    def reconcile(self, event: WatchEvent) -> None:
        obj = event.object
        name = (obj.get("metadata") or {}).get("name") or ""
        if event.type == "DELETED":
            self._handle_delete_by_name(name)
            return
        try:
            obj = self.kube.get(TEMPLATE_GVK, name)
        except NotFound:
            self._handle_delete_by_name(name)
            return
        if (obj.get("metadata") or {}).get("deletionTimestamp"):
            self._handle_delete_by_name(name)
            self._remove_finalizer(obj)
            return
        t0 = time.monotonic()
        try:
            crd = self.opa.create_crd(obj)
            self.opa.add_template(obj)
        except ClientError as e:
            log.error("template ingestion failed", template_name=name,
                      details=str(e))
            metrics.report_template_ingestion("error", time.monotonic() - t0)
            self._write_status(obj, created=False, errors=[str(e)])
            return
        kind = crd["spec"]["names"]["kind"]
        self._ensure_finalizer(obj)
        # create/update the generated constraint CRD in-cluster
        try:
            self.kube.apply(crd)
        except NotLeader:
            # defensive: controllers normally ride the UNGATED guard
            # (byPod slots are pod-owned, CRD applies idempotent), but
            # tolerate an operator wiring a fenced client
            pass
        except KubeError as e:
            log.warning("constraint CRD apply failed", template_name=name,
                        details=str(e))
        gvk = (CONSTRAINT_GROUP, "v1beta1", kind)
        # unwrap a resilience.GuardedKube proxy for the fake check
        if isinstance(getattr(self.kube, "inner", self.kube), FakeKube):
            self.kube.register_kind(gvk, namespaced=False)
        self._tracked[name] = gvk
        self.constraint_ctrl.registrar.add_watch(gvk)
        metrics.report_template_ingestion("ok", time.monotonic() - t0)
        metrics.report_constraint_templates("active", len(self._tracked))
        self._write_status(obj, created=True)

    def note_quarantine(self, kind: str, reason: Optional[str]) -> None:
        """Driver callback (TpuDriver.on_quarantine): surface a device-
        path quarantine — or its recovery (reason=None) — on the owning
        ConstraintTemplate's byPod status, so `kubectl get` shows WHY a
        template's reviews run degraded."""
        # snapshot: this runs on a driver notification thread while the
        # controller worker mutates _tracked (dict-changed-size race)
        name = next((n for n, g in list(self._tracked.items())
                     if g[2] == kind), None)
        if name is None:
            return
        try:
            obj = self.kube.get(TEMPLATE_GVK, name)
        except KubeError:
            return
        errors = [f"device path quarantined: {reason} (interpreter "
                  "fallback serving reviews)"] if reason else None
        self._write_status(obj, created=True, errors=errors)

    def _handle_delete_by_name(self, name: str) -> None:
        gvk = self._tracked.pop(name, None)
        if gvk is not None:
            self.constraint_ctrl.registrar.remove_watch(gvk)
            templ = {
                "apiVersion": "templates.gatekeeper.sh/v1beta1",
                "kind": "ConstraintTemplate",
                "metadata": {"name": name},
                "spec": {"crd": {"spec": {"names": {"kind": gvk[2]}}},
                         "targets": [{"target":
                                      "admission.k8s.gatekeeper.sh",
                                      "rego": "package x\nviolation[{\"msg\": \"\"}] { false }"}]},
            }
            try:
                self.opa.remove_template(templ)
            except ClientError:
                pass
            metrics.report_constraint_templates("active", len(self._tracked))

    def _ensure_finalizer(self, obj: dict) -> None:
        meta = obj.setdefault("metadata", {})
        fins = meta.setdefault("finalizers", [])
        if FINALIZER not in fins:
            fins.append(FINALIZER)
            try:
                self.kube.update(obj)
            except KubeError:
                pass

    def _remove_finalizer(self, obj: dict) -> None:
        meta = obj.setdefault("metadata", {})
        fins = [f for f in meta.get("finalizers") or [] if f != FINALIZER]
        meta["finalizers"] = fins
        try:
            self.kube.update(obj)
        except KubeError:
            pass

    def _write_status(self, obj: dict, created: bool,
                      errors: Optional[list] = None) -> None:
        entry: dict[str, Any] = {"observedGeneration":
                                 (obj.get("metadata") or {}).get("generation", 0)}
        if errors:
            entry["errors"] = [{"message": e} for e in errors]
        if (by_pod_status_unchanged(obj, entry)
                and (obj.get("status") or {}).get("created") == created):
            return
        set_by_pod_status(obj, entry)
        obj.setdefault("status", {})["created"] = created
        _retry_status_update(self.kube, obj)

    def teardown(self) -> None:
        """Scrub finalizers at shutdown (reference TearDownState)."""
        try:
            for obj in self.kube.list(TEMPLATE_GVK):
                self._remove_finalizer(obj)
        except KubeError:
            pass


# ---------------------------------------------------------------- constraint


class ConstraintController:
    def __init__(self, kube, opa: Client, wm: WatchManager,
                 validate_actions: bool = True):
        self.kube = kube
        self.opa = opa
        self.wm = wm
        self.registrar = wm.registrar("constraint")
        self.worker = _Worker("constraint", self.registrar, self.reconcile)
        self.validate_actions = validate_actions
        self._counts: dict[str, set] = {a: set()
                                        for a in VALID_ENFORCEMENT_ACTIONS}
        self._counts["unrecognized"] = set()

    def start(self) -> None:
        self.worker.start()

    def reconcile(self, event: WatchEvent) -> None:
        obj = event.object
        kind = obj.get("kind") or ""
        name = (obj.get("metadata") or {}).get("name") or ""
        uid = f"{kind}/{name}"
        if event.type != "DELETED":
            # Level-triggered: act on the watch cache (informer-cache
            # analog, constraint_controller.go:174-188), never the possibly
            # stale event payload — a MODIFIED drained after DELETED must
            # not resurrect the constraint. The cache is always at least as
            # new as any drained event and costs no API round-trip.
            ns = (obj.get("metadata") or {}).get("namespace") or ""
            cur = self.wm.cached_get(gvk_of(obj), name, ns)
            if cur is None:
                event = WatchEvent("DELETED", obj)
            else:
                obj = cur
        if event.type == "DELETED":
            try:
                self.opa.remove_constraint(obj)
            except ClientError:
                pass
            for bucket in self._counts.values():
                bucket.discard(uid)
            self._report()
            log.info("constraint deleted", constraint_kind=kind,
                     constraint_name=name)
            return
        spec = obj.get("spec") or {}
        action = spec.get("enforcementAction") or DEFAULT_ENFORCEMENT_ACTION
        recognized = action in VALID_ENFORCEMENT_ACTIONS
        if not recognized and self.validate_actions:
            for bucket in self._counts.values():
                bucket.discard(uid)
            self._counts["unrecognized"].add(uid)
            self._report()
            self._status(obj, enforced=False,
                         errors=[f"unrecognized enforcement action {action}"])
            return
        try:
            self.opa.add_constraint(obj)
        except ClientError as e:
            self._status(obj, enforced=False, errors=[str(e)])
            return
        for bucket in self._counts.values():
            bucket.discard(uid)
        self._counts.setdefault(action, set()).add(uid)
        self._report()
        self._status(obj, enforced=True)
        log.info("constraint added", constraint_kind=kind,
                 constraint_name=name, constraint_action=action)

    def _report(self) -> None:
        for action, bucket in self._counts.items():
            metrics.report_constraints(action, len(bucket))

    def _status(self, obj: dict, enforced: bool,
                errors: Optional[list] = None) -> None:
        entry: dict[str, Any] = {"enforced": enforced,
                                 "observedGeneration":
                                 (obj.get("metadata") or {}).get("generation",
                                                                 0)}
        if errors:
            entry["errors"] = [{"message": e} for e in errors]
        # Skip no-op writes: an unconditional update emits a MODIFIED event
        # back into our own queue and loops forever.
        if by_pod_status_unchanged(obj, entry):
            return
        set_by_pod_status(obj, entry)
        _retry_status_update(self.kube, obj)


# -------------------------------------------------------------------- config


class ConfigController:
    CONFIG_NAME = "config"
    CONFIG_NAMESPACE = "gatekeeper-system"

    def __init__(self, kube, opa: Client, wm: WatchManager,
                 sync_ctrl: "SyncController"):
        self.kube = kube
        self.opa = opa
        self.wm = wm
        self.sync_ctrl = sync_ctrl
        self.registrar = wm.registrar("config")
        self.worker = _Worker("config", self.registrar, self.reconcile)
        self.traces: list[dict] = []

    def start(self) -> None:
        self.registrar.add_watch(CONFIG_GVK)
        self.worker.start()

    def reconcile(self, event: WatchEvent) -> None:
        obj = event.object
        meta = obj.get("metadata") or {}
        # only the singleton is honored (config_controller.go:176-179)
        if (meta.get("name"), meta.get("namespace")) != (
                self.CONFIG_NAME, self.CONFIG_NAMESPACE):
            log.warning("ignoring config: only %s/%s is honored" % (
                self.CONFIG_NAMESPACE, self.CONFIG_NAME))
            return
        spec = obj.get("spec") or {}
        if event.type == "DELETED":
            spec = {}
        sync = (spec.get("sync") or {}).get("syncOnly") or []
        gvks = []
        for entry in sync:
            gvks.append((entry.get("group") or "", entry.get("version") or "",
                         entry.get("kind") or ""))
        self.traces = (spec.get("validation") or {}).get("traces") or []
        # wipe inventory, swap watches, replay cached data
        # (config_controller.go:228-287)
        try:
            self.opa.remove_data(WipeData())
        except ClientError:
            pass
        self.sync_ctrl.registrar.replace_watches(gvks)
        metrics.report_watch_manager(len(self.wm.watched_gvks()), len(gvks))
        log.info("config synced", details={"syncOnly": [list(g) for g in gvks]})


# ---------------------------------------------------------------------- sync


class SyncController:
    def __init__(self, kube, opa: Client, wm: WatchManager):
        self.kube = kube
        self.opa = opa
        self.registrar = wm.registrar("sync")
        self.worker = _Worker("sync", self.registrar, self.reconcile)
        self._synced: dict[str, set] = {}

    def start(self) -> None:
        self.worker.start()

    def reconcile(self, event: WatchEvent) -> None:
        obj = event.object
        kind = obj.get("kind") or ""
        meta = obj.get("metadata") or {}
        uid = f"{kind}/{meta.get('namespace') or ''}/{meta.get('name')}"
        t0 = time.monotonic()
        if event.type == "DELETED":
            try:
                self.opa.remove_data(obj)
            except ClientError:
                pass
            self._synced.setdefault(kind, set()).discard(uid)
        else:
            try:
                self.opa.add_data(obj)
                self._synced.setdefault(kind, set()).add(uid)
            except ClientError as e:
                log.error("sync failed", resource_kind=kind, details=str(e))
                return
        metrics.report_sync_duration(time.monotonic() - t0)
        metrics.report_last_sync()
        for k, bucket in self._synced.items():
            metrics.report_sync("active", k, len(bucket))


# ------------------------------------------------------------------- mutator


class MutatorController:
    """Reconciles Assign / AssignMetadata / ModifySet CRs into the
    MutationSystem (reference pkg/controller/mutators/*): level-triggered
    upsert with semantic-equal dedupe inside the system, ingestion
    metrics, per-kind mutator gauges, and the schema-conflict quarantine
    surfaced as a byPod status condition — on EVERY mutator whose
    conflict state flips, not just the event's subject (a new mutator
    can quarantine an old one, and a deletion can clear it)."""

    def __init__(self, kube, system, wm: WatchManager):
        self.kube = kube
        self.system = system
        self.wm = wm
        self.registrar = wm.registrar("mutator")
        self.worker = _Worker("mutator", self.registrar, self.reconcile)

    def start(self) -> None:
        for gvk in MUTATOR_GVKS:
            self.registrar.add_watch(gvk)
        self.worker.start()

    def reconcile(self, event: WatchEvent) -> None:
        from ..mutation import MutationError

        obj = event.object
        kind = obj.get("kind") or ""
        name = (obj.get("metadata") or {}).get("name") or ""
        if event.type != "DELETED":
            # level-triggered: act on the watch cache, never a possibly
            # stale event payload (same rationale as ConstraintController)
            cur = self.wm.cached_get(gvk_of(obj), name, "")
            if cur is None:
                event = WatchEvent("DELETED", obj)
            else:
                obj = cur
        if event.type == "DELETED":
            changed = self.system.remove((kind, name))
            metrics.report_mutators(self.system.counts())
            self._refresh_statuses(changed - {(kind, name)})
            log.info("mutator deleted", mutator_kind=kind,
                     mutator_name=name)
            return
        t0 = time.monotonic()
        try:
            mutator, changed = self.system.upsert(obj)
        except MutationError as e:
            metrics.report_mutator_ingestion("error", time.monotonic() - t0)
            log.error("mutator ingestion failed", mutator_kind=kind,
                      mutator_name=name, details=str(e))
            self._status(obj, enforced=False, errors=[str(e)])
            return
        metrics.report_mutator_ingestion("ok", time.monotonic() - t0)
        metrics.report_mutators(self.system.counts())
        reason = self.system.conflicts().get(mutator.id)
        self._status(obj, enforced=reason is None,
                     errors=[reason] if reason else None)
        self._refresh_statuses(changed - {mutator.id})
        log.info("mutator ingested", mutator_kind=kind, mutator_name=name,
                 quarantined=bool(reason))

    def _refresh_statuses(self, ids: set) -> None:
        conflicts = self.system.conflicts()
        for kind, name in sorted(ids):
            # the registrar already watches every mutator GVK: serve the
            # object from the informer cache, no API round-trip
            obj = self.wm.cached_get((MUTATOR_GROUP, "v1alpha1", kind),
                                     name, "")
            if obj is None:
                continue
            reason = conflicts.get((kind, name))
            self._status(obj, enforced=reason is None,
                         errors=[reason] if reason else None)

    def _status(self, obj: dict, enforced: bool,
                errors: Optional[list] = None) -> None:
        entry: dict[str, Any] = {"enforced": enforced,
                                 "observedGeneration":
                                 (obj.get("metadata") or {}).get("generation",
                                                                 0)}
        if errors:
            entry["errors"] = [{"message": e} for e in errors]
        if by_pod_status_unchanged(obj, entry):
            return
        set_by_pod_status(obj, entry)
        _retry_status_update(self.kube, obj)


# ------------------------------------------------------------------- manager


class ControllerManager:
    """Wires the four controllers over one watch manager (reference
    pkg/controller/controller.go:41-60 AddToManager)."""

    def __init__(self, kube, opa: Client, wm: Optional[WatchManager] = None,
                 validate_actions: bool = True, mutation_system=None):
        self.kube = kube
        self.opa = opa
        self.wm = wm or WatchManager(kube)
        # client state is rebuilt from the API on start (controller.go:43)
        self.opa.reset()
        self.constraint_ctrl = ConstraintController(
            kube, opa, self.wm, validate_actions)
        self.template_ctrl = TemplateController(
            kube, opa, self.wm, self.constraint_ctrl)
        self.sync_ctrl = SyncController(kube, opa, self.wm)
        self.config_ctrl = ConfigController(kube, opa, self.wm,
                                            self.sync_ctrl)
        self.mutator_ctrl = None
        if mutation_system is not None:
            self.mutator_ctrl = MutatorController(kube, mutation_system,
                                                  self.wm)

    def start(self) -> None:
        self.constraint_ctrl.start()
        self.template_ctrl.start()
        self.sync_ctrl.start()
        self.config_ctrl.start()
        if self.mutator_ctrl is not None:
            self.mutator_ctrl.start()

    def drain(self, timeout: float = 10.0) -> None:
        """Wait until every reconcile queue has no queued OR in-flight
        event (tests; unfinished_tasks covers the popped-but-unhandled
        gap that a queue-empty check plus settle-sleep raced). The
        all-idle predicate reads each queue at a different instant, so
        a later-checked worker can emit into an already-checked queue
        mid-pass — require two consecutive idle passes: a cascade in
        that window leaves its source task unfinished into the second
        pass, or its target queued."""
        deadline = time.monotonic() + timeout
        workers = [self.template_ctrl.worker, self.constraint_ctrl.worker,
                   self.sync_ctrl.worker, self.config_ctrl.worker]
        if self.mutator_ctrl is not None:
            workers.append(self.mutator_ctrl.worker)
        stable = 0
        while time.monotonic() < deadline:
            if all(w.idle() for w in workers):
                stable += 1
                if stable >= 2:
                    return
            else:
                stable = 0
            time.sleep(0.002)

    def stop(self) -> None:
        workers = [self.template_ctrl.worker, self.constraint_ctrl.worker,
                   self.sync_ctrl.worker, self.config_ctrl.worker]
        if self.mutator_ctrl is not None:
            workers.append(self.mutator_ctrl.worker)
        for w in workers:
            w.stop()
        # JOIN before teardown: a worker mid-get() still delivers one
        # last event, and a template reconcile racing the finalizer
        # scrub would re-add what teardown just removed. Generous
        # timeout — a reconcile stuck in status-update retries must get
        # a chance to finish; if it still hasn't, proceed loudly (best-
        # effort teardown beats hanging the shutdown forever)
        for w in workers:
            w.join(timeout=15.0)
            if w._thread.is_alive():
                log.error(f"worker {w.name} still running at shutdown; "
                          "finalizer teardown may race it")
        self.template_ctrl.teardown()
        self.wm.stop()
