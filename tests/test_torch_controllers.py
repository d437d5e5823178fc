"""The port's reconcile controllers against the JAX package's.

The controller and audit cases of tests/test_control_plane.py,
re-expressed on a directly built ControllerManager and AuditManager (the
reference's cases go through `main.Runtime`, which the port does not
have yet; the audit manager is built as Runtime builds it, on the
GuardedKube with the write breaker, and swept by `audit_once()` instead
of its interval loop), and the shipped
library ingested, edited and deleted through the kube: each case runs
through both packages' `control.controllers` on a FakeKube behind a
GuardedKube (as Runtime wires them), with TorchDriver on the CPU in the
port and TpuDriver in the JAX package. Every case returns a transcript
of what it observed (admission responses, results, the status writes
the kube recorded, the objects' final status), and the transcripts must
be equal (exact). The reference's own expectations are asserted inside
each case as well.
"""

from __future__ import annotations

import contextlib
import copy
import json
import threading
import time
import types

import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.control import audit as jaudit
from gatekeeper_tpu.control import controllers as jctrl
from gatekeeper_tpu.control import kube as jkube
from gatekeeper_tpu.control import resilience as jres
from gatekeeper_tpu.control import watch as jwatch
from gatekeeper_tpu.control import webhook as jwebhook
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.mutation import MutationSystem as JMutationSystem
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu.utils.faults import FAULTS as JFAULTS
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.control import audit as taudit
from gatekeeper_tpu_torch.control import controllers as tctrl
from gatekeeper_tpu_torch.control import kube as tkube
from gatekeeper_tpu_torch.control import resilience as tres
from gatekeeper_tpu_torch.control import watch as twatch
from gatekeeper_tpu_torch.control import webhook as twebhook
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir import evaltorch as teval
from gatekeeper_tpu_torch.mutation import MutationSystem as TMutationSystem
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils.faults import FAULTS as TFAULTS

from .test_torch_frontend import fixture_objects, library_constraints

JAX = types.SimpleNamespace(
    name="jax", driver=TpuDriver, Backend=JBackend, Target=JTarget,
    audit=jaudit, ctrl=jctrl, kube=jkube, res=jres, watch=jwatch, webhook=jwebhook,
    pol=jpol, faults=JFAULTS, MutationSystem=JMutationSystem)
TORCH = types.SimpleNamespace(
    name="torch", driver=lambda **kw: TorchDriver(device="cpu", **kw),
    Backend=TBackend, Target=TTarget, audit=taudit, ctrl=tctrl, kube=tkube, res=tres,
    watch=twatch, webhook=twebhook, pol=tpol, faults=TFAULTS,
    MutationSystem=TMutationSystem)

TEMPLATE_GVK = ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
RL_GVK = (CONSTRAINT_GROUP, "v1beta1", "K8sRequiredLabels")
CRD_GVK = ("apiextensions.k8s.io", "v1beta1", "CustomResourceDefinition")
NS_GVK = ("", "v1", "Namespace")

# tests/test_control_plane.py's TEMPLATE and CONSTRAINT
TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8srequiredlabels"},
    "spec": {
        "crd": {"spec": {
            "names": {"kind": "K8sRequiredLabels"},
            "validation": {"openAPIV3Schema": {"properties": {
                "labels": {"type": "array", "items": {"type": "string"}}}}},
        }},
        "targets": [{
            "target": "admission.k8s.gatekeeper.sh",
            "rego": """
package k8srequiredlabels
violation[{"msg": msg}] {
  provided := {l | input.review.object.metadata.labels[l]}
  required := {l | l := input.parameters.labels[_]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("missing labels: %v", [missing])
}
""",
        }],
    },
}

CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels",
    "metadata": {"name": "ns-must-have-owner"},
    "spec": {
        "match": {"kinds": [{"apiGroups": [""], "kinds": ["Namespace"]}]},
        "parameters": {"labels": ["owner"]},
    },
}

# main.Runtime's built-in kinds on a FakeKube
BUILTIN_KINDS = [
    (NS_GVK, False), (("", "v1", "Pod"), True), (("", "v1", "Service"), True),
    (("", "v1", "Secret"), True), (("apps", "v1", "Deployment"), True),
    (TEMPLATE_GVK, False), (("config.gatekeeper.sh", "v1alpha1", "Config"),
                            True),
    (CRD_GVK, False),
    (("mutations.gatekeeper.sh", "v1alpha1", "Assign"), False),
    (("mutations.gatekeeper.sh", "v1alpha1", "AssignMetadata"), False),
    (("mutations.gatekeeper.sh", "v1alpha1", "ModifySet"), False),
]


def admission_review(obj, operation="CREATE", username="alice"):
    group, _, version = (obj.get("apiVersion") or "").rpartition("/")
    req = {
        "uid": "uid-1",
        "kind": {"group": group, "version": version, "kind": obj["kind"]},
        "operation": operation,
        "name": obj["metadata"]["name"],
        "userInfo": {"username": username},
        "object": obj,
    }
    ns = obj["metadata"].get("namespace")
    if ns:
        req["namespace"] = ns
    return {"apiVersion": "admission.k8s.io/v1beta1",
            "kind": "AdmissionReview", "request": req}


def ns(name, labels=None):
    o = {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": name}}
    if labels is not None:
        o["metadata"]["labels"] = labels
    return o


@contextlib.contextmanager
def plane(P, driver=None, mutation_system=None, **audit_kw):
    """A FakeKube with Runtime's built-in kinds, a client on `driver`
    (the package's device driver on the CPU by default), and a started
    ControllerManager over a GuardedKube, with a ValidationHandler on the
    client and an AuditManager (`audit_kw`: its options) on the
    GuardedKube and its write breaker, not started. Stopped on exit."""
    kube = P.kube.FakeKube()
    for gvk, namespaced in BUILTIN_KINDS:
        kube.register_kind(gvk, namespaced=namespaced)
    breaker = P.res.CircuitBreaker("kube-writes")
    guard = P.res.GuardedKube(kube, breaker, P.res.RetryBudget(10.0))
    drv = driver if driver is not None else P.driver()
    client = P.Backend(drv).new_client([P.Target()])
    mgr = P.ctrl.ControllerManager(guard, client,
                                   mutation_system=mutation_system)
    mgr.start()
    handler = P.webhook.ValidationHandler(client)
    audit = P.audit.AuditManager(guard, client, write_breaker=breaker,
                                 **audit_kw)
    ns_ = types.SimpleNamespace(kube=kube, client=client, drv=drv, mgr=mgr,
                                handler=handler, audit=audit)
    try:
        yield ns_
    finally:
        audit.stop()
        mgr.stop()
        handler.batcher.stop()


def status_writes(kube) -> list:
    """The status writes the kube recorded, in a stable order."""
    return sorted(repr(c) for c in kube.calls
                  if c[0] == "update" and c[3] == "status")


def constraint_status(obj) -> dict:
    """A constraint's status without its auditTimestamp (a clock)."""
    st = dict(obj.get("status") or {})
    st.pop("auditTimestamp", None)
    return st


def statuses(kube, gvks) -> dict:
    return {repr(g): {o["metadata"]["name"]: o.get("status")
                      for o in kube.list(g)} for g in gvks}


def verdict(out) -> dict:
    return out["response"]


def result_key(results) -> list:
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


# ------------------------------------ tests/test_control_plane.py's cases


def case_full_lifecycle(P):
    """:109: template, constraint, admission, the audit manager's
    discovery sweep writing the constraint's status, then deletes."""
    out = []
    with plane(P) as p:
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        crd = kube.get(CRD_GVK, "k8srequiredlabels.constraints.gatekeeper.sh")
        assert crd["spec"]["names"]["kind"] == "K8sRequiredLabels"
        templ = kube.get(TEMPLATE_GVK, "k8srequiredlabels")
        assert templ["status"]["created"] is True
        assert templ["status"]["byPod"][0]["observedGeneration"] == 0
        assert p.client.knows_kind("K8sRequiredLabels")
        out.append(templ["status"])
        kube.create(CONSTRAINT)
        p.mgr.drain()
        stored = kube.get(RL_GVK, "ns-must-have-owner")
        assert stored["status"]["byPod"][0]["enforced"] is True
        out.append(stored["status"])
        deny = verdict(p.handler.handle(admission_review(ns("shipping"))))
        assert deny["allowed"] is False
        assert "missing labels" in deny["status"]["reason"]
        allow = verdict(p.handler.handle(
            admission_review(ns("ok", {"owner": "me"}))))
        assert allow["allowed"] is True
        out += [deny, allow]
        kube.create(ns("bad-1"))
        kube.create(ns("good-1", {"owner": "me"}))
        swept = result_key(p.audit.audit_once())
        stored = kube.get(RL_GVK, "ns-must-have-owner")
        viol = stored["status"]["violations"]
        assert any(v["name"] == "bad-1" for v in viol)
        assert stored["status"]["totalViolations"] >= 1
        assert all(v["enforcementAction"] == "deny" for v in viol)
        out += [swept, constraint_status(stored)]
        kube.delete(RL_GVK, "ns-must-have-owner")
        p.mgr.drain()
        after = verdict(p.handler.handle(admission_review(ns("shipping"))))
        assert after["allowed"] is True
        kube.delete(TEMPLATE_GVK, "k8srequiredlabels")
        p.mgr.drain()
        assert not p.client.knows_kind("K8sRequiredLabels")
        out += [after, status_writes(kube)]
    return out


def case_sync_config_populates_inventory(P):
    """:179."""
    with plane(P) as p:
        kube = p.kube
        kube.create({
            "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
            "metadata": {"name": "config", "namespace": "gatekeeper-system"},
            "spec": {"sync": {"syncOnly": [
                {"group": "", "version": "v1", "kind": "Namespace"}]}},
        })
        kube.create(ns("synced-ns", {"team": "a"}))
        p.mgr.drain()
        time.sleep(0.05)
        p.mgr.drain()
        path = ("external", "admission.k8s.gatekeeper.sh", "cluster", "v1",
                "Namespace", "synced-ns")
        data = p.client.driver.get_data(path)
        assert data is not None and data["metadata"]["name"] == "synced-ns"
        kube.delete(NS_GVK, "synced-ns")
        p.mgr.drain()
        assert p.client.driver.get_data(path) is None
        return [data["metadata"]["labels"], p.mgr.wm.watched_gvks()]


def case_dryrun_constraint_does_not_deny(P):
    """:203: a dryrun constraint admits, and the audit manager's sweep
    still reports it on the constraint's status."""
    with plane(P) as p:
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        c = copy.deepcopy(CONSTRAINT)
        c["spec"]["enforcementAction"] = "dryrun"
        kube.create(c)
        p.mgr.drain()
        out = verdict(p.handler.handle(admission_review(ns("shipping"))))
        assert out["allowed"] is True
        kube.create(ns("bad-dry"))
        res = p.audit.audit_once()
        assert any(r.enforcement_action == "dryrun" for r in res)
        stored = kube.get(RL_GVK, "ns-must-have-owner")
        assert any(v["enforcementAction"] == "dryrun"
                   for v in stored["status"]["violations"])
        return [out, result_key(res), constraint_status(stored),
                status_writes(kube)]


def case_audit_respects_violation_limit(P):
    """:163: the status carries `limit` violations and the total."""
    with plane(P) as p:
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        kube.create(CONSTRAINT)
        p.mgr.drain()
        p.audit.limit = 3
        for i in range(10):
            kube.create(ns(f"bad-{i}"))
        res = p.audit.audit_once()
        stored = kube.get(RL_GVK, "ns-must-have-owner")
        assert len(stored["status"]["violations"]) == 3
        assert stored["status"]["totalViolations"] == 10
        return [result_key(res), constraint_status(stored),
                status_writes(kube)]


def case_discovery_audit_resolves_namespace_selector(P):
    """:222: the discovery sweep sideloads the listed Namespaces, so a
    namespaceSelector constraint decides on an unsynced cluster."""
    with plane(P) as p:
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        c = copy.deepcopy(CONSTRAINT)
        c["metadata"]["name"] = "owner-in-prod-ns"
        c["spec"]["match"] = {
            "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
            "namespaceSelector": {"matchLabels": {"env": "prod"}},
        }
        kube.create(c)
        p.mgr.drain()
        kube.create(ns("prod-ns", {"env": "prod"}))
        kube.create(ns("dev-ns", {"env": "dev"}))
        for name, namespace in (("unlabeled-prod", "prod-ns"),
                                ("unlabeled-dev", "dev-ns")):
            kube.create({"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": name,
                                      "namespace": namespace}})
        assert p.client.driver.get_data(
            ("external", "admission.k8s.gatekeeper.sh", "cluster", "v1",
             "Namespace", "prod-ns")) is None
        res = p.audit.audit_once()
        stored = kube.get(RL_GVK, "owner-in-prod-ns")
        viol = stored["status"]["violations"]
        names = {v["name"] for v in viol}
        assert "unlabeled-prod" in names, viol
        assert "unlabeled-dev" not in names, viol
        assert all("not cached in OPA" not in v["message"] for v in viol)
        return [result_key(res), constraint_status(stored)]


def case_audit_from_cache_sweeps_synced_inventory_only(P):
    """:734: the from-cache sweep sees only the Config's synced kinds."""
    with plane(P, audit_from_cache=True) as p:
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        c = copy.deepcopy(CONSTRAINT)
        c["spec"]["match"]["kinds"] = [
            {"apiGroups": [""], "kinds": ["Namespace", "Pod"]}]
        kube.create(c)
        kube.create({
            "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
            "metadata": {"name": "config", "namespace": "gatekeeper-system"},
            "spec": {"sync": {"syncOnly": [
                {"group": "", "version": "v1", "kind": "Namespace"}]}},
        })
        kube.create(ns("unlabeled-ns"))
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "unlabeled-pod",
                                  "namespace": "unlabeled-ns"}})
        p.mgr.drain()
        res = p.audit.audit_once()
        stored = kube.get(RL_GVK, "ns-must-have-owner")
        names = {v["name"] for v in stored["status"]["violations"]}
        assert "unlabeled-ns" in names, names
        assert "unlabeled-pod" not in names, names
        assert stored["status"]["totalViolations"] == len(names)
        return [result_key(res), constraint_status(stored)]


def case_watch_manager_refcounting(P):
    """:495."""
    kube = P.kube.FakeKube()
    kube.register_kind(NS_GVK, namespaced=False)
    wm = P.watch.WatchManager(kube)
    r1 = wm.registrar("a")
    r2 = wm.registrar("b")
    kube.create(ns("pre-existing"))
    r1.add_watch(NS_GVK)
    assert wm.is_watched(NS_GVK)
    ev1 = r1.events.get(timeout=1)
    assert ev1.object["metadata"]["name"] == "pre-existing"
    r2.add_watch(NS_GVK)
    ev2 = r2.events.get(timeout=1)
    assert ev2.object["metadata"]["name"] == "pre-existing"
    r1.remove_watch(NS_GVK)
    still = wm.is_watched(NS_GVK)
    assert still
    r2.remove_watch(NS_GVK)
    assert not wm.is_watched(NS_GVK)
    wm.stop()
    return [ev1.type, ev1.object, ev2.type, still]


def case_status_writes_reach_fixpoint(P):
    """:551."""
    with plane(P) as p:
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        kube.create(CONSTRAINT)
        p.mgr.drain()
        rv0 = kube.get(RL_GVK, "ns-must-have-owner")["metadata"][
            "resourceVersion"]
        trv0 = kube.get(TEMPLATE_GVK, "k8srequiredlabels")["metadata"][
            "resourceVersion"]
        writes = status_writes(kube)
        time.sleep(0.5)  # idle: no event should cause further writes
        p.mgr.drain()
        assert kube.get(RL_GVK, "ns-must-have-owner")["metadata"][
            "resourceVersion"] == rv0, "constraint status keeps rewriting"
        assert kube.get(TEMPLATE_GVK, "k8srequiredlabels")["metadata"][
            "resourceVersion"] == trv0, "template status keeps rewriting"
        assert status_writes(kube) == writes
        return [rv0, trv0, writes]


def case_deleted_constraint_not_resurrected_by_stale_event(P):
    """:572."""
    with plane(P) as p:
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        kube.create(CONSTRAINT)
        p.mgr.drain()
        stale = kube.get(RL_GVK, "ns-must-have-owner")
        kube.delete(RL_GVK, "ns-must-have-owner")
        p.mgr.drain()
        p.mgr.constraint_ctrl.reconcile(P.kube.WatchEvent("MODIFIED", stale))
        out = verdict(p.handler.handle(admission_review(ns("anything"))))
        assert out["allowed"] is True, \
            "deleted constraint still denying admissions"
        return [out, status_writes(kube)]


def case_teardown_scrubs_finalizers_on_shutdown(P):
    """:781: the manager's stop() scrubs the finalizer."""
    with plane(P) as p:
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        fins = kube.get(TEMPLATE_GVK, "k8srequiredlabels")["metadata"].get(
            "finalizers") or []
        assert P.ctrl.FINALIZER in fins, "reconcile must add the finalizer"
    after = kube.get(TEMPLATE_GVK, "k8srequiredlabels")["metadata"].get(
        "finalizers") or []
    assert P.ctrl.FINALIZER not in after, "shutdown must scrub the finalizer"
    return [fins, after]


# ------------------------------ the library through the kube, and faults


def pinned(drv) -> None:
    """Every batch and sweep on the device path (the plain versions on
    the CPU in the port), as the JAX package's tests pin it."""
    drv._use_device_for_batch = lambda n: True


def case_library_ingest_edit_delete(P):
    """The 23 shipped templates and their constraints written to the
    kube, a Config syncing the corpus kinds and 120 corpus objects:
    reviews and an audit on the device path; then one constraint's
    parameters changed and one template deleted through the kube, and
    the same again. Status writes reach a fixpoint."""
    drv = P.driver()
    pinned(drv)
    objs = fixture_objects(120)
    gvks = sorted({(o["apiVersion"].rpartition("/")[0],
                    o["apiVersion"].rpartition("/")[2], o["kind"])
                   for o in objs})
    out = []
    with plane(P, driver=drv) as p:
        kube = p.kube
        for gvk in gvks:
            kube.register_kind(gvk, namespaced=True)
        for name in P.pol.names():
            kube.create(P.pol.load(name))
        p.mgr.drain(60)
        for c in library_constraints():
            kube.create(c)
        kube.create({
            "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
            "metadata": {"name": "config", "namespace": "gatekeeper-system"},
            "spec": {"sync": {"syncOnly": [
                {"group": g, "version": v, "kind": k} for g, v, k in gvks]}},
        })
        p.mgr.drain(60)
        for o in objs:  # a later copy of a name replaces the earlier
            kube.apply(copy.deepcopy(o))
        p.mgr.drain(60)
        kinds = sorted({c["kind"] for c in library_constraints()})
        cgvks = [(CONSTRAINT_GROUP, "v1beta1", k) for k in kinds]
        assert len(p.client.driver.compiled_kinds()) == 23

        def observe():
            reviews = [result_key(r.results())
                       for r in p.client.review_batch(objs[:48])]
            audit = result_key(p.client.audit().results())
            return [reviews, audit]

        out += observe()
        edit = kube.get((CONSTRAINT_GROUP, "v1beta1", "K8sContainerLimits"),
                        "limits-capped")
        edit["spec"]["parameters"] = {"cpu": "500m", "memory": "256Mi"}
        kube.update(edit)
        kube.delete(TEMPLATE_GVK, "k8shttpsonly")
        p.mgr.drain(60)
        assert not p.client.knows_kind("K8sHttpsOnly")
        out += observe()
        writes = status_writes(kube)
        time.sleep(0.3)
        p.mgr.drain(60)
        assert status_writes(kube) == writes, "status writes keep coming"
        out += [writes, statuses(kube, [TEMPLATE_GVK] + cgvks)]
    return out


def case_quarantine_surfaces_on_template_status(P):
    """Runtime's wiring: the driver's on_quarantine is the template
    controller's note_quarantine. A device-path failure of a kind writes
    the quarantine on its template's byPod status. In both packages the
    template's own reconcile of that write (a MODIFIED event) then
    rewrites the status without it; the probe that restores the device
    path writes nothing more. The template's status is read from every
    MODIFIED event."""
    drv = P.driver()
    pinned(drv)
    drv.quarantine_base_s = 0.2
    out = []
    with plane(P, driver=drv) as p:
        drv.on_quarantine = p.mgr.template_ctrl.note_quarantine
        kube = p.kube
        kube.create(TEMPLATE)
        p.mgr.drain()
        kube.create(CONSTRAINT)
        p.mgr.drain()
        seen: list = []
        cancel = kube.watch(TEMPLATE_GVK, lambda ev: seen.append(
            (ev.type, ev.object.get("status"))), send_initial=False)
        for i in range(4):
            p.client.add_data(ns(f"n{i}", {"owner": "x"} if i % 2 else None))

        def notes_done():
            for t in threading.enumerate():
                if t.name.startswith("quarantine-note-"):
                    t.join(10)
            p.mgr.drain()

        P.faults.inject("eval.device", mode="raise",
                        match={"kind": "K8sRequiredLabels"})
        try:
            out.append(result_key(p.client.audit().results()))
            notes_done()
        finally:
            P.faults.clear("eval.device")
        assert drv.quarantine_status()["K8sRequiredLabels"]["fails"] == 1
        noted = [st for _t, st in seen
                 if st["byPod"][0].get("errors")]
        assert len(noted) == 1 and "device path quarantined" in \
            noted[0]["byPod"][0]["errors"][0]["message"]
        time.sleep(0.25)  # the backoff expires: the probe restores it
        out.append(result_key(p.client.audit().results()))
        notes_done()
        assert drv.quarantine_status() == {}
        cancel()
        out += [seen, kube.get(TEMPLATE_GVK, "k8srequiredlabels")["status"],
                status_writes(kube)]
    return out


def case_mutator_controller_ingests_and_quarantines(P):
    """The mutator controller (ControllerManager with a MutationSystem):
    mutators written to the kube reach the system, a schema conflict
    between two of them shows on both statuses, and deleting one clears
    the other's."""
    system = P.MutationSystem()
    gvk = ("mutations.gatekeeper.sh", "v1alpha1", "Assign")

    def assign(name, location, value):
        return {"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
                "kind": "Assign", "metadata": {"name": name},
                "spec": {"applyTo": [{"groups": [""], "versions": ["v1"],
                                      "kinds": ["Pod"]}],
                         "location": location,
                         "parameters": {"assign": {"value": value}}}}

    with plane(P, mutation_system=system) as p:
        kube = p.kube
        kube.create(assign("pull", "spec.containers[name: *].imagePullPolicy",
                           "Always"))
        p.mgr.drain()
        ok = kube.get(gvk, "pull")["status"]
        kube.create(assign("as-list", "spec.containers", "x"))
        kube.create(assign("as-object", "spec.containers.name", "y"))
        p.mgr.drain()
        conflicted = statuses(kube, [gvk])
        kube.delete(gvk, "as-list")
        p.mgr.drain()
        healed = statuses(kube, [gvk])
        return [ok, conflicted, healed, sorted(system.counts().items()),
                status_writes(kube)]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_controller_case_equal(case):
    try:
        got = case(TORCH)
        want = case(JAX)
    finally:
        TFAULTS.reset()
        JFAULTS.reset()
    assert json.loads(json.dumps(got, default=repr)) == \
        json.loads(json.dumps(want, default=repr))


def test_controller_ingest_under_async_warm_stays_off_the_workers(tmp_path):
    """Under async warm with a program store, a template the template
    controller ingests starts its prewarm on a thread of its own: no
    K2 preload and no device sweep runs on a controller's worker thread
    (a compile there would stall every later reconcile)."""
    seen: list = []
    words = teval.CompiledTemplate.words
    preload = teval.CompiledTemplate.preload_aot

    def on(name):
        def rec(self, *a, **k):
            seen.append((name, threading.current_thread().name))
            return (words if name == "words" else preload)(self, *a, **k)
        return rec

    teval.CompiledTemplate.words = on("words")
    teval.CompiledTemplate.preload_aot = on("preload")
    try:
        drv = TorchDriver(device="cpu", aot_dir=str(tmp_path))
        drv.async_warm = True
        pinned(drv)
        with plane(TORCH, driver=drv) as p:
            p.kube.create(TEMPLATE)
            p.mgr.drain()
            p.kube.create(CONSTRAINT)
            p.mgr.drain()
            for t in threading.enumerate():
                if t.name.startswith("aot-prewarm-"):
                    t.join(10)
            p.client.add_data(ns("bad"))
            got = result_key(p.client.audit().results())
            for t in threading.enumerate():
                if t.name.startswith("warm-"):
                    t.join(30)
    finally:
        teval.CompiledTemplate.words = words
        teval.CompiledTemplate.preload_aot = preload
    assert got == [("missing labels: {\"owner\"}", "ns-must-have-owner",
                    "bad", "deny")]
    assert ("preload", "aot-prewarm-K8sRequiredLabels") in seen
    assert not [s for s in seen if s[1].startswith("ctrl-")], seen
