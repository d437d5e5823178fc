"""The port's audit manager against the JAX package's: the incremental
audit and the audit plane's trace.

The cases of tests/test_audit_incremental.py and the audit-plane trace
case of tests/test_observability.py (:511), each run through both
packages' `control.audit.AuditManager` on their own FakeKube, with
TorchDriver on the CPU in the port and TpuDriver in the JAX package.
Every case returns a transcript of what it observed (the sweeps'
results, their stats, the status writes the kube recorded, the
constraints' final statuses), and the transcripts must be equal
(exact); the reference's own expectations are asserted inside each case
as well. The other audit-manager differentials import this module's
package namespaces: tests/test_torch_audit_stream.py,
tests/test_torch_audit_materialize.py and tests/test_torch_audit_shard.py.
"""

from __future__ import annotations

import json
import random
import types

import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.client import RegoDriver as JRegoDriver
from gatekeeper_tpu.control import audit as jaudit
from gatekeeper_tpu.control import kube as jkube
from gatekeeper_tpu.control import metrics as jmetrics
from gatekeeper_tpu.control import resilience as jres
from gatekeeper_tpu.control import shardmap as jshardmap
from gatekeeper_tpu.control import trace as jtrace
from gatekeeper_tpu.control import webhook as jwebhook
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.ir import driver as jdrvmod
from gatekeeper_tpu.ir import vecmat as jvecmat
from gatekeeper_tpu.ops import strtab as jstrtab
from gatekeeper_tpu.parallel import workload as jworkload
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu.target import batch as jbatch
from gatekeeper_tpu.utils import faults as jfaults
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client import RegoDriver as TRegoDriver
from gatekeeper_tpu_torch.control import audit as taudit
from gatekeeper_tpu_torch.control import kube as tkube
from gatekeeper_tpu_torch.control import metrics as tmetrics
from gatekeeper_tpu_torch.control import resilience as tres
from gatekeeper_tpu_torch.control import shardmap as tshardmap
from gatekeeper_tpu_torch.control import trace as ttrace
from gatekeeper_tpu_torch.control import webhook as twebhook
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir import driver as tdrvmod
from gatekeeper_tpu_torch.ir import vecmat as tvecmat
from gatekeeper_tpu_torch.ops import strtab as tstrtab
from gatekeeper_tpu_torch.parallel import workload as tworkload
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.target import batch as tbatch
from gatekeeper_tpu_torch.utils import faults as tfaults

JAX = types.SimpleNamespace(
    name="jax", driver=TpuDriver, drvmod=jdrvmod, Backend=JBackend,
    RegoDriver=JRegoDriver, Target=JTarget, audit=jaudit, kube=jkube,
    metrics=jmetrics, res=jres, trace=jtrace, webhook=jwebhook,
    strtab=jstrtab, workload=jworkload, pol=jpol, batch=jbatch,
    vecmat=jvecmat, shardmap=jshardmap, FAULTS=jfaults.FAULTS)
TORCH = types.SimpleNamespace(
    name="torch", driver=lambda: TorchDriver(device="cpu"), drvmod=tdrvmod,
    Backend=TBackend, RegoDriver=TRegoDriver, Target=TTarget, audit=taudit,
    kube=tkube, metrics=tmetrics, res=tres, trace=ttrace, webhook=twebhook,
    strtab=tstrtab, workload=tworkload, pol=tpol, batch=tbatch,
    vecmat=tvecmat, shardmap=tshardmap, FAULTS=tfaults.FAULTS)

TARGET = "admission.k8s.gatekeeper.sh"
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"
CONSTRAINT_GVK = (CONSTRAINT_GROUP, "v1beta1", "K8sRequiredLabels")
NS_GVK = ("", "v1", "Namespace")
POD_GVK = ("", "v1", "Pod")


def both(case, *args):
    """Run `case` through the port, then the JAX package, and return
    both transcripts as JSON values (tuples become lists)."""
    got = case(TORCH, *args)
    want = case(JAX, *args)
    norm = lambda v: json.loads(json.dumps(v, default=repr))  # noqa: E731
    return norm(got), norm(want)


def pinned(drv):
    """The cost model's device path at these tiny sizes, as the JAX
    package's tests pin it."""
    drv._use_device_for_batch = lambda n: True
    return drv


def result_keys(results) -> list:
    """tests/test_audit_incremental.py's `_key`: per result its
    constraint, message, resource kind, namespace and name, and action,
    sorted."""
    return sorted(
        ((r.constraint.get("metadata") or {}).get("name", ""), r.msg,
         (r.resource or {}).get("kind", ""),
         ((r.resource or {}).get("metadata") or {}).get("namespace") or "",
         ((r.resource or {}).get("metadata") or {}).get("name") or "",
         r.enforcement_action)
        for r in results)


def ordered_keys(results) -> list:
    """Per constraint, in sweep order: message, resource kind,
    namespace and name, and action (the audit's order across kinds is a
    driver's own, ROADMAP C)."""
    by_con: dict = {}
    for r in results:
        c = r.constraint or {}
        res = r.resource or {}
        meta = res.get("metadata") or {}
        by_con.setdefault(
            f"{c.get('kind')}/{(c.get('metadata') or {}).get('name')}",
            []).append([r.msg, res.get("kind"), meta.get("namespace"),
                        meta.get("name"), r.enforcement_action])
    return sorted(by_con.items())


def status_writes(kube) -> list:
    """The status writes the kube recorded, in order."""
    return [list(c) for c in kube.calls
            if c[0] == "update" and c[3] == "status"]


def statuses(kube, gvks) -> dict:
    """Each constraint's status without its auditTimestamp (a clock)."""
    out = {}
    for gvk in gvks:
        for o in kube.list(gvk):
            st = dict(o.get("status") or {})
            st.pop("auditTimestamp", None)
            out[f"{gvk[2]}/{o['metadata']['name']}"] = st
    return out


def audit_path(drv) -> str:
    """The driver's last audit path; the port names its device in a
    single sweep's path (`single(cpu)`), the JAX package does not."""
    path = drv.last_audit_path or ""
    return "single" if path.startswith("single") else path


def sweep_stats(mgr) -> dict:
    """The manager's last sweep stats without its clocks."""
    return {k: v for k, v in mgr.last_sweep_stats.items()
            if not k.endswith("_s")}


# ------------------------------------ tests/test_audit_incremental.py

CONSTRAINTS = [
    {  # every Namespace needs a regex-conforming owner label
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sRequiredLabels",
        "metadata": {"name": "ns-owner", "uid": "c-1"},
        "spec": {
            "match": {"kinds": [{"apiGroups": [""],
                                 "kinds": ["Namespace"]}]},
            "parameters": {"labels": [
                {"key": "owner",
                 "allowedRegex": "^[a-z]+[.]corp[.]example$"}]},
        },
    },
    {  # Pods in env=prod namespaces need a team label
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sRequiredLabels",
        "metadata": {"name": "prod-team", "uid": "c-2"},
        "spec": {
            "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
                      "namespaceSelector":
                          {"matchLabels": {"env": "prod"}}},
            "parameters": {"labels": [{"key": "team"}]},
        },
    },
]


def _ns(name, labels=None, uid=None):
    o = {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": name}}
    if labels is not None:
        o["metadata"]["labels"] = labels
    if uid is not None:
        o["metadata"]["uid"] = uid
    return o


def _pod(name, namespace, labels=None, uid=None):
    o = {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": name, "namespace": namespace}}
    if labels is not None:
        o["metadata"]["labels"] = labels
    if uid is not None:
        o["metadata"]["uid"] = uid
    return o


def _cluster(P, kube=None):
    kube = kube if kube is not None else P.kube.FakeKube()
    kube.register_kind(NS_GVK, namespaced=False)
    kube.register_kind(POD_GVK, namespaced=True)
    for i in range(4):
        kube.create(_ns(f"ns-{i}",
                        {"env": "prod" if i % 2 else "dev",
                         "owner": "alpha.corp.example"}, uid=f"ns-u{i}"))
    for i in range(40):
        labels = {}
        if i % 3 == 0:
            labels["team"] = "payments"
        kube.create(_pod(f"p-{i}", f"ns-{i % 4}", labels, uid=f"p-u{i}"))
    return kube


def _manager(P, kube, driver, full_resync_every):
    client = P.Backend(driver).new_client([P.Target()])
    client.add_template(P.workload.REQUIRED_LABELS_TEMPLATE)
    for c in CONSTRAINTS:
        client.add_constraint(c)
        kube.apply(dict(c))
    return client, P.audit.AuditManager(kube, client, incremental=True,
                                        full_resync_every=full_resync_every)


def _apply_churn(P, kube, rng, round_):
    """Randomized creates/updates/deletes, including vocabulary-growing
    label values and namespace env flips (namespaceSelector outcomes)."""
    KubeError = P.kube.KubeError
    ops = []
    for _ in range(8):
        op = rng.choice(["update", "update", "create", "delete",
                         "ns-flip", "owner-churn"])
        ops.append(op)
        if op == "update":
            i = rng.randrange(40)
            labels = {}
            if rng.random() < 0.5:
                labels["team"] = f"team-{round_}-{i}"  # new vocab
            try:
                cur = kube.get(POD_GVK, f"p-{i}", f"ns-{i % 4}")
            except KubeError:
                continue
            cur["metadata"]["labels"] = labels
            kube.update(cur)
        elif op == "create":
            name = f"extra-{round_}-{rng.randrange(1000)}"
            try:
                kube.create(_pod(name, f"ns-{rng.randrange(4)}",
                                 uid=f"u-{name}"))
            except KubeError:
                pass
        elif op == "delete":
            i = rng.randrange(40)
            try:
                kube.delete(POD_GVK, f"p-{i}", f"ns-{i % 4}")
            except KubeError:
                pass
        elif op == "ns-flip":
            i = rng.randrange(4)
            cur = kube.get(NS_GVK, f"ns-{i}")
            labels = cur["metadata"].setdefault("labels", {})
            labels["env"] = "dev" if labels.get("env") == "prod" \
                else "prod"
            kube.update(cur)
        else:  # owner-churn: regex-relevant value growth
            i = rng.randrange(4)
            cur = kube.get(NS_GVK, f"ns-{i}")
            labels = cur["metadata"].setdefault("labels", {})
            labels["owner"] = rng.choice(
                ["beta.corp.example", f"BAD-{round_}", "x.corp.example"])
            kube.update(cur)
    return ops


def case_differential_incremental_vs_full_under_churn(P, pin):
    """:164: every churn round, the incremental sweep (the device
    driver, patched caches, never resyncing) equals a from-scratch full
    re-encode sweep (the interpreter, resyncing every sweep)."""
    kube = _cluster(P)
    drv = P.driver()
    if pin:
        pinned(drv)
    _ci, inc = _manager(P, kube, drv, full_resync_every=0)
    _cf, full = _manager(P, kube, P.RegoDriver(), full_resync_every=1)
    got = result_keys(inc.audit_once())
    assert got == result_keys(full.audit_once())
    out = [got]
    rng = random.Random(42)
    for round_ in range(6):
        ops = _apply_churn(P, kube, rng, round_)
        got, want = result_keys(inc.audit_once()), \
            result_keys(full.audit_once())
        assert got == want, f"round {round_} diverged after {ops}"
        assert inc.last_sweep_stats["sweep"] == "incremental"
        out.append([ops, got, sweep_stats(inc), audit_path(drv)])
    assert want, "differential went vacuous (no violations at the end)"
    inc.stop()
    full.stop()
    return out + [status_writes(kube), statuses(kube, [CONSTRAINT_GVK])]


def case_steady_sweep_is_delta_and_writes_nothing(P):
    """:185: a sweep with zero changes writes no status and re-extracts
    nothing; one changed object writes only its constraint's status."""
    kube = _cluster(P)
    drv = P.driver()
    _client, mgr = _manager(P, kube, drv, full_resync_every=10 ** 9)
    mgr.audit_once()
    first = mgr.audit_once()  # fingerprints settle
    calls = {"extract": 0}
    orig = P.drvmod.extract_batch

    def counted(*a, **k):
        calls["extract"] += 1
        return orig(*a, **k)

    P.drvmod.extract_batch = counted
    try:
        n0 = len(kube.calls)
        out = mgr.audit_once()
        new_calls = kube.calls[n0:]
    finally:
        P.drvmod.extract_batch = orig
    assert result_keys(out) == result_keys(first)
    writes = [c for c in new_calls if c[0] == "update" and c[3] == "status"]
    assert writes == [], writes
    assert calls["extract"] == 0, "steady sweep re-extracted features"
    assert drv.last_audit_path.startswith("delta("), drv.last_audit_path
    assert mgr.last_sweep_stats["dirty"] == 0
    steady_path = audit_path(drv)
    cur = kube.get(NS_GVK, "ns-0")
    cur["metadata"]["labels"] = {"env": "dev"}  # owner label gone
    kube.update(cur)
    n0 = len(kube.calls)
    changed = mgr.audit_once()
    writes = [c for c in kube.calls[n0:]
              if c[0] == "update" and c[3] == "status"]
    assert [c[2] for c in writes] == [("", "ns-owner")]
    mgr.stop()
    return [result_keys(out), steady_path, result_keys(changed),
            audit_path(drv), status_writes(kube),
            statuses(kube, [CONSTRAINT_GVK])]


def case_full_resync_backstop_heals_divergence(P):
    """:228: the periodic from-scratch re-encode repairs a lost update
    and a lost delete, and leaves inventory data it does not own."""
    kube = _cluster(P)
    client, mgr = _manager(P, kube, P.driver(), full_resync_every=2)
    r0 = result_keys(mgr.audit_once())  # sweep 0: full resync
    client.add_data({"apiVersion": "v1", "kind": "Endpoints",
                     "metadata": {"name": "foreign", "namespace": "ns-0"}})
    cur = kube.get(NS_GVK, "ns-1")
    cur["metadata"]["labels"] = {"env": "prod"}  # owner label dropped
    kube.update(cur)
    kube.delete(POD_GVK, "p-1", "ns-1")
    with mgr.tracker._lock:
        mgr.tracker._dirty.clear()
    r1 = result_keys(mgr.audit_once())  # sweep 1: incremental, stale
    assert mgr.last_sweep_stats["sweep"] == "incremental"
    assert not any(name == "ns-1" for (_c, _m, _k, _n, name, _e) in r1)
    r2 = result_keys(mgr.audit_once())  # sweep 2: full resync heals
    assert mgr.last_sweep_stats["sweep"] == "full_resync"
    assert any(c == "ns-owner" and name == "ns-1"
               for (c, _m, _k, _n, name, _e) in r2)
    key = (POD_GVK, "ns-1", "p-1")
    assert key not in mgr.tracker._state
    foreign = client.driver.get_data(
        ("external", TARGET, "namespace", "ns-0", "v1", "Endpoints",
         "foreign"))
    assert foreign is not None
    mgr.stop()
    return [r0, r1, r2, sweep_stats(mgr), foreign, status_writes(kube),
            statuses(kube, [CONSTRAINT_GVK])]


def _watchless(P):
    class WatchlessKube(P.kube.FakeKube):
        """Streams always fail (every subscription dies with 410 Gone):
        the tracker falls back to a per-sweep re-list diff."""

        def watch(self, gvk, callback, send_initial=True, **_kw):
            raise P.kube.KubeError("watch: HTTP 410 Gone", 410)

    return WatchlessKube()


def case_watch_gap_falls_back_to_relist_diff(P):
    """:271."""
    kube = _watchless(P)
    kube.register_kind(NS_GVK, namespaced=False)
    kube.register_kind(POD_GVK, namespaced=True)
    kube.create(_ns("ns-0", {"env": "prod", "owner": "a.corp.example"},
                    uid="n0"))
    kube.create(_pod("p-0", "ns-0", uid="u0"))
    _client, mgr = _manager(P, kube, P.driver(), full_resync_every=10 ** 9)
    r0 = result_keys(mgr.audit_once())
    assert mgr.tracker._poll, "no GVK degraded to the re-list path"
    assert any(name == "p-0" for (_c, _m, _k, _ns_, name, _e) in r0)
    cur = kube.get(POD_GVK, "p-0", "ns-0")
    cur["metadata"]["labels"] = {"team": "x"}
    kube.update(cur)
    kube.create(_pod("p-1", "ns-0", uid="u1"))
    r1 = result_keys(mgr.audit_once())
    assert mgr.last_sweep_stats["dirty"] == 2
    assert not any(name == "p-0" for (_c, _m, _k, _ns_, name, _e) in r1)
    assert any(name == "p-1" for (_c, _m, _k, _ns_, name, _e) in r1)
    kube.delete(POD_GVK, "p-1", "ns-0")
    r2 = result_keys(mgr.audit_once())
    assert not any(name == "p-1" for (_c, _m, _k, _ns_, name, _e) in r2)
    poll = sorted(mgr.tracker._poll)
    mgr.stop()
    return [r0, r1, r2, poll, sweep_stats(mgr), status_writes(kube)]


def case_note_gap_triggers_one_shot_resync(P):
    """:297."""
    kube = _cluster(P)
    _client, mgr = _manager(P, kube, P.driver(), full_resync_every=10 ** 9)
    mgr.audit_once()
    cur = kube.get(NS_GVK, "ns-0")
    cur["metadata"]["labels"]["env"] = "prod"
    kube.update(cur)
    r1 = result_keys(mgr.audit_once())
    assert not any(c == "prod-team" and name == "p-0"
                   for (c, _m, _k, _n, name, _e) in r1)
    cur = kube.get(POD_GVK, "p-0", "ns-0")
    cur["metadata"]["labels"] = {}
    kube.update(cur)
    with mgr.tracker._lock:
        mgr.tracker._dirty.clear()  # the lost delivery
    r2 = result_keys(mgr.audit_once())
    assert not any(c == "prod-team" and name == "p-0"
                   for (c, _m, _k, _n, name, _e) in r2)
    mgr.tracker.note_gap(POD_GVK)
    r3 = result_keys(mgr.audit_once())
    assert any(c == "prod-team" and name == "p-0"
               for (c, _m, _k, _n, name, _e) in r3)
    assert mgr.last_sweep_stats["dirty"] == 1
    mgr.stop()
    return [r1, r2, r3, sweep_stats(mgr), status_writes(kube)]


def case_resync_supersedes_stale_pending_events(P):
    """:328."""
    kube = _cluster(P)
    _client, mgr = _manager(P, kube, P.driver(), full_resync_every=10 ** 9)
    mgr.audit_once()
    cur = kube.get(POD_GVK, "p-2", "ns-2")
    cur["metadata"]["labels"] = {"x": "y"}
    kube.update(cur)
    kube.delete(POD_GVK, "p-2", "ns-2")
    key = (POD_GVK, "ns-2", "p-2")
    with mgr.tracker._lock:
        mgr.tracker._dirty[key] = ("MODIFIED", cur)
    mgr.tracker.note_gap(POD_GVK)
    r = result_keys(mgr.audit_once())
    assert key not in mgr.tracker._state
    assert not any(name == "p-2" for (_c, _m, _k, _n, name, _e) in r)
    mgr.stop()
    return [r, sweep_stats(mgr), status_writes(kube)]


def case_delete_then_recreate_same_name_new_uid(P):
    """:351."""
    kube = _cluster(P)
    _client, mgr = _manager(P, kube, P.driver(), full_resync_every=10 ** 9)
    mgr.audit_once()
    key = (POD_GVK, "ns-0", "p-0")
    assert mgr.tracker._state[key][0] == "p-u0"
    kube.delete(POD_GVK, "p-0", "ns-0")
    kube.create(_pod("p-0", "ns-0", uid="p-u0-reborn"))
    r1 = result_keys(mgr.audit_once())
    assert mgr.tracker._state[key][0] == "p-u0-reborn"
    cur = kube.get(NS_GVK, "ns-0")
    cur["metadata"]["labels"]["env"] = "prod"
    kube.update(cur)
    r2 = result_keys(mgr.audit_once())
    assert any(c == "prod-team" and name == "p-0"
               for (c, _m, _k, _ns_, name, _e) in r2)
    mgr.stop()
    return [r1, r2, mgr.tracker._state[key], status_writes(kube)]


def case_strtab_snapshot_append_only(P):
    """:376: interning never reassigns ids across growth."""
    t = P.strtab.StringTable()
    ids = {s: t.intern(s) for s in ("a", "b", "c")}
    snap = t.snapshot()
    t.intern_many(["d", "e", "a"])
    assert t.grown_since(snap) == 2
    for s, i in ids.items():
        assert t.intern(s) == i and t.string(i) == s
    return [ids, t.grown_since(snap), [t.string(i) for i in range(len(t))]]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")
         and k != "case_differential_incremental_vs_full_under_churn"]


@pytest.mark.parametrize("pin", [False, True], ids=["as-decided", "pinned"])
def test_differential_incremental_vs_full_under_churn(pin):
    got, want = both(case_differential_incremental_vs_full_under_churn, pin)
    assert got == want


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_incremental_case_equal(case):
    got, want = both(case)
    assert got == want


# ------------------------- tests/test_observability.py: the audit trace

def _owner_client(P, driver):
    """tests/test_observability.py's `_policy_client` on `driver`."""
    client = P.Backend(driver).new_client([P.Target()])
    client.add_template({
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8sneedowner"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sNeedOwner"}}},
            "targets": [{"target": TARGET, "rego": """
package k8sneedowner
violation[{"msg": "no owner label"}] {
  not input.review.object.metadata.labels.owner
}
"""}]},
    })
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sNeedOwner", "metadata": {"name": "need-owner"},
        "spec": {}})
    return client


def case_audit_sweep_trace_phases(P, drv_kind):
    """:511: every sweep traces; a full-resync and an incremental sweep
    record list_delta_apply, the evaluation's phases and status_writes.
    On the device driver the evaluation is split into the driver's timed
    phases plus `evaluate_other`; on the interpreter it is one
    `evaluate` span. The stage names per sweep are the transcript."""
    P.trace.TRACER.recorder.clear()
    kube = P.kube.FakeKube()
    kube.register_kind(NS_GVK, namespaced=False)
    kube.register_kind(POD_GVK, namespaced=True)
    kube.create({"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": "d"}})
    for i in range(4):
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"p{i}", "namespace": "d"}})
    if drv_kind == "rego":
        drv = P.RegoDriver()
    else:
        drv = P.driver()
        if drv_kind == "pinned":
            pinned(drv)
    client = _owner_client(P, drv)
    mgr = P.audit.AuditManager(kube, client, incremental=True,
                               gc_stale_statuses=False)
    mgr.audit_once()
    mgr.audit_once()
    mgr.stop()
    dump = P.trace.TRACER.recorder.dump()["planes"]
    assert "audit" in dump, "audit sweeps must always trace"
    sweeps = [[t["status"], sorted({s["stage"] for s in t["spans"]}),
               t["attrs"].get("violations")]
              for t in dump["audit"]["recent"]]
    stages_seen = {s for _st, stages, _v in sweeps for s in stages}
    evaluate = "evaluate" if drv_kind == "rego" else "evaluate_other"
    for want in ("list_delta_apply", evaluate, "status_writes"):
        assert want in stages_seen
    assert {"full_resync", "incremental"} <= {st for st, _s, _v in sweeps}
    text = P.metrics.REGISTRY.render()
    assert "gatekeeper_tpu_stage_duration_seconds_count" \
        '{engine="",plane="audit",stage="list_delta_apply"}' in text
    return sweeps


@pytest.mark.parametrize("drv_kind", ["rego", "as-decided", "pinned"])
def test_audit_sweep_trace_phase_names_equal(drv_kind):
    got, want = both(case_audit_sweep_trace_phases, drv_kind)
    assert got == want


# ------------------- status writes: off the kernel locks, no lock held

BACKOFF_CHILD = r"""
import importlib, json, sys, threading
pkg = sys.argv[1]
audit = importlib.import_module(pkg + ".control.audit")
kube_mod = importlib.import_module(pkg + ".control.kube")
client_mod = importlib.import_module(pkg + ".client")
target = importlib.import_module(pkg + ".target")
workload = importlib.import_module(pkg + ".parallel.workload")
if pkg == "gatekeeper_tpu_torch":
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.kernels import build
    drv = TorchDriver(device="cpu")
    entered = []
    real_held = build.held
    def held(lock):
        entered.append(threading.current_thread().name)
        return real_held(lock)
    build.held = held
else:
    from gatekeeper_tpu.ir import TpuDriver
    drv = TpuDriver()
    entered = []
drv._use_device_for_batch = lambda n: True

class FlakyKube(kube_mod.FakeKube):
    # every status write fails twice with a 500 before it lands: the
    # unguarded write protocol retries it after backoff sleeps
    streak = {}
    fails = {}
    writers = []
    def update(self, obj, subresource=""):
        if subresource == "status":
            name = obj["metadata"]["name"]
            self.writers.append(threading.current_thread().name)
            if self.streak.get(name, 0) < 2:
                self.streak[name] = self.streak.get(name, 0) + 1
                self.fails[name] = self.fails.get(name, 0) + 1
                raise kube_mod.KubeError("injected 500", 500)
            self.streak[name] = 0
        return super().update(obj, subresource)

kube = FlakyKube()
kube.register_kind(("", "v1", "Namespace"), namespaced=False)
for i in range(6):
    kube.create({"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": f"ns{i}", "uid": f"u{i}"}})
client = client_mod.Backend(drv).new_client([target.K8sValidationTarget()])
other = json.loads(json.dumps(workload.REQUIRED_LABELS_TEMPLATE))
other["spec"]["crd"]["spec"]["names"]["kind"] = "K8sOtherLabels"
other["metadata"]["name"] = "k8sotherlabels"
for tpl in (workload.REQUIRED_LABELS_TEMPLATE, other):
    client.add_template(tpl)
    kind = tpl["spec"]["crd"]["spec"]["names"]["kind"]
    con = {"apiVersion": "constraints.gatekeeper.sh/v1beta1", "kind": kind,
           "metadata": {"name": kind.lower()},
           "spec": {"parameters": {"labels": [{"key": "owner"}]}}}
    client.add_constraint(con)
    kube.apply(con)
mgr = audit.AuditManager(kube, client, incremental=True,
                         gc_stale_statuses=False)
sweeps = [len(mgr.audit_once())]
kube.create({"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": "late", "uid": "u-late"}})
sweeps.append(len(mgr.audit_once()))
# the post-sweep pass alone (no streamed writer): it publishes on the
# sweep's thread, after the sweep lock dropped
mgr.stream_status_writes = False
kube.create({"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": "later", "uid": "u-later"}})
sweeps.append(len(mgr.audit_once()))
mgr.stop()
statuses = sorted(
    [o["kind"], o["status"]["totalViolations"]]
    for k in ("K8sRequiredLabels", "K8sOtherLabels")
    for o in kube.list(("constraints.gatekeeper.sh", "v1beta1", k)))
print(json.dumps({"sweeps": sweeps, "statuses": statuses,
                  "writers": sorted(set(kube.writers)),
                  "retried": sorted(kube.fails.items()),
                  "held_by": sorted(set(entered))}))
"""


@pytest.mark.parametrize("pkg", ["gatekeeper_tpu_torch", "gatekeeper_tpu"])
def test_status_write_backoff_sleeps_with_no_lock_held(pkg, tmp_path):
    """Under GATEKEEPER_TPU_LOCKTRACE=1, an incremental sweep whose
    status writes fail twice each (a 500 the unguarded protocol retries
    after a backoff sleep): the streamed per-kind writer thread and the
    post-sweep pass publish every status, and no backoff sleep runs
    with a traced lock held (no held-across-blocking finding, so none
    under the manager's `_sweep_lock`). In the port, no status writer
    takes a kernel lock (`kernels/build.py` `held`). Both packages give
    the same sweeps, statuses and writer threads."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    out_file = tmp_path / "locktrace.jsonl"
    env = dict(os.environ, PYTHONPATH=str(root), JAX_PLATFORMS="cpu",
               GATEKEEPER_TPU_LOCKTRACE="1",
               GATEKEEPER_TPU_LOCKTRACE_OUT=str(out_file))
    proc = subprocess.run([sys.executable, "-c", BACKOFF_CHILD, pkg],
                          cwd=str(root), env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["sweeps"] == [12, 14, 16]
    assert got["statuses"] == [["K8sOtherLabels", 8],
                               ["K8sRequiredLabels", 8]]
    assert got["writers"] == ["MainThread", "audit-status-stream"]
    assert got["retried"] == [["k8sotherlabels", 6],
                              ["k8srequiredlabels", 6]]
    assert not [t for t in got["held_by"] if t != "MainThread"]
    findings = [json.loads(line) for line in
                out_file.read_text().splitlines()] \
        if out_file.exists() else []
    assert [f for f in findings
            if f["kind"] == "held_across_blocking"] == []
