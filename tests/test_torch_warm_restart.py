"""The port's warm restart and HA against the JAX package's.

The cases of tests/test_warm_restart.py past its statestore cases (those
are tests/test_torch_statestore.py's), each run through both packages:
the warm restart through the real `control.main.Runtime` (TorchDriver on
the CPU, `--device cpu`, in the port; TpuDriver in the JAX package), the
downtime delta, the corrupt-snapshot cold fallback, the encoded rows'
adoption and refusal, watch resume from persisted resourceVersions
(FakeKube's tombstone replay and the RestKubeClient streaming path
against an HTTP apiserver stub, the 410 heal), Lease-based leader
election, the not-leader write fence, byPod GC, and the kill -9
round-trip, whose child imports only the port; and the race a warm
boot showed between the constraint controller's and the audit's status
writes on a Conflict: the JAX package's erase each other's keys, the
port's keep them (ROADMAP C2). Every case returns a
transcript of what it observed (results, sweep stats, statuses, events),
and the two packages' transcripts must be equal; the reference's own
expectations are asserted inside each case as well.

Every test runs under a HARD SIGALRM timeout, as the reference's do.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.client import RegoDriver as JRegoDriver
from gatekeeper_tpu.control import audit as jaudit
from gatekeeper_tpu.control import kube as jkube
from gatekeeper_tpu.control import main as jmain
from gatekeeper_tpu.control import metrics as jmetrics
from gatekeeper_tpu.control import resilience as jres
from gatekeeper_tpu.control import statestore as jstatestore
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu.utils import faults as jfaults
from gatekeeper_tpu.utils import values as jvalues
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client import RegoDriver as TRegoDriver
from gatekeeper_tpu_torch.control import audit as taudit
from gatekeeper_tpu_torch.control import kube as tkube
from gatekeeper_tpu_torch.control import main as tmain
from gatekeeper_tpu_torch.control import metrics as tmetrics
from gatekeeper_tpu_torch.control import resilience as tres
from gatekeeper_tpu_torch.control import statestore as tstatestore
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils import faults as tfaults
from gatekeeper_tpu_torch.utils import values as tvalues

# each package's entry point, state store and the modules they ride on;
# `device` is the port's --device flag (the JAX package has none)
JAX = types.SimpleNamespace(
    name="jax", main=jmain, statestore=jstatestore, kube=jkube,
    audit=jaudit, res=jres, metrics=jmetrics, FAULTS=jfaults.FAULTS,
    Backend=JBackend, RegoDriver=JRegoDriver, Target=JTarget,
    driver=TpuDriver, values=jvalues, device=[])
TORCH = types.SimpleNamespace(
    name="torch", main=tmain, statestore=tstatestore, kube=tkube,
    audit=taudit, res=tres, metrics=tmetrics, FAULTS=tfaults.FAULTS,
    Backend=TBackend, RegoDriver=TRegoDriver, Target=TTarget,
    driver=lambda: TorchDriver(device="cpu"), values=tvalues,
    device=["--device", "cpu"])

TARGET = "admission.k8s.gatekeeper.sh"
LEASE_GVK = ("coordination.k8s.io", "v1", "Lease")
POD_GVK = ("", "v1", "Pod")
NEED_OWNER_GVK = ("constraints.gatekeeper.sh", "v1beta1", "K8sNeedOwner")

PER_TEST_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _hard_timeout_and_clean_faults():
    def boom(signum, frame):  # pragma: no cover - only on a real hang
        raise TimeoutError(
            f"test exceeded the {PER_TEST_TIMEOUT_S}s hard timeout")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(PER_TEST_TIMEOUT_S)
    for ns in (JAX, TORCH):
        ns.FAULTS.reset()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        for ns in (JAX, TORCH):
            ns.FAULTS.reset()


def both(case, *args):
    """Run `case` through the port, then the JAX package; both
    transcripts as JSON values (tuples become lists)."""
    got = case(TORCH, *args)
    want = case(JAX, *args)
    norm = lambda v: json.loads(json.dumps(v, default=repr))  # noqa: E731
    return norm(got), norm(want)


NEED_OWNER_TEMPLATE = {
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
}

NEED_OWNER_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sNeedOwner", "metadata": {"name": "need-owner"},
    "spec": {},
}


def _pod(i, owner=False, ns="d"):
    labels = {"owner": "me"} if owner else {}
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": f"p{i}", "namespace": ns,
                         "labels": labels}}


def _seed_cluster(kube, n=20, violating=5):
    kube.create(NEED_OWNER_TEMPLATE)
    for i in range(n):
        kube.create(_pod(i, owner=i >= violating))


def _mk_runtime(ns, kube, state_dir):
    args = ns.main.build_parser().parse_args([
        "--fake-kube", "--operation", "audit",
        "--audit-incremental", "true",
        "--state-dir", state_dir, "--snapshot-interval", "0",
        "--health-addr", "0", "--metrics-backend", "none",
        "--disable-cert-rotation", "--audit-interval", "9999"] + ns.device)
    return ns.main.Runtime(args, kube=kube)


def _metric_value(ns, name, **labels):
    m = ns.metrics.REGISTRY._metrics.get(name)
    if m is None:
        return 0.0
    return m.values.get(ns.metrics._lv(labels), 0.0)


def _status(kube, gvk=NEED_OWNER_GVK, name="need-owner") -> dict:
    st = dict(kube.get(gvk, name).get("status") or {})
    st.pop("auditTimestamp", None)
    return st


def _names(results) -> list:
    return sorted((r.resource.get("metadata") or {}).get("name")
                  for r in results)


def _sweep(mgr) -> dict:
    """The manager's last sweep stats without its clocks."""
    return {k: v for k, v in mgr.last_sweep_stats.items()
            if not k.endswith("_s")}


# ----------------------------------------------------------- warm restart


def _warm_restart_end_to_end(ns, tmp_path):
    tmp = tmp_path / ns.name
    kube = ns.kube.FakeKube()
    state_dir = str(tmp / "state")
    rt = _mk_runtime(ns, kube, state_dir)
    _seed_cluster(kube, n=20, violating=5)
    rt.start()
    rt.manager.drain()
    kube.create(NEED_OWNER_CONSTRAINT)
    rt.manager.drain()
    results = rt.audit.audit_once()
    assert len(results) == 5
    cold = _status(kube)
    rt.stop()  # SIGTERM drain: snapshots written here

    sections = sorted(os.listdir(state_dir))
    assert "library.snapshot.json" in sections
    assert "inventory.snapshot.blob" in sections

    # "new process": fresh Runtime over the SAME cluster + state dir
    rt2 = _mk_runtime(ns, kube, state_dir)
    try:
        # library restored from the snapshot, before any watch delivery
        assert rt2.opa.template_kinds() == ["K8sNeedOwner"]
        assert rt2.audit.tracker is not None
        # readyz gate: restored state not yet re-validated
        assert rt2.audit.restore_ready() is False
        calls_before = len(kube.calls)
        res2 = rt2.audit.audit_once()
        assert rt2.audit.restore_ready() is True
        # first warm sweep is INCREMENTAL and re-encodes NOTHING
        assert rt2.audit.last_sweep_stats["sweep"] == "incremental"
        assert rt2.audit.last_sweep_stats["dirty"] == 0
        assert len(res2) == 5
        inventory_lists = [c for c in kube.calls[calls_before:]
                           if c[0] == "list" and c[1] == POD_GVK
                           and c[2] is None]
        assert inventory_lists == []
        return {"sections": sections, "cold": [_names(results), cold],
                "warm": [_names(res2), _sweep(rt2.audit), _status(kube)]}
    finally:
        if rt2.audit.tracker is not None:
            rt2.audit.tracker.stop()


def test_warm_restart_end_to_end(tmp_path):
    got, want = both(_warm_restart_end_to_end, tmp_path)
    assert got == want


def _warm_restart_applies_downtime_delta(ns, tmp_path):
    kube = ns.kube.FakeKube()
    state_dir = str(tmp_path / ns.name / "state")
    rt = _mk_runtime(ns, kube, state_dir)
    _seed_cluster(kube, n=12, violating=3)
    rt.start()
    rt.manager.drain()
    kube.create(NEED_OWNER_CONSTRAINT)
    rt.manager.drain()
    rt.audit.audit_once()
    rt.stop()

    # mutations while "down": one new violator, one delete, one fix
    kube.create(_pod(100, owner=False))
    kube.delete(POD_GVK, "p0", "d")          # was violating
    fixed = kube.get(POD_GVK, "p1", "d")
    fixed["metadata"]["labels"] = {"owner": "me"}
    kube.update(fixed)                        # was violating, now fixed

    rt2 = _mk_runtime(ns, kube, state_dir)
    try:
        res = rt2.audit.audit_once()
        stats = rt2.audit.last_sweep_stats
        assert stats["sweep"] == "incremental"
        # exactly the downtime delta re-encoded: add + delete + update
        assert stats["dirty"] == 3
        assert _names(res) == ["p100", "p2"]
        return [_names(res), _sweep(rt2.audit), _status(kube)]
    finally:
        if rt2.audit.tracker is not None:
            rt2.audit.tracker.stop()


def test_warm_restart_applies_downtime_delta(tmp_path):
    got, want = both(_warm_restart_applies_downtime_delta, tmp_path)
    assert got == want


def _corrupt_snapshot_cold_fallback(ns, tmp_path):
    kube = ns.kube.FakeKube()
    state_dir = str(tmp_path / ns.name / "state")
    rt = _mk_runtime(ns, kube, state_dir)
    _seed_cluster(kube, n=10, violating=2)
    rt.start()
    rt.manager.drain()
    kube.create(NEED_OWNER_CONSTRAINT)
    rt.manager.drain()
    rt.audit.audit_once()
    rt.stop()

    # corrupt BOTH the inventory blob and the library body
    for name in ("inventory.snapshot.blob", "library.snapshot.json"):
        path = os.path.join(state_dir, name)
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[: max(1, len(data) // 2)])

    before = _metric_value(ns, "gatekeeper_tpu_snapshot_restore_total",
                           outcome="fallback")
    rt2 = _mk_runtime(ns, kube, state_dir)  # must not raise: cold path
    try:
        fallbacks = _metric_value(
            ns, "gatekeeper_tpu_snapshot_restore_total",
            outcome="fallback") - before
        assert fallbacks >= 2
        # cold path: no tracker restored, readiness trivially open
        assert rt2.audit.tracker is None
        assert rt2.audit.restore_ready() is True
        # the cold first sweep still converges (full resync)
        rt2.manager.start()
        rt2.manager.drain()
        res = rt2.audit.audit_once()
        assert rt2.audit.last_sweep_stats["sweep"] == "full_resync"
        assert len(res) == 2
        return [fallbacks, _names(res), _sweep(rt2.audit), _status(kube)]
    finally:
        rt2.manager.stop()
        if rt2.audit.tracker is not None:
            rt2.audit.tracker.stop()


def test_corrupt_snapshot_cold_fallback_no_crash(tmp_path):
    got, want = both(_corrupt_snapshot_cold_fallback, tmp_path)
    assert got == want


def _rows_client(ns):
    drv = ns.driver()
    drv.async_warm = False
    drv._use_device_for_batch = lambda n: True  # force device path
    client = ns.Backend(drv).new_client([ns.Target()])
    return drv, client


def _encoded_rows_adoption(ns, tmp_path):
    # device-path feature tensors snapshot -> restore -> adoption on
    # the first warm audit (candidate set unchanged)
    drv, client = _rows_client(ns)
    client.add_template(NEED_OWNER_TEMPLATE)
    client.add_constraint(NEED_OWNER_CONSTRAINT)
    for i in range(32):
        client.add_data(_pod(i, owner=i % 2 == 0))
    want = len(client.audit().results())
    assert want == 16
    rows = drv.encoded_rows_snapshot()
    assert rows and "K8sNeedOwner" in rows
    store = ns.statestore.StateStore(str(tmp_path / ns.name))
    assert store.save_blob("rows", rows)
    assert store.save("vocab", drv.vocab_snapshot())

    drv2, client2 = _rows_client(ns)
    drv2.vocab_restore(store.load("vocab"))
    client2.add_template(NEED_OWNER_TEMPLATE)
    client2.add_constraint(NEED_OWNER_CONSTRAINT)
    drv2.inventory_restore(drv.inventory_snapshot())
    drv2.encoded_rows_restore(store.load_blob("rows"))
    got = len(client2.audit().results())
    assert got == want
    assert drv2.restored_rows_adopted >= 1
    return [want, got, drv2.restored_rows_adopted, sorted(rows)]


def test_encoded_rows_snapshot_and_adoption(tmp_path):
    got, want = both(_encoded_rows_adoption, tmp_path)
    assert got == want


def _encoded_rows_refused(ns):
    # any inventory write between restore and the first audit makes the
    # stashed rows suspect: adoption must refuse and re-extract
    drv, client = _rows_client(ns)
    client.add_template(NEED_OWNER_TEMPLATE)
    client.add_constraint(NEED_OWNER_CONSTRAINT)
    for i in range(16):
        client.add_data(_pod(i, owner=i % 2 == 0))
    client.audit()
    rows = drv.encoded_rows_snapshot()
    tree = drv.inventory_snapshot()
    vocab = drv.vocab_snapshot()

    drv2, client2 = _rows_client(ns)
    drv2.vocab_restore(vocab)
    client2.add_template(NEED_OWNER_TEMPLATE)
    client2.add_constraint(NEED_OWNER_CONSTRAINT)
    drv2.inventory_restore(tree)
    drv2.encoded_rows_restore(rows)
    client2.add_data(_pod(99, owner=False))  # delta AFTER restore
    res = client2.audit().results()
    assert len(res) == 9  # 8 original violators + p99
    assert drv2.restored_rows_adopted == 0
    return [_names(res), drv2.restored_rows_adopted]


def test_encoded_rows_refused_after_inventory_delta():
    got, want = both(_encoded_rows_refused)
    assert got == want


# ----------------------------------------------------------- watch resume


def _fakekube_resume_no_added_storm(ns):
    kube = ns.kube.FakeKube()
    kube.register_kind(POD_GVK)
    for i in range(10):
        kube.create(_pod(i))
    rv = kube._rv
    # churn after the checkpoint: 2 modified, 1 deleted, 1 added
    p = kube.get(POD_GVK, "p1", "d")
    p["metadata"]["labels"] = {"owner": "x"}
    kube.update(p)
    p = kube.get(POD_GVK, "p2", "d")
    p["metadata"]["labels"] = {"owner": "y"}
    kube.update(p)
    kube.delete(POD_GVK, "p3", "d")
    kube.create(_pod(42))

    events = []
    gaps = []
    cancel = kube.watch(POD_GVK, events.append, send_initial=False,
                        resource_version=str(rv),
                        on_gap=lambda: gaps.append(1))
    cancel()
    assert gaps == []
    by_type = {}
    for e in events:
        by_type.setdefault(e.type, []).append(
            e.object["metadata"]["name"])
    assert "ADDED" not in by_type  # no duplicate ADDED storm
    assert sorted(by_type.get("MODIFIED", [])) == ["p1", "p2", "p42"]
    assert by_type.get("DELETED") == ["p3"]
    return [[e.type, e.object["metadata"]["name"],
             e.object["metadata"].get("resourceVersion")] for e in events]


def test_fakekube_resume_no_added_storm():
    got, want = both(_fakekube_resume_no_added_storm)
    assert got == want


def _fakekube_resume_too_old(ns):
    kube = ns.kube.FakeKube()
    kube.register_kind(POD_GVK)
    for i in range(5):
        kube.create(_pod(i))
    kube.compact()  # history gone: old RVs must take the 410 path
    events = []
    gaps = []
    cancel = kube.watch(POD_GVK, events.append, send_initial=False,
                        resource_version="1",
                        on_gap=lambda: gaps.append(1))
    cancel()
    assert len(gaps) == 1  # subscriber told to reconcile deletes
    assert sorted(e.type for e in events) == ["ADDED"] * 5
    return [len(gaps), sorted((e.type, e.object["metadata"]["name"])
                              for e in events)]


def test_fakekube_resume_too_old_heals_via_relist():
    got, want = both(_fakekube_resume_too_old)
    assert got == want


def _tracker_restart_resume(ns, compact):
    """Tracker snapshot -> cluster churns (incl. deletes) -> restore:
    the resumed watches carry the delta; with compacted history the
    gap resync heals the same state."""
    kube = ns.kube.FakeKube()
    kube.register_kind(POD_GVK)
    kube.register_kind(("", "v1", "Namespace"), namespaced=False)
    for i in range(10):
        kube.create(_pod(i, owner=True))
    opa = ns.Backend(ns.RegoDriver()).new_client([ns.Target()])
    tr = ns.audit.InventoryTracker(kube, opa)
    tr.full_resync(ns.audit._auditable_gvks(kube))
    snap = tr.snapshot()
    tr.stop()

    kube.delete(POD_GVK, "p0", "d")
    kube.create(_pod(77))
    if compact:
        kube.compact()

    opa2 = ns.Backend(ns.RegoDriver()).new_client([ns.Target()])
    tr2 = ns.audit.InventoryTracker(kube, opa2)
    tr2.restore(snap)
    stats = tr2.apply_pending()
    try:
        assert tr2.validated.is_set()
        assert stats["total"] == 10  # 10 - 1 deleted + 1 added
        keys = {k[2] for k in tr2._state if k[0] == POD_GVK}
        assert "p0" not in keys and "p77" in keys
        return [snap, {k: v for k, v in stats.items()
                       if not k.endswith("_s")}, sorted(keys)]
    finally:
        tr2.stop()


@pytest.mark.parametrize("compact", [False, True],
                         ids=["resume", "compacted"])
def test_tracker_restart_resume_and_410_heal(compact):
    got, want = both(_tracker_restart_resume, compact)
    assert got == want


class _StubApi(BaseHTTPRequestHandler):
    """Minimal apiserver: discovery + pod list + one-shot watch."""

    def log_message(self, *a):
        pass

    def do_GET(self):
        srv = self.server
        srv.requests.append(self.path)
        if self.path.startswith("/api/v1/pods") and "watch=1" in self.path:
            srv.watch_count += 1
            if srv.gone_first and srv.watch_count == 1:
                frame = {"type": "ERROR",
                         "object": {"code": 410, "message": "too old"}}
            else:
                frame = {"type": "MODIFIED",
                         "object": {"metadata": {"name": "w1",
                                                 "resourceVersion": "50"}}}
            body = (json.dumps(frame) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.startswith("/api/v1/pods"):
            body = json.dumps({
                "kind": "PodList",
                "metadata": {"resourceVersion": "42"},
                "items": [{"metadata": {"name": "l1",
                                        "resourceVersion": "40"}}],
            }).encode()
        elif self.path == "/api/v1":
            body = json.dumps({"resources": [
                {"name": "pods", "kind": "Pod", "namespaced": True,
                 "verbs": ["list", "watch"]}]}).encode()
        else:
            body = b"{}"
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _stub_server(gone_first=False):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _StubApi)
    srv.daemon_threads = True
    srv.requests = []
    srv.watch_count = 0
    srv.gone_first = gone_first
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _rest_watch_resumes(ns):
    srv = _stub_server()
    client = ns.kube.RestKubeClient(
        base_url=f"http://127.0.0.1:{srv.server_address[1]}", token="t")
    events = []
    got = threading.Event()

    def cb(e):
        events.append(e)
        got.set()

    cancel = client.watch(POD_GVK, cb, send_initial=False,
                          resource_version="37")
    try:
        assert got.wait(10)
    finally:
        cancel()
        srv.shutdown()
        srv.server_close()
    watch_reqs = [r for r in srv.requests if "watch=1" in r]
    assert watch_reqs and "resourceVersion=37" in watch_reqs[0]
    # resume mode: NO initial paged list before the stream opened
    first_watch = srv.requests.index(watch_reqs[0])
    assert not any("limit=" in r for r in srv.requests[:first_watch])
    assert events[0].type == "MODIFIED"
    assert events[0].object["metadata"]["name"] == "w1"
    return [watch_reqs[0], events[0].type, events[0].object]


def test_rest_watch_resumes_from_persisted_rv():
    got, want = both(_rest_watch_resumes)
    assert got == want


def _rest_watch_410_heals(ns):
    srv = _stub_server(gone_first=True)
    client = ns.kube.RestKubeClient(
        base_url=f"http://127.0.0.1:{srv.server_address[1]}", token="t")
    events = []
    gaps = []
    healed = threading.Event()

    def cb(e):
        events.append(e)
        if e.type == "ADDED":
            healed.set()

    cancel = client.watch(POD_GVK, cb, send_initial=False,
                          resource_version="5",
                          on_gap=lambda: gaps.append(1))
    try:
        assert healed.wait(10)
    finally:
        cancel()
        srv.shutdown()
        srv.server_close()
    assert len(gaps) == 1  # caller told to reconcile gap deletes
    # the 410 triggered a relist (paged list request seen)...
    assert any("limit=" in r for r in srv.requests)
    # ...whose diff re-emitted the live object as ADDED
    added = [e for e in events if e.type == "ADDED"]
    assert added and added[0].object["metadata"]["name"] == "l1"
    return [len(gaps), added[0].object]


def test_rest_watch_410_heals_with_gap_signal():
    got, want = both(_rest_watch_410_heals)
    assert got == want


# -------------------------------------------------------- leader election


def _lease_kube(ns):
    kube = ns.kube.FakeKube()
    kube.register_kind(LEASE_GVK)
    return kube


def _single_leader_and_graceful_failover(ns):
    kube = _lease_kube(ns)
    e1 = ns.kube.LeaseElector(kube, identity="pod-a", lease_duration=0.6,
                              namespace="gk")
    e2 = ns.kube.LeaseElector(kube, identity="pod-b", lease_duration=0.6,
                              namespace="gk")
    e1.start()
    assert e1.wait_leader(5)
    e2.start()
    time.sleep(0.5)
    assert not e2.is_leader  # exactly one leader while both live
    t0 = time.time()
    e1.stop()  # graceful: releases the lease
    assert e2.wait_leader(5)
    # graceful failover is fast — far under a full lease duration x2
    assert time.time() - t0 < 3.0
    e2.stop()
    lease = kube.get(LEASE_GVK, e2.lease_name, "gk")
    assert lease["spec"]["holderIdentity"] == ""  # released on shutdown
    return [e2.lease_name, lease["spec"]["holderIdentity"]]


def test_single_leader_and_graceful_failover():
    got, want = both(_single_leader_and_graceful_failover)
    assert got == want


def _crash_failover(ns):
    kube = _lease_kube(ns)
    e1 = ns.kube.LeaseElector(kube, identity="pod-a", lease_duration=0.5,
                              namespace="gk")
    e2 = ns.kube.LeaseElector(kube, identity="pod-b", lease_duration=0.5,
                              namespace="gk")
    e1.start()
    try:
        assert e1.wait_leader(5)
        e2.start()
        time.sleep(0.2)
        e1.stop(release=False)  # crash: lease NOT released
        t0 = time.time()
        assert e2.wait_leader(5)
        # takeover needed the lease to lapse, but within ~2 durations
        assert time.time() - t0 < 2.5
        return kube.get(LEASE_GVK, e2.lease_name, "gk")["spec"][
            "holderIdentity"]
    finally:
        # leaked elector loops would consume other tests' armed faults
        e1.stop(release=False)
        e2.stop()


def test_crash_failover_within_lease_duration():
    got, want = both(_crash_failover)
    assert got == want == "pod-b"


def _lease_fault(ns, mode):
    kube = _lease_kube(ns)
    e1 = ns.kube.LeaseElector(kube, identity="pod-a", lease_duration=0.5,
                              namespace="gk")
    e1.start()
    try:
        assert e1.wait_leader(5)
        before = e1.transitions
        ns.FAULTS.inject("kube.lease", mode=mode, count=1,
                         match={"identity": "pod-a"})
        # steal: deposed by the thief, then (the thief never renews)
        # re-acquired after its lease lapses; expire: lost on the lapse,
        # re-acquired on a later tick. Two transitions either way, polled
        # via the counter because the not-leader window can be shorter
        # than a poll interval
        t0 = time.time()
        while e1.transitions < before + 2 and time.time() - t0 < 10:
            time.sleep(0.05)
        assert e1.transitions >= before + 2
        assert e1.wait_leader(5)
        assert ns.FAULTS.fired("kube.lease") == 1
        return [ns.FAULTS.fired("kube.lease"), e1.is_leader]
    finally:
        e1.stop()


def test_lease_steal_fault_deposes_then_recovers():
    got, want = both(_lease_fault, "steal")
    assert got == want


def test_lease_expire_fault_drops_leadership():
    got, want = both(_lease_fault, "expire")
    assert got == want


def _not_leader_write_fence(ns):
    kube = ns.kube.FakeKube()
    kube.register_kind(POD_GVK)
    leading = {"v": False}
    guard = ns.res.GuardedKube(kube, write_gate=lambda: leading["v"])
    with pytest.raises(ns.res.NotLeader):
        guard.create(_pod(1))
    assert kube.list(POD_GVK) == []  # no API call went through
    # reads and watches pass the fence untouched
    assert guard.list(POD_GVK) == []
    leading["v"] = True
    guard.create(_pod(1))
    assert len(kube.list(POD_GVK)) == 1
    # guarded status writers swallow the fence as a no-op
    leading["v"] = False
    obj = kube.list(POD_GVK)[0]
    assert ns.res.guarded_status_update(guard, obj, lambda o: None) is False
    return [list(c) for c in kube.calls]


def test_not_leader_write_fence():
    got, want = both(_not_leader_write_fence)
    assert got == want


def _audit_loop_gated(ns):
    kube = ns.kube.FakeKube()
    kube.register_kind(POD_GVK)
    opa = ns.Backend(ns.RegoDriver()).new_client([ns.Target()])
    leading = {"v": False}
    am = ns.audit.AuditManager(kube, opa, interval=0.05,
                               leader_check=lambda: leading["v"],
                               gc_stale_statuses=False)
    sweeps = []
    orig = am.audit_once
    am.audit_once = lambda: (sweeps.append(time.time()), orig())[1]
    am.start()
    try:
        time.sleep(0.4)
        assert sweeps == []  # follower never swept
        assert am.healthy()  # but stays live
        leading["v"] = True
        t0 = time.time()
        while not sweeps and time.time() - t0 < 10:
            time.sleep(0.05)
        assert sweeps, "promoted leader never swept"
        # promotion is prompt: the follower polls at a sub-lease cadence
        assert sweeps[0] - t0 < 5
        return bool(sweeps)
    finally:
        am.stop()


def test_audit_loop_gated_on_leadership():
    got, want = both(_audit_loop_gated)
    assert got == want


# ------------------------------------------------------------- byPod GC


def _stale_by_pod_pruned(ns, tmp_path):
    kube = ns.kube.FakeKube()
    rt = _mk_runtime(ns, kube, str(tmp_path / ns.name / "s"))
    _seed_cluster(kube, n=4, violating=1)
    # live replica pods (gatekeeper-labeled) in our namespace
    kube.create({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "gatekeeper-audit-live",
                              "namespace": "gatekeeper-system",
                              "labels": {"gatekeeper.sh/system": "yes"}}})
    rt.start()
    try:
        rt.manager.drain()
        kube.create(NEED_OWNER_CONSTRAINT)
        rt.manager.drain()
        # a replaced pod's stale byPod entry on the constraint status
        obj = kube.get(NEED_OWNER_GVK, "need-owner")
        status = obj.setdefault("status", {})
        by_pod = status.setdefault("byPod", [])
        by_pod.append({"id": "gatekeeper-audit-REPLACED", "enforced": True})
        kube.update(obj, subresource="status")
        rt.audit.audit_once()
        cur = kube.get(NEED_OWNER_GVK, "need-owner")
        ids = [e.get("id") for e in (cur.get("status") or {}).get(
            "byPod", [])]
        assert "gatekeeper-audit-REPLACED" not in ids
        return [ids, _status(kube)]
    finally:
        rt.stop()


def test_stale_by_pod_statuses_pruned(tmp_path):
    got, want = both(_stale_by_pod_pruned, tmp_path)
    assert got == want


# ------------------------------------------------------ kill -9 round-trip

# the reference's child, on the port alone: its state store, audit
# manager and tracker over TorchDriver on the CPU; it prints the JAX
# package's modules it loaded (none may be)
_CHILD_SCRIPT = r"""
import json, os, sys, time
sys.path.insert(0, os.environ["REPO_DIR"])
from gatekeeper_tpu_torch.client import Backend
from gatekeeper_tpu_torch.control.audit import (AuditManager,
                                                InventoryTracker,
                                                _auditable_gvks)
from gatekeeper_tpu_torch.control.kube import FakeKube
from gatekeeper_tpu_torch.control.statestore import (StateStore,
                                                     restore_section)
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.target import K8sValidationTarget

STATE = os.environ["STATE_DIR"]
PHASE = os.environ["PHASE"]
TARGET = "admission.k8s.gatekeeper.sh"

TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate", "metadata": {"name": "k8sneedowner"},
    "spec": {"crd": {"spec": {"names": {"kind": "K8sNeedOwner"}}},
             "targets": [{"target": TARGET, "rego":
                          "package k8sneedowner\n"
                          "violation[{\"msg\": \"no owner\"}] "
                          "{ not input.review.object.metadata.labels.owner }"}]}}
CONSTRAINT = {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
              "kind": "K8sNeedOwner", "metadata": {"name": "no"},
              "spec": {}}

def seed_kube():
    # deterministic cluster: the "apiserver" survives the kill because
    # both phases rebuild it identically (FakeKube RVs are sequential)
    kube = FakeKube()
    kube.register_kind(("", "v1", "Pod"))
    for i in range(60):
        labels = {} if i % 3 == 0 else {"owner": "me"}
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"p{i}", "namespace": "d",
                                  "labels": labels}})
    return kube

kube = seed_kube()
drv = TorchDriver(device="cpu")
client = Backend(drv).new_client([K8sValidationTarget()])
store = StateStore(STATE)

if PHASE == "1":
    client.add_template(TEMPLATE)
    client.add_constraint(CONSTRAINT)
    am = AuditManager(kube, client, incremental=True,
                      gc_stale_statuses=False)
    am.tracker = InventoryTracker(kube, client)
    am.tracker.full_resync(_auditable_gvks(kube))
    store.save_blob("inventory", {"tree": drv.inventory_snapshot() or {},
                                  "tracker": am.tracker.snapshot()})
    store.save("library", client.snapshot_library())
    print("SNAPSHOTTED", flush=True)
    # now sweep forever; the parent kill -9s us mid-sweep
    while True:
        am.tracker.apply_pending()
        client.audit()
        store.save_blob("inventory",
                        {"tree": drv.inventory_snapshot() or {},
                         "tracker": am.tracker.snapshot()})
        print("SWEPT", flush=True)
else:
    ok_lib = restore_section(store, "library", client.restore_library)
    am = AuditManager(kube, client, incremental=True,
                      gc_stale_statuses=False)
    def apply_inv(snap):
        drv.inventory_restore(snap.get("tree") or {})
        am.restore_state(snap.get("tracker") or {})
    ok_inv = restore_section(store, "inventory", apply_inv, blob=True)
    if not ok_lib:
        client.add_template(TEMPLATE)
        client.add_constraint(CONSTRAINT)
    if am.tracker is None:  # cold fallback still converges
        am.tracker = InventoryTracker(kube, client)
        am.tracker.full_resync(_auditable_gvks(kube))
    else:
        am.tracker.apply_pending()
        assert am.tracker.validated.is_set()
    n = len(client.audit().results())
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "gatekeeper_tpu"))
    print(json.dumps({"restored": bool(ok_inv), "violations": n,
                      "loaded": loaded}), flush=True)
    assert n == 20, n
    print("CONVERGED", flush=True)
"""


def test_kill9_mid_sweep_then_restore_converges(tmp_path):
    state_dir = str(tmp_path / "state")
    script = tmp_path / "child.py"
    script.write_text(_CHILD_SCRIPT)
    env = dict(os.environ)
    env.update({"STATE_DIR": state_dir, "PHASE": "1",
                "REPO_DIR": os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))})
    p1 = subprocess.Popen([sys.executable, str(script)], env=env,
                          stdout=subprocess.PIPE, text=True)
    try:
        # wait for the first snapshot + at least one sweep, then KILL -9
        deadline = time.time() + 60
        swept = False
        for line in p1.stdout:
            if "SWEPT" in line:
                swept = True
                break
            if time.time() > deadline:
                break
        assert swept, "child never completed a sweep"
        os.kill(p1.pid, signal.SIGKILL)
        p1.wait(timeout=10)
    finally:
        if p1.poll() is None:
            p1.kill()

    env["PHASE"] = "2"
    p2 = subprocess.run([sys.executable, str(script)], env=env,
                        capture_output=True, text=True, timeout=90)
    assert p2.returncode == 0, p2.stdout + p2.stderr
    assert "CONVERGED" in p2.stdout
    # the atomically-written snapshot survived the SIGKILL: phase 2
    # warm-restored (rename is all-or-nothing; a torn write would have
    # shown up as restored=false via the checksum fallback)
    out = json.loads([ln for ln in p2.stdout.splitlines()
                      if ln.startswith("{")][0])
    assert out == {"restored": True, "violations": 20, "loaded": []}


# ------------------------------------------------- the warm-boot gate


def _warm_runtime_behind_a_prewarm(tmp_path):
    """A cold Runtime's drain snapshot, then a warm Runtime on it
    whose driver has one prewarm thread that runs until the returned
    Event is set. Both drivers take the device path (the plain
    versions on the CPU) with compile-blocking dispatch, so the rows are
    snapshot and can be adopted. Returns (kube, the warm Runtime, the
    Event)."""
    def runtime():
        rt = _mk_runtime(TORCH, kube, state_dir)
        rt.opa.driver.async_warm = False
        rt.opa.driver._use_device_for_batch = lambda n: True
        return rt

    kube = tkube.FakeKube()
    state_dir = str(tmp_path / "state")
    rt = runtime()
    _seed_cluster(kube, n=20, violating=5)
    rt.start()
    rt.manager.drain()
    kube.create(NEED_OWNER_CONSTRAINT)
    rt.manager.drain()
    assert len(rt.audit.audit_once()) == 5
    rt.stop()

    assert "rows.snapshot.blob" in os.listdir(state_dir)
    rt2 = runtime()
    release = threading.Event()
    prewarm = threading.Thread(target=release.wait, daemon=True,
                               name="aot-prewarm-K8sNeedOwner")
    prewarm.start()
    rt2.opa.driver._prewarms.append(prewarm)
    return kube, rt2, release


def test_warm_boot_audit_loop_waits_for_the_restore(tmp_path):
    """The port's Runtime starts a warm boot's audit loop only once the
    restored rows are loaded and the driver's prewarm is done (ROADMAP C,
    a deliberate difference): until then no sweep runs, the state-restore
    readiness check holds and the loop's liveness passes; its first sweep
    is then incremental, re-encodes nothing, lists no Pod and adopts the
    restored rows."""
    kube, rt, release = _warm_runtime_behind_a_prewarm(tmp_path)
    try:
        calls0 = len(kube.calls)
        rt.start()
        rt._rows_restore.join(30)
        assert not rt._rows_restore.is_alive()
        time.sleep(0.2)
        assert rt._audit_gate.is_alive()
        assert rt.audit._thread is None and rt.audit._sweeps == 1
        assert rt.audit.restore_ready() is False
        assert rt.audit.healthy()
        release.set()
        rt._audit_gate.join(30)
        assert rt.audit._thread is not None
        assert rt.restore_gate_s is not None
        deadline = time.monotonic() + 60
        while not rt.audit.restore_ready() or not rt.audit.last_results:
            assert time.monotonic() < deadline, "no first sweep"
            time.sleep(0.02)
        assert _sweep(rt.audit)["sweep"] == "incremental"
        assert _sweep(rt.audit)["dirty"] == 0
        assert len(rt.audit.last_results) == 5
        assert rt.opa.driver.restored_rows_adopted == 1
        assert [c for c in kube.calls[calls0:] if c[0] == "list"
                and c[1] == POD_GVK and c[2] is None] == []
    finally:
        release.set()
        rt.stop()


def test_warm_boot_stopped_behind_the_gate_never_sweeps(tmp_path):
    """A warm Runtime stopped while its audit loop waits for the
    restore never starts the loop, and its drain snapshot still saves."""
    _kube, rt, release = _warm_runtime_behind_a_prewarm(tmp_path)
    rt.start()
    rt._rows_restore.join(30)
    rt.stop()
    release.set()
    rt._audit_gate.join(30)
    assert not rt._audit_gate.is_alive()
    assert rt.audit._thread is None
    assert rt.audit.last_results == []
    assert "inventory.snapshot.blob" in os.listdir(tmp_path / "state")


# ------------------------------------------- the constraint status race


def _status_writers_race(ns, controllers):
    """The constraint controller's byPod write, prepared before the
    audit's status write, lands after it (a Conflict, then a refresh).
    The JAX package's controller puts back its whole status and erases
    the audit's totals until the next sweep (a known reference
    behaviour); the port's overlays only its own keys on the live
    status, so the audit's total 3 survives beside the byPod entry
    (ROADMAP C2, repaired in the port)."""
    kube = ns.kube.FakeKube()
    kube.create(dict(NEED_OWNER_CONSTRAINT))
    opa = ns.Backend(ns.RegoDriver()).new_client([ns.Target()])
    mgr = ns.audit.AuditManager(kube, opa, gc_stale_statuses=False)
    stale = kube.get(NEED_OWNER_GVK, "need-owner")
    stale.setdefault("status", {})["byPod"] = [{"id": "gk-0",
                                                 "enforced": True}]
    assert mgr._update_constraint_status(
        kube.get(NEED_OWNER_GVK, "need-owner"), [], 3)
    assert _status(kube)["totalViolations"] == 3
    controllers._retry_status_update(kube, stale)
    return _status(kube)


def test_constraint_status_writers_erase_each_other():
    from gatekeeper_tpu.control import controllers as jcontrollers
    from gatekeeper_tpu_torch.control import controllers as tcontrollers

    got = _status_writers_race(TORCH, tcontrollers)
    want = _status_writers_race(JAX, jcontrollers)
    # the reference still erases the audit's keys ...
    assert "totalViolations" not in want and want["byPod"]
    # ... the port keeps them beside the controller's byPod
    assert got["totalViolations"] == 3 and got["violations"] == []
    assert got["byPod"] == want["byPod"]
    assert {k: v for k, v in got.items()
            if k not in ("auditTimestamp", "totalViolations",
                         "violations")} == want


def _stale_audit_write(ns, controllers):
    """The reverse order: the audit's status write, prepared from a
    read before the controller's byPod write, lands after it."""
    kube = ns.kube.FakeKube()
    kube.create(dict(NEED_OWNER_CONSTRAINT))
    opa = ns.Backend(ns.RegoDriver()).new_client([ns.Target()])
    mgr = ns.audit.AuditManager(kube, opa, gc_stale_statuses=False)
    stale = kube.get(NEED_OWNER_GVK, "need-owner")
    fresh = kube.get(NEED_OWNER_GVK, "need-owner")
    fresh.setdefault("status", {})["byPod"] = [{"id": "gk-0",
                                                 "enforced": True}]
    controllers._retry_status_update(kube, fresh)
    assert _status(kube)["byPod"]
    assert mgr._update_constraint_status(stale, [], 3)
    return _status(kube)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_stale_audit_status_write_and_by_pod(pkg):
    """A stale audit write keeps the controller's byPod in the port
    (ROADMAP C2); the JAX package's puts back its whole status and
    drops it (pinned: the reference is not changed)."""
    if pkg == "torch":
        from gatekeeper_tpu_torch.control import controllers
        after = _stale_audit_write(TORCH, controllers)
        assert after["byPod"] == [{"id": "gk-0", "enforced": True}]
    else:
        from gatekeeper_tpu.control import controllers
        after = _stale_audit_write(JAX, controllers)
        assert "byPod" not in after
    assert after["totalViolations"] == 3 and after["violations"] == []
