"""The port's sharded audit plane against the JAX package's, in process.

The in-process cases of tests/test_audit_shard.py (:167-:251, :309 at 1,
2 and 4 shards, :352), and BENCH config 13's workload at 1, 2 and 4
shards, each run through both packages: the ShardMap ring, ScopedKube,
the broadcast pruning and spec, and ShardedAuditPlane over an in-process
fleet of slice clients (TorchDriver on the CPU in the port, TpuDriver in
the JAX package) whose composed sweep must equal the unsharded audit of
the same package, result for result and in order. The two packages'
transcripts must be equal too.

The fleet stands in for the multi-process supervisor: per shard a slice
client behind a LibrarySink and an AuditSliceServer. The JAX package's
LibrarySink lives in control/engine.py, which imports the multi-process
plane at module level; the port has neither yet, so its side uses
`_LibrarySink`, a copy of that class's op dispatch (ROADMAP C).
"""

from __future__ import annotations

import json
import signal

import pytest

from gatekeeper_tpu.control.engine import LibrarySink as JLibrarySink

from .test_torch_audit import JAX, TORCH, both

TARGET = "admission.k8s.gatekeeper.sh"
PER_TEST_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _hard_timeout():
    def boom(signum, frame):  # pragma: no cover - only on a real hang
        raise TimeoutError(
            f"test exceeded the {PER_TEST_TIMEOUT_S}s hard timeout")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(PER_TEST_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


class _LibrarySink:
    """gatekeeper_tpu/control/engine.py LibrarySink's op dispatch (the
    replicated library and data ops a shard's client applies), for the
    port until its engine module lands."""

    def __init__(self, client):
        self.client = client

    def __call__(self, op: dict) -> None:
        kind = op.get("op")
        obj = op.get("obj")
        client = self.client
        if kind == "add_template":
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
        else:
            raise ValueError(f"unknown library op {kind!r}")


JAX.LibrarySink = JLibrarySink
TORCH.LibrarySink = _LibrarySink


# ------------------------------------------------------------- fixtures

def _pod(name, ns, labels=None, uid=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns,
                         "uid": uid or f"u-{ns}-{name}",
                         "resourceVersion": "1",
                         **({"labels": labels} if labels else {})}}


def _ingress(name, ns, hosts):
    return {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
            "metadata": {"name": name, "namespace": ns,
                         "uid": f"u-ing-{ns}-{name}",
                         "resourceVersion": "1"},
            "spec": {"rules": [{"host": h} for h in hosts]}}


def _service(name, ns, sel):
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": name, "namespace": ns,
                         "uid": f"u-svc-{ns}-{name}",
                         "resourceVersion": "1"},
            "spec": {"selector": sel}}


def _namespace(name):
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name, "uid": f"u-ns-{name}",
                         "resourceVersion": "1"}}


TEAM_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels",
    "metadata": {"name": "pods-need-team", "uid": "c-team"},
    "spec": {
        "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
        "parameters": {"labels": [{"key": "team"}]},
    },
}


def _join_constraint(kind, name):
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": name, "uid": f"c-{name}"},
            "spec": {}}


def _library(P, client):
    """Per-kind constraint and both cross-object join templates."""
    client.add_template(P.workload.REQUIRED_LABELS_TEMPLATE)
    client.add_template(P.pol.load("general/uniqueingresshost"))
    client.add_template(P.pol.load("general/uniqueserviceselector"))
    client.add_constraint(TEAM_CONSTRAINT)
    client.add_constraint(
        _join_constraint("K8sUniqueIngressHost", "unique-hosts"))
    client.add_constraint(
        _join_constraint("K8sUniqueServiceSelector", "unique-selectors"))


def _objects(n_pods=18):
    """Violations across namespaces, join conflicts across namespaces."""
    objs = [_namespace(f"ns{i}") for i in range(5)]
    for i in range(n_pods):
        objs.append(_pod(f"p-{i}", f"ns{i % 5}",
                         {"team": "core"} if i % 3 else {"app": "x"}))
    objs += [
        _ingress("ing-a", "ns0", ["x.com", "y.com"]),
        _ingress("ing-b", "ns1", ["x.com"]),
        _ingress("ing-c", "ns2", ["unique.com"]),
        _ingress("ing-d", "ns3", ["y.com", "z.com"]),
        _service("svc-1", "ns0", {"app": "web", "tier": "fe"}),
        _service("svc-2", "ns4", {"tier": "fe", "app": "web"}),
        _service("svc-3", "ns1", {"app": "db"}),
    ]
    return objs


def _result_key(r):
    return (r.msg,
            json.dumps(r.metadata, sort_keys=True, default=str),
            json.dumps(r.constraint, sort_keys=True, default=str),
            json.dumps(r.review, sort_keys=True, default=str),
            json.dumps(r.resource, sort_keys=True, default=str),
            r.enforcement_action)


def _client(P):
    return P.Backend(P.driver()).new_client([P.Target()])


def _unsharded_results(P, objs, library=_library):
    client = _client(P)
    library(P, client)
    for o in objs:
        client.add_data(o)
    return [_result_key(r) for r in client.audit().results()]


class _InProcShardFleet:
    """The supervisor's stand-in: a slice client behind a LibrarySink
    and an AuditSliceServer per shard, in this process."""

    def __init__(self, P, shard_count):
        self.clients, self.sinks, self.servers = [], [], []
        for k in range(shard_count):
            c = _client(P)
            if shard_count > 1:
                c.driver.set_audit_shard(k, shard_count)
            self.clients.append(c)
            self.sinks.append(P.LibrarySink(c))
            self.servers.append(P.audit.AuditSliceServer(
                c, shard_id=k, shard_count=shard_count))

    def send(self, k, op, timeout=30.0):
        self.sinks[k](op)

    def replicate(self, op, obj):
        for sink in self.sinks:
            sink({"op": op, "obj": obj})

    def sweep(self, k, body, timeout_s=600.0):
        return self.servers[k].handle_http(body)


# ------------------------------------------------------------- shard map

def case_shardmap_deterministic_and_covering(P):
    """:167."""
    a, b = P.shardmap.ShardMap(4), P.shardmap.ShardMap(4)
    keys = [(("", "v1", "Pod"), f"ns{i}") for i in range(200)]
    keys.append((("apps", "v1", "Deployment"), ""))
    owners = [a.owner(g, ns) for g, ns in keys]
    assert owners == [b.owner(g, ns) for g, ns in keys]
    assert all(0 <= o < 4 for o in owners)
    assert len(set(owners)) == 4
    for (g, ns), o in zip(keys, owners):
        assert a.owns(o, g, ns)
        assert sum(a.owns(k, g, ns) for k in range(4)) == 1
    return owners


def case_shardmap_rebalance_moves_consistent_fraction(P):
    """:182."""
    keys = [(("", "v1", "Pod"), f"ns{i}") for i in range(2000)]
    m = P.shardmap.ShardMap(2)
    v0 = m.version
    stats = m.rebalance(4, keys)
    assert m.version > v0
    assert stats["total"] == 2000
    assert 0.30 < stats["fraction"] < 0.70, stats
    owners = [m.owner(g, ns) for g, ns in keys]
    assert len(set(owners)) == 4
    return [stats, owners]


def case_scoped_kube_filters_list_and_watch(P):
    """:200."""
    kube = P.kube.FakeKube()
    kube.register_kind(("", "v1", "Pod"), namespaced=True)
    kube.register_kind(("", "v1", "Namespace"), namespaced=False)
    for ns in ("ns0", "ns1"):
        kube.create(_namespace(ns))
        for i in range(4):
            kube.create(_pod(f"p{i}", ns))
    scoped = P.kube.ScopedKube(kube, lambda gvk, ns: ns == "ns0")
    got = scoped.list(("", "v1", "Pod"))
    assert len(got) == 4
    assert {o["metadata"]["namespace"] for o in got} == {"ns0"}
    cluster = scoped.list(("", "v1", "Namespace"))
    assert cluster == []
    seen = []
    scoped.watch(("", "v1", "Pod"), lambda ev: seen.append(ev),
                 send_initial=False)
    kube.apply(_pod("w-in", "ns0"))
    kube.apply(_pod("w-out", "ns1"))
    names = sorted(e.object["metadata"]["name"] for e in seen)
    assert "w-in" in names and "w-out" not in names
    assert scoped.get(("", "v1", "Pod"), "w-out", namespace="ns1")
    return [sorted(o["metadata"]["name"] for o in got), names]


def case_broadcast_prune_keeps_identity_and_columns(P):
    """:232."""
    Plane = P.audit.ShardedAuditPlane
    obj = _ingress("ing", "ns1", ["a.com"])
    obj["metadata"]["labels"] = {"team": "net"}
    obj["spec"]["tls"] = [{"hosts": ["a.com"], "secretName": "s"}]
    obj["data"] = {"huge": "x" * 64}
    pruned = Plane._prune(obj, [("spec", "rules")])
    assert pruned["kind"] == "Ingress"
    meta = pruned["metadata"]
    assert meta["name"] == "ing" and meta["namespace"] == "ns1"
    assert meta["uid"] and meta["resourceVersion"]
    assert meta["labels"] == {"team": "net"}
    assert pruned["spec"]["rules"] == obj["spec"]["rules"]
    assert "tls" not in pruned["spec"]
    assert "data" not in pruned
    p2 = Plane._prune(obj, [("spec", "nope", "deeper")])
    assert "spec" not in p2 or "nope" not in p2.get("spec", {})
    return [pruned, p2]


def case_driver_broadcast_spec_names_join_partners(P):
    """:251."""
    client = _client(P)
    _library(P, client)
    spec = client.driver.audit_broadcast_spec()
    assert not spec["full"]
    assert spec["kinds"].get("Namespace", "missing") is None
    assert ("spec", "rules") in [tuple(c) for c in
                                 spec["kinds"]["Ingress"]]
    assert ("spec", "selector") in [tuple(c) for c in
                                    spec["kinds"]["*"]]
    narrow = _client(P)
    narrow.add_template(P.workload.REQUIRED_LABELS_TEMPLATE)
    narrow.add_template(P.pol.load("general/uniqueingresshost"))
    nspec = narrow.driver.audit_broadcast_spec()
    assert "*" not in nspec["kinds"] and "Pod" not in nspec["kinds"]
    return [spec, nspec]


def case_owner_only_kind_not_broadcast(P):
    """:352: with no wildcard-join template, a Pod lands on its owner
    shard alone; a join partner reaches every shard, pruned on all but
    its owner."""
    ops = [[] for _ in range(2)]

    class Spy(_InProcShardFleet):
        def send(self, k, op, timeout=30.0):
            ops[k].append(op)
            super().send(k, op, timeout)

    leader = _client(P)
    fleet = Spy(P, 2)
    plane = P.audit.ShardedAuditPlane(P.kube.FakeKube(), leader, fleet, 2)
    plane.attach()
    leader.add_template(P.workload.REQUIRED_LABELS_TEMPLATE)
    leader.add_template(P.pol.load("general/uniqueingresshost"))
    leader.add_constraint(TEAM_CONSTRAINT)
    leader.add_constraint(
        _join_constraint("K8sUniqueIngressHost", "unique-hosts"))
    leader.add_data(_pod("solo", "nsX", {"team": "t"}))
    holders = [k for k in range(2)
               if any(o.get("op") == "add_data" and
                      o["obj"]["metadata"]["name"] == "solo"
                      for o in ops[k])]
    assert len(holders) == 1
    ing = _ingress("bcast", "nsY", ["q.com"])
    ing["spec"]["extra"] = {"not": "a join column"}
    leader.add_data(ing)
    copies = [o["obj"] for k in range(2) for o in ops[k]
              if o.get("op") == "add_data" and
              o["obj"]["metadata"]["name"] == "bcast"]
    assert len(copies) == 2
    pruned = [c for c in copies if "extra" not in c.get("spec", {})]
    assert len(pruned) == 1
    assert pruned[0]["spec"]["rules"] == ing["spec"]["rules"]
    plane.stop()
    return [holders, copies]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_shard_case_equal(case):
    got, want = both(case)
    assert got == want


# --------------------------------------- in-process plane differential

def case_sharded_plane_bit_equal_differential(P, shards):
    """:309: the composed sharded round (routed, pruned, swept per
    shard, heap-merged) equals the unsharded audit, join kinds included;
    a routed delete heals the cross-namespace join as unsharded does."""
    objs = _objects()
    baseline = _unsharded_results(P, objs)
    assert baseline
    assert [k for k in baseline
            if "host" in k[0] or "selector" in k[0].lower()]
    leader = _client(P)
    fleet = _InProcShardFleet(P, shards)
    plane = P.audit.ShardedAuditPlane(P.kube.FakeKube(), leader, fleet,
                                      shards)
    plane.attach()
    _library(P, leader)
    for o in objs:
        leader.add_data(o)
    results, stats = plane.sweep(None)
    got = [_result_key(r) for r in results]
    assert got == baseline
    assert stats["shard_eval_max_s"] >= 0.0
    per_shard = [len(c.audit().results()) for c in fleet.clients]
    if shards > 1:
        assert sum(per_shard) == len(baseline)
        assert all(n < len(baseline) for n in per_shard), per_shard
    gone = _ingress("ing-b", "ns1", ["x.com"])
    leader.remove_data(gone)
    unsharded = _client(P)
    _library(P, unsharded)
    for o in objs:
        unsharded.add_data(o)
    unsharded.remove_data(gone)
    after, _ = plane.sweep(None)
    after = [_result_key(r) for r in after]
    assert after == [_result_key(r) for r in unsharded.audit().results()]
    plane.stop()
    return [got, per_shard, after]


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_plane_bit_equal_differential(shards):
    got, want = both(case_sharded_plane_bit_equal_differential, shards)
    assert got == want


# BENCH config 13 (bench_configs.py config13) at 200,000 pods: 2,000
# namespaces, a pod in every 1,000th without its team label, 200
# Ingresses (two on shared hosts, no conflict), requiredlabels and the
# fixed-kind ingress join. Thinned to every 100th pod (all 200 violating
# pods kept) to fit a CPU test; the 200 violations stay.
C13_PODS, C13_KEEP = 200_000, 100


def _c13_library(P, client):
    client.add_template(P.workload.REQUIRED_LABELS_TEMPLATE)
    client.add_template(P.pol.load("general/uniqueingresshost"))
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sRequiredLabels",
        "metadata": {"name": "pods-need-team"},
        "spec": {"match": {"kinds": [{"apiGroups": [""],
                                      "kinds": ["Pod"]}]},
                 "parameters": {"labels": [{"key": "team"}]}}})
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sUniqueIngressHost",
        "metadata": {"name": "unique-hosts"}, "spec": {}})


def _c13_objects() -> list:
    n = C13_PODS
    n_ns = max(16, min(8192, n // 100))
    n_ing = max(4, n // 1000)
    objs = [{"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": f"ns{i}"}} for i in range(n_ns)]
    for i in range(0, n, C13_KEEP):
        labels = {"team": "core"} if i % 1000 else {"app": "x"}
        objs.append({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"p-{i}",
                                  "namespace": f"ns{i % n_ns}",
                                  "labels": labels}})
    for i in range(n_ing):
        host = (f"dup{i % 8}.corp.example" if i % 100 == 1
                else f"h{i}.corp.example")
        objs.append({"apiVersion": "networking.k8s.io/v1",
                     "kind": "Ingress",
                     "metadata": {"name": f"ing-{i}",
                                  "namespace": f"ns{i % n_ns}"},
                     "spec": {"rules": [{"host": host}]}})
    return objs


def case_config13_violations_at_every_shard_count(P, shards):
    objs = _c13_objects()
    baseline = _unsharded_results(P, objs, library=_c13_library)
    assert len(baseline) == 200
    leader = _client(P)
    fleet = _InProcShardFleet(P, shards)
    plane = P.audit.ShardedAuditPlane(P.kube.FakeKube(), leader, fleet,
                                      shards)
    plane.attach()
    _c13_library(P, leader)
    for o in objs:
        leader.add_data(o)
    results, _stats = plane.sweep(None)
    got = [_result_key(r) for r in results]
    assert len(got) == 200
    assert got == baseline
    plane.stop()
    return [len(got), got[:3], got[-3:]]


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_config13_violations_at_every_shard_count(shards):
    got, want = both(case_config13_violations_at_every_shard_count, shards)
    assert got == want
