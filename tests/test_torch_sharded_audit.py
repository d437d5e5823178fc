"""The port's sharded audit plane with its shards as child processes,
against the JAX package's.

BENCH config 13's cluster (parallel/workload.py c13_objects) at 2,000
pods, with two Ingresses on one host in two namespaces so that the join
fires across shards: per constraint, the port's composed round over two
`gatekeeper_tpu_torch.control.engine --serve auditslice` children on
`--device cpu` equals the JAX package's ShardedAuditPlane over two of
its own shard children and both packages' unsharded audits, result for
result; after routed churn and after a shard is killed, respawned and
resynced as well. Then the same cluster under both packages' Runtime
with `--audit-shards 2`, and a child asked for the card where there is
none failing its start.

Every test runs under a hard SIGALRM timeout, as the reference's
subprocess tests do.
"""

from __future__ import annotations

import json
import os
import signal
import tempfile
import types
from pathlib import Path

import pytest

from gatekeeper_tpu import policies as jpolicies
from gatekeeper_tpu.control import backplane as jbackplane
from gatekeeper_tpu_torch import policies as tpolicies
from gatekeeper_tpu_torch.control import backplane as tbackplane
from gatekeeper_tpu_torch.parallel.workload import (
    C13_CONSTRAINTS, REQUIRED_LABELS_TEMPLATE, c13_churn, c13_objects)

from . import test_torch_warm_restart as wr

JAX = types.SimpleNamespace(**vars(wr.JAX), backplane=jbackplane,
                            policies=jpolicies, spawn=[])
TORCH = types.SimpleNamespace(**vars(wr.TORCH), backplane=tbackplane,
                              policies=tpolicies,
                              spawn=["--device", "cpu"])

PER_TEST_TIMEOUT_S = 180
PODS = 2000
SHARDS = 2
C13_GVKS = (("", "v1", "Namespace"), ("", "v1", "Pod"),
            ("networking.k8s.io", "v1", "Ingress"))


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


def _objects() -> list:
    objs = c13_objects(PODS)
    for name, ns in (("ing-shared-a", "ns1"), ("ing-shared-b", "ns2")):
        objs.append({"apiVersion": "networking.k8s.io/v1",
                     "kind": "Ingress",
                     "metadata": {"name": name, "namespace": ns},
                     "spec": {"rules": [{"host": "shared.corp.example"}]}})
    return objs


def _library(P, client) -> None:
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    client.add_template(P.policies.load("general/uniqueingresshost"))
    for c in C13_CONSTRAINTS:
        client.add_constraint(c)


def _result_key(r):
    return (r.msg,
            json.dumps(r.constraint, sort_keys=True, default=str),
            json.dumps(r.resource, sort_keys=True, default=str),
            r.enforcement_action)


def _per_constraint(keys) -> dict:
    out: dict = {}
    for k in keys:
        c = json.loads(k[1])
        name = f"{c['kind']}/{c['metadata']['name']}"
        out[name] = out.get(name, 0) + 1
    return out


def _sharded_rounds(P, tmp: str) -> dict:
    """Per round the composed results of P's plane over two shard
    children, with the leader's unsharded audit beside the first."""
    leader = P.Backend(P.driver()).new_client([P.Target()])
    _library(P, leader)
    for o in _objects():
        leader.add_data(o)
    unsharded = [_result_key(r) for r in leader.audit().results()]
    box: list = []
    sup = P.backplane.AuditShardSupervisor(
        SHARDS, socket_for=lambda k: os.path.join(tmp, f"a.{k}"),
        spawn_args=["--log-level", "WARNING"] + P.spawn,
        snapshot_provider=lambda k: box[0].sync_snapshot(k))
    plane = P.audit.ShardedAuditPlane(P.kube.FakeKube(), leader, sup,
                                      SHARDS)
    box.append(plane)
    out = {"unsharded": unsharded}
    try:
        sup.start()
        # the children run the package's own engine module
        for pid in sup.child_pids().values():
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
            module = cmd[cmd.index(b"-m") + 1].decode()
            out.setdefault("modules", []).append(module)
        out["first"] = [_result_key(r) for r in plane.sweep(None)[0]]
        plane.attach()
        for r in range(2):
            for pod in c13_churn(PODS, r):
                leader.add_data(pod)
        # a routed delete heals the cross-namespace join
        leader.remove_data(_objects()[-1])
        out["churn"] = [_result_key(r) for r in plane.sweep(None)[0]]
        out["unsharded_churn"] = [_result_key(r)
                                  for r in leader.audit().results()]
        gen = dict(sup.generation)
        sup.kill_engine(1)
        out["killed"] = [_result_key(r) for r in plane.sweep(None)[0]]
        assert sup.generation[1] > gen[1] and sup.alive_count() == SHARDS
    finally:
        sup.stop()
        plane.stop()
    return out


def test_subprocess_shards_equal_the_jax_package():
    with tempfile.TemporaryDirectory(prefix="gk-t-") as a, \
            tempfile.TemporaryDirectory(prefix="gk-j-") as b:
        got = _sharded_rounds(TORCH, a)
        want = _sharded_rounds(JAX, b)
    assert got["modules"] == ["gatekeeper_tpu_torch.control.engine"] * 2
    assert want["modules"] == ["gatekeeper_tpu.control.engine"] * 2
    # each package's composed round equals its own unsharded audit ...
    for P in (got, want):
        assert P["first"] == P["unsharded"] and P["killed"] == P["churn"]
        assert P["churn"] == P["unsharded_churn"]
    # ... and the port's every round equals the JAX package's
    for k in ("unsharded", "first", "churn", "killed"):
        assert got[k] == want[k], k
    assert _per_constraint(got["first"]) == {
        "K8sRequiredLabels/pods-need-team": 2,
        "K8sUniqueIngressHost/unique-hosts": 2}
    assert _per_constraint(got["churn"]) == {
        "K8sRequiredLabels/pods-need-team": 2}


def _runtime_statuses(P, tmp: str) -> dict:
    """P's Runtime with --operation audit --audit-shards 2 over the
    cluster on a FakeKube: one sweep's results and statuses."""
    kube = P.kube.FakeKube()
    for gvk in C13_GVKS:
        kube.register_kind(gvk, namespaced=gvk[2] != "Namespace")
    for o in _objects():
        kube.create(o)
    kube.create(REQUIRED_LABELS_TEMPLATE)
    kube.create(P.policies.load("general/uniqueingresshost"))
    args = P.main.build_parser().parse_args(P.device + [
        "--fake-kube", "--operation", "audit", "--audit-shards",
        str(SHARDS), "--audit-interval", "9999", "--port", "0",
        "--health-addr", ":0", "--prometheus-port", "0",
        "--disable-cert-rotation", "--backplane-socket",
        os.path.join(tmp, "bp.sock")])
    rt = P.main.Runtime(args, kube=kube)
    rt.args.metrics_backend = "none"
    rt.start()
    try:
        rt.manager.drain()
        for c in C13_CONSTRAINTS:
            kube.create(dict(c))
        rt.manager.drain()
        assert rt.audit_shards is not None
        assert rt.audit_shards.alive_count() == SHARDS
        results = sorted(_result_key(r) for r in rt.audit.audit_once())
        statuses = {}
        for c in C13_CONSTRAINTS:
            st = dict(kube.get(("constraints.gatekeeper.sh", "v1beta1",
                                c["kind"]), c["metadata"]["name"])
                      .get("status") or {})
            st.pop("auditTimestamp", None)
            st.pop("byPod", None)
            statuses[c["kind"]] = st
    finally:
        rt.stop()
    return {"results": results, "statuses": statuses}


def test_runtime_audit_shards_equal_the_jax_package():
    """Both packages' Runtime with --audit-shards 2 (the port's on
    --device cpu): the leader's sweep over its two shard children gives
    equal results and writes equal statuses."""
    with tempfile.TemporaryDirectory(prefix="gk-t-") as a, \
            tempfile.TemporaryDirectory(prefix="gk-j-") as b:
        got = _runtime_statuses(TORCH, a)
        want = _runtime_statuses(JAX, b)
    assert got == want
    assert got["statuses"]["K8sRequiredLabels"]["totalViolations"] == 2
    assert got["statuses"]["K8sUniqueIngressHost"]["totalViolations"] == 2


@pytest.mark.parametrize("plane", ["audit", "engine", "frontend"])
def test_child_asked_for_the_card_without_one_fails_its_start(plane):
    """A child whose --device names the card (the supervisor's card
    index) on a host without one raises at TorchDriver construction and
    never prints READY: the supervisor's start fails, and nothing
    evaluates on the CPU. A frontend child whose certificate is missing
    exits before READY the same way. Either start returns with every
    child it spawned dead and reaped."""
    with tempfile.TemporaryDirectory(prefix="gk-t-") as tmp:
        sock = lambda k: os.path.join(tmp, f"s.{k}")  # noqa: E731
        if plane == "audit":
            sup = tbackplane.AuditShardSupervisor(
                1, socket_for=sock, spawn_args=["--log-level", "WARNING"],
                ready_timeout=60.0)
        elif plane == "frontend":
            sup = tbackplane.FrontendSupervisor(
                1, sock(0), port=0, addr="127.0.0.1",
                certfile=os.path.join(tmp, "missing.crt"),
                ready_timeout=60.0)
        else:
            sup = tbackplane.EngineSupervisor(
                [1], socket_for=sock, spawn_args=["--log-level", "WARNING"],
                ready_timeout=60.0)
        with pytest.raises(RuntimeError, match="failed to start"):
            sup.start()
        assert sup.child_pids() == {}


@pytest.mark.parametrize("flag,cards,want", [
    ("cpu", 0, "cpu"), ("cuda:1", 0, "cuda:1"), ("-1", 1, "cuda"),
    ("0", 1, "cuda:0"), ("3", 2, "cuda:1"), ("1", 1, "cuda:0"),
    ("2", 0, "cuda")])
def test_engine_device_maps_a_card_index(monkeypatch, flag, cards, want):
    """engine.py's --device: card index k is cuda:{k % cards} (every
    engine shares the one card of a one-card host), -1 the current
    card, a device string itself; with no card an index gives `cuda`,
    on which TorchDriver raises."""
    import torch

    from gatekeeper_tpu_torch.control.engine import engine_device

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert engine_device(flag) == want


@pytest.mark.parametrize("device,want", [
    ("cuda", []), ("cpu", ["--device", "cpu"]),
    ("cuda:1", ["--device", "cuda:1"])])
def test_primary_device_reaches_its_children(device, want):
    """A Runtime on the card leaves each child the supervisor's card
    index; elsewhere it passes its own device, after that index."""
    from gatekeeper_tpu_torch.control.main import (_child_device_args,
                                                   build_parser)

    args = build_parser().parse_args(["--device", device])
    assert _child_device_args(args) == want
