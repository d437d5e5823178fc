"""The port's kube-write resilience and device-path quarantine against
the JAX package's.

The cases of tests/test_resilience.py that need neither `main` nor
`health`: the circuit breaker, the retry budget and retry_call,
GuardedKube under injected kube faults, the device-eval quarantine, and
the audit manager under them (status writes deferred while the write
breaker is open, the InventoryTracker polling under a watch fault, the
liveness watchdog), each run through both packages (their own
`control.resilience`, `control.audit`, `control.kube.FakeKube` and
`utils.faults.FAULTS`; TorchDriver on the CPU in the port, TpuDriver in
the JAX package). Every case returns a transcript of what it observed,
and the transcripts must be equal (exact); the reference's own
expectations are asserted inside each case as well.
"""

from __future__ import annotations

import signal
import time
import types

import pytest

from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.client import RegoDriver as JRegoDriver
from gatekeeper_tpu.control import audit as jaudit
from gatekeeper_tpu.control import kube as jkube
from gatekeeper_tpu.control import metrics as jmetrics
from gatekeeper_tpu.control import resilience as jres
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu.utils import faults as jfaults
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client import RegoDriver as TRegoDriver
from gatekeeper_tpu_torch.control import audit as taudit
from gatekeeper_tpu_torch.control import kube as tkube
from gatekeeper_tpu_torch.control import metrics as tmetrics
from gatekeeper_tpu_torch.control import resilience as tres
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils import faults as tfaults

JAX = types.SimpleNamespace(
    audit=jaudit, res=jres, kube=jkube, metrics=jmetrics, faults=jfaults,
    FAULTS=jfaults.FAULTS, Backend=JBackend, Target=JTarget,
    RegoDriver=JRegoDriver, driver=TpuDriver)
TORCH = types.SimpleNamespace(
    audit=taudit, res=tres, kube=tkube, metrics=tmetrics, faults=tfaults,
    FAULTS=tfaults.FAULTS, Backend=TBackend, Target=TTarget,
    RegoDriver=TRegoDriver, driver=lambda: TorchDriver(device="cpu"))

TARGET = "admission.k8s.gatekeeper.sh"
NS_GVK = ("", "v1", "Namespace")
PER_TEST_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _hard_timeout_and_clean_faults():
    """tests/test_resilience.py's per-test timeout, and no armed fault
    of either package leaks into the next case."""

    def boom(signum, frame):  # pragma: no cover - only on a real hang
        raise TimeoutError(
            f"test exceeded the {PER_TEST_TIMEOUT_S}s hard timeout")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(PER_TEST_TIMEOUT_S)
    JAX.FAULTS.reset()
    TORCH.FAULTS.reset()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        JAX.FAULTS.reset()
        TORCH.FAULTS.reset()


def _policy_client(P, driver=None):
    driver = driver if driver is not None else P.RegoDriver()
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
    return driver, client


def _review(name, ns="d"):
    obj = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": ns}}
    return {"uid": f"uid-{name}", "operation": "CREATE",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": name, "namespace": ns,
            "userInfo": {"username": "chaos"}, "object": obj}


def _ns(name):
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name}}


def _metric(P, prefix: str, label: str = "") -> list:
    return sorted(line for line in P.metrics.REGISTRY.render().splitlines()
                  if line.startswith(prefix) and label in line)


def _raised(fn) -> str:
    try:
        fn()
    except BaseException as e:  # the transcript records what escaped
        return type(e).__name__
    return "none"


# ------------------------------------------------ breaker and retry_call


def case_retry_call_releases_probe_slot_on_unexpected_error(P):
    """:193."""
    CB = P.res.CircuitBreaker
    br = CB("g5", failure_threshold=1, reset_timeout=0.1)
    br.record_failure()
    time.sleep(0.15)

    def garbage():
        raise ValueError("not json")

    out = [_raised(lambda: P.res.retry_call(garbage, breaker=br)), br.state]
    assert out == ["ValueError", CB.OPEN]
    time.sleep(0.15)
    assert P.res.retry_call(lambda: "ok", breaker=br) == "ok"
    assert br.state == CB.CLOSED
    return out + [br.state]


def case_breaker_half_open_probe_lease_expires(P):
    """:214."""
    CB = P.res.CircuitBreaker
    br = CB("g6", failure_threshold=1, reset_timeout=0.1)
    br.record_failure()
    time.sleep(0.15)
    out = [br.allow(), br.allow()]
    assert out == [True, False]
    time.sleep(0.15)
    out += [br.state, br.allow()]
    assert out[2:] == [CB.HALF_OPEN, True]
    br.record_success()
    assert br.state == CB.CLOSED
    return out + [br.state]


def case_breaker_abandon_releases_probe_without_verdict(P):
    """:231."""
    CB = P.res.CircuitBreaker
    br = CB("g7", failure_threshold=1, reset_timeout=0.05)
    br.record_failure()
    time.sleep(0.1)
    out = [br.allow()]
    br.abandon()
    out += [br.state, br.allow()]
    assert out == [True, CB.HALF_OPEN, True]
    br.record_failure()
    assert br.state == CB.OPEN
    return out + [br.state]


def case_retry_call_baseexception_abandons_probe(P):
    """:247."""
    CB = P.res.CircuitBreaker
    br = CB("g8", failure_threshold=1, reset_timeout=0.05)
    br.record_failure()
    time.sleep(0.1)
    out = [br.state]

    def cancelled():
        raise KeyboardInterrupt()

    out += [_raised(lambda: P.res.retry_call(cancelled, breaker=br)),
            br.state]
    assert out == [CB.HALF_OPEN, "KeyboardInterrupt", CB.HALF_OPEN]
    assert P.res.retry_call(lambda: "ok", breaker=br) == "ok"
    assert br.state == CB.CLOSED
    return out + [br.state]


def case_circuit_breaker_transitions(P):
    """:448, with the breaker's state gauge."""
    CB = P.res.CircuitBreaker
    # a name of its own: the registry is the process's, shared with the
    # reference's suite on the same worker
    br = CB("diff-t", failure_threshold=3, reset_timeout=0.2)
    gauge = "gatekeeper_tpu_circuit_breaker", 'breaker="diff-t"'
    out = [br.state]
    for _ in range(3):
        out.append(br.allow())
        br.record_failure()
    out += [br.state, br.allow(), _metric(P, *gauge)]
    assert out[4:6] == [CB.OPEN, False]
    time.sleep(0.25)
    out += [br.state, br.allow(), br.allow()]
    assert out[-3:] == [CB.HALF_OPEN, True, False]
    br.record_failure()
    out.append(br.state)
    time.sleep(0.25)
    out.append(br.allow())
    br.record_success()
    out += [br.state, _metric(P, *gauge)]
    assert out[-4:-1] == [CB.OPEN, True, CB.CLOSED]
    return out


# --------------------------------------------- GuardedKube under faults


def case_guarded_kube_retries_transient_then_succeeds(P):
    """:469."""
    kube = P.kube.FakeKube()
    kube.register_kind(NS_GVK, namespaced=False)
    guard = P.res.GuardedKube(kube, P.res.CircuitBreaker(
        "g1", failure_threshold=10), P.res.RetryBudget(10))
    P.FAULTS.inject("kube.write", mode="error", param="503", count=2)
    out = guard.create(_ns("ns1"))
    assert out["metadata"]["name"] == "ns1"
    assert P.FAULTS.fired("kube.write") == 2
    return [out, P.FAULTS.fired("kube.write"), kube.calls]


def case_guarded_kube_breaker_opens_and_fails_fast_under_storm(P):
    """:481."""
    kube = P.kube.FakeKube()
    kube.register_kind(NS_GVK, namespaced=False)
    br = P.res.CircuitBreaker("g2", failure_threshold=4, reset_timeout=0.3)
    guard = P.res.GuardedKube(kube, br, P.res.RetryBudget(3, refill_per_s=0.0),
                              attempts=3)
    P.FAULTS.inject("kube.write", mode="error", param="503")

    def ns(i):
        return {"apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": f"s{i}"}}

    out = [_raised(lambda: guard.create(ns(0)))]
    for i in range(1, 6):
        out.append(_raised(lambda: guard.create(ns(i))))
    assert br.state == P.res.CircuitBreaker.OPEN
    calls_before = len(kube.calls)
    out.append(_raised(lambda: guard.create(ns(99))))
    assert out[-1] == "BreakerOpen"
    assert len(kube.calls) == calls_before
    P.FAULTS.clear("kube.write")
    time.sleep(0.35)
    made = guard.create(ns(7))
    assert made["metadata"]["name"] == "s7"
    assert br.state == P.res.CircuitBreaker.CLOSED
    return out + [calls_before, made, br.state]


def case_client_errors_do_not_trip_breaker(P):
    """:553."""
    kube = P.kube.FakeKube()
    kube.register_kind(NS_GVK, namespaced=False)
    br = P.res.CircuitBreaker("g4", failure_threshold=2, reset_timeout=30)
    guard = P.res.GuardedKube(kube, br, P.res.RetryBudget(10))
    P.FAULTS.inject("kube.write", mode="error", param="403")
    out = []
    for i in range(6):
        with pytest.raises(P.kube.KubeError) as ei:
            guard.create({"apiVersion": "v1", "kind": "Namespace",
                          "metadata": {"name": f"x{i}"}})
        assert not isinstance(ei.value, P.res.BreakerOpen)
        out.append((type(ei.value).__name__, ei.value.code))
    assert br.state == P.res.CircuitBreaker.CLOSED
    assert P.FAULTS.fired("kube.write") == 6
    return out + [br.state, P.FAULTS.fired("kube.write")]


def case_watch_drop_storm_fails_the_watch_then_heals(P):
    """:670: under a kube.watch fault the guarded watch raises a
    KubeError (500) before subscribing, and the InventoryTracker on it
    degrades to polling (a re-list diff per sweep still syncs its
    state); once the storm ends the next watch subscribes and streams
    events, and the tracker's next sweep re-subscribes quietly."""
    kube = P.kube.FakeKube()
    kube.register_kind(("", "v1", "Pod"))
    guard = P.res.GuardedKube(kube)
    seen: list = []
    P.FAULTS.inject("kube.watch", mode="error")
    with pytest.raises(P.kube.KubeError) as ei:
        guard.watch(("", "v1", "Pod"), seen.append)
    out = [type(ei.value).__name__, ei.value.code, P.FAULTS.fired("kube.watch")]
    kube.create({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "p1", "namespace": "d"}})
    assert seen == []
    P.FAULTS.clear("kube.watch")
    cancel = guard.watch(("", "v1", "Pod"), seen.append)
    kube.create({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "p2", "namespace": "d"}})
    cancel()
    got = [(e.type, e.object["metadata"]["name"]) for e in seen]
    assert got == [("ADDED", "p1"), ("ADDED", "p2")]
    out.append(got)
    # the tracker half, on a fresh kube
    kube = P.kube.FakeKube()
    kube.register_kind(("", "v1", "Pod"))
    guard = P.res.GuardedKube(kube)
    _, client = _policy_client(P)
    tracker = P.audit.InventoryTracker(guard, client)
    P.FAULTS.inject("kube.watch", mode="error")
    tracker.set_gvks([("", "v1", "Pod")])
    assert tracker._poll == {("", "v1", "Pod")}  # degraded to polling
    kube.create({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "p1", "namespace": "d"}})
    stats = tracker.apply_pending()  # the re-list diff still syncs
    assert stats["total"] == 1
    P.FAULTS.clear("kube.watch")
    tracker.apply_pending()
    assert tracker._poll == set()
    kube.create({"apiVersion": "v1", "kind": "Pod",
                 "metadata": {"name": "p2", "namespace": "d"}})
    healed = tracker.apply_pending()
    assert healed["total"] == 2
    tracker.stop()
    return out + [stats, healed, sorted(tracker._state)]


def case_audit_defers_status_writes_while_breaker_open(P):
    """:513: under a kube 5xx storm the audit keeps sweeping but defers
    constraint-status writes; the pending delta is written on the first
    healthy sweep."""
    kube = P.kube.FakeKube()
    kube.register_kind(NS_GVK, namespaced=False)
    kube.register_kind(("constraints.gatekeeper.sh", "v1beta1",
                        "K8sNeedOwner"), namespaced=False)
    _, client = _policy_client(P, P.driver())
    kube.create({"apiVersion": "constraints.gatekeeper.sh/v1beta1",
                 "kind": "K8sNeedOwner",
                 "metadata": {"name": "need-owner"}, "spec": {}})
    client.add_data(_ns("bad-ns"))
    br = P.res.CircuitBreaker("audit-w", failure_threshold=1,
                              reset_timeout=0.3)
    guard = P.res.GuardedKube(kube, br, P.res.RetryBudget(2, refill_per_s=0.0),
                              attempts=2)
    mgr = P.audit.AuditManager(guard, client, audit_from_cache=True,
                               write_breaker=br)
    P.FAULTS.inject("kube.write", mode="error", param="503")
    results = mgr.audit_once()  # storm: writes fail, breaker opens
    assert len(results) == 1
    assert br.state == P.res.CircuitBreaker.OPEN
    updates = lambda: len([c for c in kube.calls  # noqa: E731
                           if c[0] == "update"])
    updates_while_open = updates()
    results2 = mgr.audit_once()  # breaker open: writes deferred
    assert mgr.last_sweep_stats is not None
    assert updates() == updates_while_open, \
        "status writes not deferred while open"
    P.FAULTS.clear("kube.write")
    time.sleep(0.35)
    mgr.audit_once()
    status = kube.get(("constraints.gatekeeper.sh", "v1beta1",
                       "K8sNeedOwner"), "need-owner").get("status") or {}
    assert status.get("totalViolations") == 1
    assert br.state == P.res.CircuitBreaker.CLOSED
    mgr.stop()
    return [len(results), len(results2), updates_while_open, updates(),
            status.get("totalViolations"), status.get("violations"),
            br.state]


def case_liveness_watchdog_flags_dead_audit_loop(P):
    """:785."""
    kube = P.kube.FakeKube()
    _, client = _policy_client(P, P.driver())
    mgr = P.audit.AuditManager(kube, client, interval=0.1,
                               audit_from_cache=True)
    out = [mgr.healthy()]  # not started: vacuously alive
    mgr.start()
    time.sleep(0.05)
    out.append(mgr.healthy())
    mgr.stop()
    deadline = time.time() + 5
    while mgr._thread.is_alive() and time.time() < deadline:
        time.sleep(0.02)
    out.append(mgr.healthy())  # stopped on purpose
    mgr._stop.clear()  # a CRASHED (not stopped) loop
    out.append(mgr.healthy())
    assert out == [True, True, True, False]
    return out


# ---------------------------------------------- device-eval quarantine


def case_eval_failure_quarantines_template_and_interp_serves(P):
    """:574."""
    driver, client = _policy_client(P, P.driver())
    for i in range(6):
        client.add_data(_ns(f"n{i}"))
    driver.quarantine_base_s = 0.3
    P.FAULTS.inject("eval.device", mode="raise",
                    match={"kind": "K8sNeedOwner"})
    results = client.audit().results()
    assert len(results) == 6
    q = driver.quarantine_status()
    assert "K8sNeedOwner" in q and q["K8sNeedOwner"]["fails"] == 1
    gauge = "gatekeeper_tpu_template_quarantined"
    label = 'kind="K8sNeedOwner"'
    out = [len(results), q["K8sNeedOwner"]["reason"],
           _metric(P, gauge, label)]
    assert f'{gauge}{{kind="K8sNeedOwner"}} 1' in out[-1]
    fired = P.FAULTS.fired("eval.device")
    assert len(client.audit().results()) == 6
    assert P.FAULTS.fired("eval.device") == fired
    P.FAULTS.clear("eval.device")
    time.sleep(0.35)
    driver._dev_batch_lat_s = 1e-4   # cost model: prefer the device
    driver._host_pair_rate = 1.0
    assert len(client.audit().results()) == 6
    assert driver.quarantine_status() == {}
    out += [fired, _metric(P, gauge, label)]
    assert f'{gauge}{{kind="K8sNeedOwner"}} 0' in out[-1]
    return out


def case_quarantine_half_open_allows_single_probe(P):
    """:608."""
    driver, _client = _policy_client(P, P.driver())
    driver.quarantine_base_s = 0.01
    driver._quarantine_kind("K8sNeedOwner", "review-eval",
                            RuntimeError("injected"))
    time.sleep(0.05)
    out = [driver._quarantined("K8sNeedOwner"),
           driver._quarantined("K8sNeedOwner"),
           driver.compiled_for("K8sNeedOwner")]
    assert out == [False, True, None]
    driver._quarantine_kind("K8sNeedOwner", "review-eval",
                            RuntimeError("probe failed"))
    assert driver._quarantined("K8sNeedOwner") is True
    st = driver.quarantine_status()["K8sNeedOwner"]
    assert st["fails"] == 2
    return out + [st["fails"], st["reason"]]


def case_one_bad_template_does_not_take_down_cobatched_reviews(P):
    """:629."""
    driver, client = _policy_client(P, P.driver())
    client.add_template({
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8sneedteam"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sNeedTeam"}}},
            "targets": [{"target": TARGET, "rego": """
package k8sneedteam
violation[{"msg": "no team label"}] {
  not input.review.object.metadata.labels.team
}
"""}]},
    })
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sNeedTeam", "metadata": {"name": "need-team"},
        "spec": {}})
    driver.quarantine_base_s = 30.0
    driver._dev_batch_lat_s = 1e-4
    driver._host_pair_rate = 1.0
    P.FAULTS.inject("eval.device", match={"kind": "K8sNeedOwner"})
    outs = driver.review_batch(TARGET, [_review(f"p{i}") for i in range(8)])
    assert len(outs) == 8
    got = [sorted(((r.constraint or {}).get("kind"), r.msg)
                  for r in per_review) for per_review in outs]
    for per_review in got:
        assert [k for k, _m in per_review] == ["K8sNeedOwner", "K8sNeedTeam"]
    q = sorted(driver.quarantine_status())
    assert q == ["K8sNeedOwner"]
    return [got, q]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_resilience_case_equal(case):
    got = case(TORCH)
    JAX.FAULTS.reset()
    TORCH.FAULTS.reset()
    assert got == case(JAX)
