"""The port's streaming audit and enforcement actions against the JAX
package's.

The streaming cases of tests/test_streaming.py (:125, :167, :187, :212,
:241, :266) and its enforcementAction cases (:573, one parametrised
test, and :587), each run through both packages: the audit manager's
stream loop over a FakeKube with TorchDriver on the CPU in the port and
TpuDriver in the JAX package, and the webhook's ValidationHandler. The
reference's own expectations are asserted inside each case, and the
transcripts (what each flush wrote, the constraint's published status,
the stream's error and skip counts, the admission responses) must be
equal. Latencies are clocks and stay out of the transcripts; each case
bounds them as the reference does. One more case pins a property of
both packages' stream flush (a total that moves past the violations cap
stays stale until the interval sweep). The preview cases are in
tests/test_torch_preview.py; :480 needs the multi-process plane.
"""

from __future__ import annotations

import copy
import re
import threading
import time

import pytest

from .test_torch_audit import both, statuses

CONSTRAINT_GVK = ("constraints.gatekeeper.sh", "v1beta1",
                  "K8sRequiredLabels")
TEAM_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels",
    "metadata": {"name": "pods-need-team", "uid": "c-team"},
    "spec": {
        "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
        "parameters": {"labels": [{"key": "team"}]},
    },
}


def _pod(name, labels, uid):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default",
                         "uid": uid, "labels": dict(labels)}}


def _cluster(P, n_pods=24):
    kube = P.kube.FakeKube()
    kube.register_kind(("", "v1", "Namespace"), namespaced=False)
    kube.register_kind(("", "v1", "Pod"), namespaced=True)
    kube.create({"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": "default", "uid": "ns-u0"}})
    for i in range(n_pods):
        kube.create(_pod(f"p-{i}", {"team": "core"}, f"u{i}"))
    return kube


def _streaming_manager(P, kube, window_s=0.02, leader_check=None):
    client = P.Backend(P.driver()).new_client([P.Target()])
    client.add_template(P.workload.REQUIRED_LABELS_TEMPLATE)
    client.add_constraint(TEAM_CONSTRAINT)
    kube.apply(dict(TEAM_CONSTRAINT))
    mgr = P.audit.AuditManager(kube, client, incremental=True,
                               interval=3600, stream_audit=True,
                               stream_window_s=window_s,
                               leader_check=leader_check)
    return client, mgr


def _start_armed(mgr, timeout=10.0):
    """Start the manager and wait until the stream loop has armed the
    tracker's event hooks and, on a leader, until the interval loop's
    first sweep (it sweeps at once as it starts) has returned. A case's
    first event then goes to a stream flush: on a loaded host that sweep
    could otherwise drain the event itself (the flush then finds nothing
    pending and never reports), publish over a status the case wrote, or
    count as a sweep the case did not expect."""
    swept = threading.Event()
    sweep = mgr.audit_once

    def first_sweep():
        try:
            return sweep()
        finally:
            del mgr.audit_once  # later sweeps are the manager's own
            swept.set()

    leader = mgr.leader_check is None or mgr.leader_check()
    if leader:
        mgr.audit_once = first_sweep
    mgr.start()
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        tr = mgr.tracker
        if tr is not None and tr.track_event_times \
                and tr.on_event is not None:
            break
        time.sleep(0.01)
    else:
        raise AssertionError("stream loop never armed the tracker")
    if leader and not swept.wait(timeout):
        raise AssertionError("the manager's first sweep never returned")


def _counter(P, name: str) -> float:
    m = re.search(rf"^{re.escape(name)} ([0-9.e+-]+)$",
                  P.metrics.REGISTRY.render(), re.M)
    return float(m.group(1)) if m else 0.0


def _flush_collector(mgr):
    out, cv = [], threading.Condition()

    def on_flush(lat, writes):
        with cv:
            out.append((list(lat), dict(writes)))
            cv.notify_all()

    mgr.on_flush = on_flush

    def wait(n=1, timeout=10.0):
        with cv:
            cv.wait_for(lambda: len(out) >= n, timeout=timeout)
            return list(out)

    return wait


def _status(kube) -> dict:
    return statuses(kube, [CONSTRAINT_GVK])


def case_churn_detected_under_window_budget(P):
    """:125: a watch event reaches the constraint's status through a
    stream flush, not an interval sweep."""
    kube = _cluster(P)
    _client, mgr = _streaming_manager(P, kube, window_s=0.02)
    mgr.audit_once()
    assert mgr.audit_once() is not None
    wait = _flush_collector(mgr)
    base = _counter(P, "gatekeeper_tpu_violation_detection_seconds_count")
    _start_armed(mgr)
    try:
        sweeps_before = mgr._sweeps
        t_apply = time.monotonic()
        kube.apply(_pod("p-3", {}, "u3"))  # drop team -> NEW violation
        flushes = wait(1)
        t_flushed = time.monotonic()
        assert flushes, "no stream flush within timeout"
        lat, writes = flushes[0]
        assert lat and max(lat) <= (t_flushed - t_apply) + 0.5
        assert mgr._sweeps == sweeps_before  # no interval sweep ran
        assert writes["status_writes"] >= 1
        stored = kube.get(CONSTRAINT_GVK, "pods-need-team")
        assert any(v["name"] == "p-3"
                   for v in stored["status"]["violations"])
        assert stored["status"]["totalViolations"] == 1
        detected = _counter(
            P, "gatekeeper_tpu_violation_detection_seconds_count") - base
        assert detected >= 1
        assert mgr.stream_stats["flushes"] >= 1
        assert mgr.stream_stats["errors"] == 0
    finally:
        mgr.stop()
    return [len(lat), writes, _status(kube), mgr._sweeps - sweeps_before]


def case_healthy_churn_confirms_noop_without_writes(P):
    """:167."""
    kube = _cluster(P)
    _client, mgr = _streaming_manager(P, kube)
    mgr.audit_once()
    mgr.audit_once()
    wait = _flush_collector(mgr)
    _start_armed(mgr)
    try:
        kube.apply(_pod("p-5", {"team": "core", "extra": "x"}, "u5"))
        flushes = wait(1)
        assert flushes
        lat, writes = flushes[0]
        assert lat
        assert writes["status_writes"] == 0
    finally:
        mgr.stop()
    return [len(lat), writes, _status(kube)]


def case_follower_drains_without_status_writes(P):
    """:187."""
    kube = _cluster(P)
    _client, mgr = _streaming_manager(P, kube, leader_check=lambda: False)
    mgr.leader_check = None
    mgr.audit_once()
    mgr.leader_check = lambda: False
    _start_armed(mgr)
    try:
        before = kube.get(CONSTRAINT_GVK, "pods-need-team")
        kube.apply(_pod("p-7", {}, "u7"))
        t0 = time.monotonic()
        while mgr.stream_stats["skipped"] == 0 \
                and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        assert mgr.stream_stats["skipped"] >= 1
        assert mgr.tracker.pending_count() == 0
        after = kube.get(CONSTRAINT_GVK, "pods-need-team")
        assert after.get("status") == before.get("status")
    finally:
        mgr.stop()
    return [mgr.stream_stats["errors"], mgr.tracker.pending_count(),
            _status(kube)]


def case_backstop_sweep_repairs_and_reports_drift(P):
    """:212: a status clobbered behind the manager's back is drift the
    interval sweep repairs and counts."""
    kube = _cluster(P)
    _client, mgr = _streaming_manager(P, kube)
    mgr.audit_once()
    kube.apply(_pod("p-2", {}, "u2"))  # one standing violation
    mgr.audit_once()
    _flush_collector(mgr)
    _start_armed(mgr)
    try:
        stored = kube.get(CONSTRAINT_GVK, "pods-need-team")
        clobbered = copy.deepcopy(stored)
        clobbered["status"]["violations"] = []
        clobbered["status"]["totalViolations"] = 0
        kube.apply(clobbered)
        drift0 = _counter(P, "gatekeeper_tpu_audit_backstop_drift_total")
        mgr.audit_once()  # the reconciliation backstop
        drift = _counter(P, "gatekeeper_tpu_audit_backstop_drift_total") \
            - drift0
        stored = kube.get(CONSTRAINT_GVK, "pods-need-team")
        assert any(v["name"] == "p-2"
                   for v in stored["status"]["violations"])
        assert drift >= 1
    finally:
        mgr.stop()
    return [drift, mgr.last_sweep_stats["sweep"], _status(kube)]


def case_stream_flush_error_is_counted_and_backstop_recovers(P):
    """:241."""
    kube = _cluster(P)
    client, mgr = _streaming_manager(P, kube)
    mgr.audit_once()
    mgr.audit_once()
    _start_armed(mgr)
    try:
        real_audit = client.audit
        client.audit = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected eval failure"))
        kube.apply(_pod("p-9", {}, "u9"))
        t0 = time.monotonic()
        while mgr.stream_stats["errors"] == 0 \
                and time.monotonic() - t0 < 10:
            time.sleep(0.01)
        errors = mgr.stream_stats["errors"]
        assert errors >= 1
        client.audit = real_audit
        mgr.audit_once()  # backstop reconciles what the flush missed
        stored = kube.get(CONSTRAINT_GVK, "pods-need-team")
        assert any(v["name"] == "p-9"
                   for v in stored["status"]["violations"])
    finally:
        mgr.stop()
    return [errors >= 1, _status(kube)]


def case_stream_flush_lists_only_changed_kinds(P):
    """:266: a no-op flush lists no constraint kind; a real change
    lists only the kind whose violation set moved."""
    kube = _cluster(P)
    client, mgr = _streaming_manager(P, kube)
    other = copy.deepcopy(P.workload.REQUIRED_LABELS_TEMPLATE)
    other["spec"]["crd"]["spec"]["names"]["kind"] = "K8sOtherLabels"
    other["metadata"]["name"] = "k8sotherlabels"
    client.add_template(other)
    wait = _flush_collector(mgr)
    _start_armed(mgr)
    orig = kube.list
    try:
        mgr.audit_once()  # establishes the fingerprint baseline
        lists = []

        def spy(gvk, *a, **k):
            if gvk[0] == "constraints.gatekeeper.sh":
                lists.append(gvk[2])
            return orig(gvk, *a, **k)

        kube.list = spy
        kube.apply(_pod("p-0", {"team": "core", "extra": "1"}, "u0"))
        wait(1)
        assert lists == [], lists
        kube.apply(_pod("p-bad", {}, "u-bad"))
        wait(2)
        assert set(lists) == {"K8sRequiredLabels"}, lists
        stored = kube.get(CONSTRAINT_GVK, "pods-need-team")
        assert any(v["name"] == "p-bad"
                   for v in stored["status"]["violations"])
    finally:
        kube.list = orig
        mgr.stop()
    return [sorted(set(lists)), _status(kube)]


def case_stream_flush_leaves_a_total_past_the_cap_stale(P):
    """Both packages: a flush lists and writes only the kinds whose
    capped status entries moved (`_stream_flush` fingerprints the
    entries, not totalViolations), so a violation that lands past a
    constraint's first `limit` leaves the published total stale until
    an interval sweep rewrites it. Driven without threads: each flush is
    a direct `_stream_flush()` call."""
    kube = _cluster(P)
    client = P.Backend(P.driver()).new_client([P.Target()])
    client.add_template(P.workload.REQUIRED_LABELS_TEMPLATE)
    client.add_constraint(TEAM_CONSTRAINT)
    kube.apply(dict(TEAM_CONSTRAINT))
    for i in range(3):
        kube.apply(_pod(f"a-{i}", {}, f"ua{i}"))
    mgr = P.audit.AuditManager(kube, client, incremental=True,
                               interval=3600, stream_audit=True,
                               constraint_violations_limit=2)
    mgr.audit_once()
    mgr.audit_once()
    published = kube.get(CONSTRAINT_GVK, "pods-need-team")["status"]
    kube.apply(_pod("z-9", {}, "uz9"))  # sorts after the first 2
    mgr._stream_flush()
    flushed = len(mgr.last_results)
    stale = kube.get(CONSTRAINT_GVK, "pods-need-team")["status"]
    mgr.audit_once()  # the interval sweep repairs the total
    repaired = kube.get(CONSTRAINT_GVK, "pods-need-team")["status"]
    mgr.stop()
    assert published["totalViolations"] == 3 and flushed == 4
    assert stale["totalViolations"] == 3
    assert stale["violations"] == repaired["violations"]
    assert repaired["totalViolations"] == 4
    return [flushed, mgr.stream_stats["flushes"], _status(kube),
            [v["name"] for v in stale["violations"]]]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_streaming_case_equal(case):
    got, want = both(case)
    assert got == want


# -------------------------------------------- enforcementAction parity

def _admission_review(obj):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": "u-1",
                        "kind": {"group": "", "version": "v1",
                                 "kind": obj["kind"]},
                        "operation": "CREATE",
                        "name": obj["metadata"]["name"],
                        "namespace": obj["metadata"].get("namespace"),
                        "object": obj}}


def _action_client(P, actions):
    client = P.Backend(P.driver()).new_client([P.Target()])
    client.add_template(P.workload.REQUIRED_LABELS_TEMPLATE)
    for i, action in enumerate(actions):
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sRequiredLabels",
            "metadata": {"name": f"labels-{action}-{i}"},
            "spec": {"enforcementAction": action,
                     "match": {"kinds": [{"apiGroups": [""],
                                          "kinds": ["Pod"]}]},
                     "parameters": {"labels": [{"key": action}]}},
        })
    return client


def _handler(P, client):
    return P.webhook.ValidationHandler(
        client, batcher=P.webhook.MicroBatcher(client))


def case_enforcement_action_parity(P, action, allowed, warned):
    """:573."""
    handler = _handler(P, _action_client(P, [action]))
    try:
        resp = handler.handle(_admission_review(
            _pod("p-x", {}, "uid-x")))["response"]
    finally:
        handler.batcher.stop()
    assert resp["allowed"] is allowed
    if warned:
        assert resp["warnings"] and "warn" in resp["warnings"][0]
    else:
        assert "warnings" not in resp
    return resp


@pytest.mark.parametrize("action,allowed,warned", [
    ("deny", False, False),
    ("dryrun", True, False),
    ("warn", True, True),
])
def test_enforcement_action_parity(action, allowed, warned):
    got, want = both(case_enforcement_action_parity, action, allowed,
                     warned)
    assert got == want


def case_warn_rides_alongside_deny_and_dryrun(P):
    """:587."""
    handler = _handler(P, _action_client(P, ["deny", "dryrun", "warn"]))
    try:
        resp = handler.handle(_admission_review(
            _pod("p-y", {}, "uid-y")))["response"]
        ok = handler.handle(_admission_review(
            _pod("p-z", {"deny": "1", "warn": "1"}, "uid-z")))["response"]
    finally:
        handler.batcher.stop()
    assert resp["allowed"] is False
    assert len(resp["warnings"]) == 1
    assert "warn" in resp["warnings"][0]
    assert "dryrun" not in resp["status"]["reason"]
    assert ok["allowed"] is True
    assert "warnings" not in ok
    return [resp, ok]


def test_warn_rides_alongside_deny_and_dryrun():
    got, want = both(case_warn_rides_alongside_deny_and_dryrun)
    assert got == want
