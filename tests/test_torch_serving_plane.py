"""Admission serving plane: pre-fork frontends over the shared batching
backplane, the generation-keyed decision cache, and the HTTP hot-path
overhaul. The port's copy of tests/test_serving_plane.py (its Runtimes
on --device cpu, their engine children gatekeeper_tpu_torch processes
on the CPU), then the port against the JAX package: both Runtimes'
/v1/admit bodies through the frontends with --admission-workers 2 and
with --admission-engines 2, the engine-kill burst's transcript, and the
replication and full-sync ops.

Covers:
  * HTTP/1.1 keep-alive regression — two requests MUST reuse one
    connection (the server answered HTTP/1.0 before the fix);
  * `?timeout=` query hardening — duplicates, percent-encoding, bare
    keys, junk;
  * envelope fast-path encoding equivalence with the full encoder;
  * decision cache: hits across uid churn, generation invalidation on
    constraint updates, namespace-label invalidation, --log-denies
    deny re-evaluation;
  * backplane frame round-trip, deadline propagation, unreachable-
    engine failure stance (both stances + the `backplane.engine` fault
    point), frontend respawn, and the full Runtime smoke the CI
    `serving` job boots.

Every test runs under a hard SIGALRM timeout: a wedged socket must fail
that test fast, not eat the CI budget.
"""

from __future__ import annotations

import http.client
import json
import signal
import threading
import time

import pytest

from gatekeeper_tpu_torch.client import Backend, RegoDriver
from gatekeeper_tpu_torch.control.backplane import (
    BackplaneClient,
    BackplaneEngine,
    BackplaneError,
    FrontendServer,
    default_socket_path,
)
from gatekeeper_tpu_torch.control.webhook import (
    DecisionCache,
    MicroBatcher,
    NamespaceLabelHandler,
    ValidationHandler,
    WebhookServer,
    encode_envelope,
    parse_timeout_query,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget
from gatekeeper_tpu_torch.utils.faults import FAULTS

TARGET = "admission.k8s.gatekeeper.sh"
PER_TEST_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _hard_timeout_and_clean_faults():
    def boom(signum, frame):  # pragma: no cover - only on a real hang
        raise TimeoutError(
            f"test exceeded the {PER_TEST_TIMEOUT_S}s hard timeout")

    old = signal.signal(signal.SIGALRM, boom)
    signal.alarm(PER_TEST_TIMEOUT_S)
    FAULTS.reset()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        FAULTS.reset()


def _policy_client():
    client = Backend(RegoDriver()).new_client([K8sValidationTarget()])
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
    return client


def _need_owner_constraint(name="need-owner"):
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sNeedOwner", "metadata": {"name": name},
            "spec": {}}


def _review(name, labels=None, uid=None, timeout_s=None):
    obj = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": "d"}}
    if labels:
        obj["metadata"]["labels"] = labels
    request = {"uid": uid or f"uid-{name}", "operation": "CREATE",
               "kind": {"group": "", "version": "v1", "kind": "Pod"},
               "name": name, "namespace": "d",
               "userInfo": {"username": "plane"}, "object": obj}
    if timeout_s is not None:
        request["timeoutSeconds"] = timeout_s
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": request}


def _post(conn, path, review):
    conn.request("POST", path, json.dumps(review),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp, json.loads(resp.read())


# --------------------------------------------------- satellite: keep-alive


def test_keepalive_two_requests_reuse_one_connection():
    """Regression: the Handler must answer HTTP/1.1 — as HTTP/1.0 the
    server closes after every response despite its keep-alive comments,
    doubling connection + thread churn on the API server hot path."""
    server = WebhookServer(None, NamespaceLabelHandler(()), port=0)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        review = {"apiVersion": "admission.k8s.io/v1",
                  "kind": "AdmissionReview",
                  "request": {"uid": "ka-1", "object": {
                      "metadata": {"name": "ns1"}}}}
        resp, out = _post(conn, "/v1/admitlabel", review)
        assert resp.version == 11, "server must answer HTTP/1.1"
        assert not resp.will_close, "server closed a keep-alive connection"
        sock_before = conn.sock
        assert sock_before is not None
        resp, out = _post(conn, "/v1/admitlabel", review)
        assert out["response"]["uid"] == "ka-1"
        assert conn.sock is sock_before, \
            "second request did not reuse the connection"
    finally:
        server.stop(drain_timeout=1.0)


# ---------------------------------------------- satellite: ?timeout= query


def test_parse_timeout_query_tolerates_the_wild():
    assert parse_timeout_query("timeout=5s") == 5.0
    # duplicates: first parseable wins
    assert parse_timeout_query("timeout=5s&timeout=10s") == 5.0
    assert parse_timeout_query("timeout=&timeout=3s") == 3.0
    # percent-encoding decodes ('1m10s' with encoded 'm'; encoded '.')
    assert parse_timeout_query("timeout=1%6D10s") == 70.0
    assert parse_timeout_query("timeout=2%2E5") == 2.5
    # bare keys / junk / absence never raise
    assert parse_timeout_query("timeout") is None
    assert parse_timeout_query("&&=&timeout&x") is None
    assert parse_timeout_query("") is None
    assert parse_timeout_query("a=b&c") is None
    assert parse_timeout_query("timeout=bogus") is None
    # zero/negative budgets are not budgets
    assert parse_timeout_query("timeout=0s") is None


def test_http_timeout_query_reaches_the_deadline(monkeypatch):
    """End-to-end: a duplicate + percent-encoded query string still
    lands in request.timeoutSeconds through the real HTTP server."""
    seen = {}

    class Probe:
        batcher = MicroBatcher(None, evaluate=lambda reviews:
                               [[] for _ in reviews])

        def handle(self, review):
            seen["timeout"] = review["request"].get("timeoutSeconds")
            return {"apiVersion": review.get("apiVersion"),
                    "kind": review.get("kind"),
                    "response": {"uid": "p", "allowed": True}}

    server = WebhookServer(Probe(), None, port=0)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        _post(conn, "/v1/admit?timeout=7%73&timeout=30s",
              _review("q1"))
        assert seen["timeout"] == 7.0
    finally:
        server.stop(drain_timeout=1.0)


# ------------------------------------------------- envelope fast encoding


def test_encode_envelope_matches_full_encoder():
    cases = [
        {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
         "response": {"uid": "5f0e-11:d.x_Y", "allowed": True}},
        {"apiVersion": "admission.k8s.io/v1beta1",
         "kind": "AdmissionReview",
         "response": {"uid": "u", "allowed": False,
                      "status": {"code": 403, "reason": 'msg "quoted" \\'}}},
        # exotic uid must take the fallback, not break JSON
        {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
         "response": {"uid": 'u"\n', "allowed": True}},
        # extra keys (patch) take the fallback
        {"apiVersion": None, "kind": None,
         "response": {"uid": "u", "allowed": True, "patchType": "JSONPatch",
                      "patch": "W10="}},
    ]
    for env in cases:
        assert json.loads(encode_envelope(env)) == env


# ------------------------------------------------------- decision cache


def test_decision_cache_hits_across_uid_churn():
    client = _policy_client()
    client.add_constraint(_need_owner_constraint())
    handler = ValidationHandler(client, kube=None,
                                batcher=MicroBatcher(client,
                                                     max_wait=0.001))
    out1 = handler.handle(_review("p1", {"owner": "me"}, uid="u-1"))
    out2 = handler.handle(_review("p1", {"owner": "me"}, uid="u-2"))
    assert out1["response"]["allowed"] and out2["response"]["allowed"]
    # same object, different uid: one evaluation, one hit — and each
    # response carries ITS OWN uid
    assert handler.cache.hits == 1
    assert out1["response"]["uid"] == "u-1"
    assert out2["response"]["uid"] == "u-2"
    # a denied object caches too (no --log-denies here)
    handler.handle(_review("bad", None, uid="u-3"))
    out = handler.handle(_review("bad", None, uid="u-4"))
    assert out["response"]["allowed"] is False
    assert handler.cache.hits == 2
    handler.batcher.stop()


def test_decision_cache_invalidated_by_constraint_update():
    """The acceptance case: a cached ALLOW must flip to DENY after a
    constraint lands and bumps the library generation."""
    client = _policy_client()  # template only: no constraint yet
    handler = ValidationHandler(client, kube=None,
                                batcher=MicroBatcher(client,
                                                     max_wait=0.001))
    out = handler.handle(_review("pod-a", None, uid="u-1"))
    assert out["response"]["allowed"] is True
    # cached: an identical retry is served without evaluation
    out = handler.handle(_review("pod-a", None, uid="u-2"))
    assert handler.cache.hits == 1
    gen_before = client.generation
    client.add_constraint(_need_owner_constraint())
    assert client.generation > gen_before
    out = handler.handle(_review("pod-a", None, uid="u-3"))
    assert out["response"]["allowed"] is False, \
        "stale cached allow served after a constraint update"
    # and removing the constraint flips it back (another bump)
    client.remove_constraint(_need_owner_constraint())
    out = handler.handle(_review("pod-a", None, uid="u-4"))
    assert out["response"]["allowed"] is True
    handler.batcher.stop()


def test_decision_cache_ns_label_key():
    ns = {"metadata": {"name": "d", "labels": {"env": "prod"}}}
    ns2 = {"metadata": {"name": "d", "labels": {"env": "dev"}}}
    assert DecisionCache.ns_key(ns) != DecisionCache.ns_key(ns2)
    # the WHOLE namespace object keys the cache: policies can match on
    # annotations (or anything else the sideload carries), not labels
    # alone
    ns3 = {"metadata": {"name": "d", "labels": {"env": "prod"},
                        "annotations": {"owner": "x"}}}
    assert DecisionCache.ns_key(ns) != DecisionCache.ns_key(ns3)
    assert DecisionCache.ns_key(None) == b""
    # uid and timeoutSeconds are noise; object content is signal
    r = _review("x", {"owner": "me"})["request"]
    r2 = dict(r, uid="other", timeoutSeconds=3)
    assert DecisionCache.request_key(r) == DecisionCache.request_key(r2)
    r3 = _review("x", {"owner": "you"})["request"]
    assert DecisionCache.request_key(r) != DecisionCache.request_key(r3)


def test_decision_cache_log_denies_reevaluates_denials():
    """--log-denies: every denial must re-evaluate (and so re-log);
    allows still serve from the cache."""
    client = _policy_client()
    client.add_constraint(_need_owner_constraint())
    handler = ValidationHandler(client, kube=None, log_denies=True,
                                batcher=MicroBatcher(client,
                                                     max_wait=0.001))
    for uid in ("a", "b"):
        out = handler.handle(_review("bad", None, uid=uid))
        assert out["response"]["allowed"] is False
    assert handler.cache.hits == 0  # denials never hit under log_denies
    for uid in ("c", "d"):
        handler.handle(_review("ok", {"owner": "me"}, uid=uid))
    assert handler.cache.hits == 1  # allows still do
    handler.batcher.stop()


def test_decision_cache_lru_bound():
    cache = DecisionCache(size=4)
    for i in range(10):
        cache.put((bytes([i]), 0, 0), {"allowed": True})
    assert len(cache) == 4


# ------------------------------------------------------ backplane plumbing


def _plane(validation=None, ns_label=None, mutation=None,
           fail_closed=False):
    sock = default_socket_path() + ".t"
    engine = BackplaneEngine(sock, validation=validation,
                             ns_label=ns_label, mutation=mutation)
    engine.start()
    client = BackplaneClient(sock, worker_id="test")
    frontend = FrontendServer(client, port=0, addr="127.0.0.1",
                              fail_closed=fail_closed)
    frontend.start()
    return engine, client, frontend


def test_backplane_roundtrip_and_404():
    client = _policy_client()
    client.add_constraint(_need_owner_constraint())
    validation = ValidationHandler(
        client, kube=None, batcher=MicroBatcher(client, max_wait=0.001))
    engine, bc, fe = _plane(validation=validation,
                            ns_label=NamespaceLabelHandler(()))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                          timeout=10)
        _, out = _post(conn, "/v1/admit?timeout=5s",
                       _review("ok", {"owner": "me"}))
        assert out["response"]["allowed"] is True
        _, out = _post(conn, "/v1/admit", _review("bad"))
        assert out["response"]["allowed"] is False
        assert "no owner label" in out["response"]["status"]["reason"]
        _, out = _post(conn, "/v1/admitlabel", _review("ns"))
        assert out["response"]["allowed"] is True
        # mutation is NOT served by this plane: 404 locally, no hop
        conn.request("POST", "/v1/mutate", json.dumps(_review("m")),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404
    finally:
        fe.stop(drain_timeout=1.0)
        engine.stop(drain_timeout=1.0)


def test_backplane_deadline_propagates_to_engine():
    """A 1s ?timeout= rides the frame: the engine answers per the
    failure stance BEFORE the budget expires, even when evaluation
    stalls far longer."""
    stall = threading.Event()

    def evaluate(reviews):
        stall.wait(10.0)
        return [[] for _ in reviews]

    batcher = MicroBatcher(None, max_wait=0.001, evaluate=evaluate)
    validation = ValidationHandler(_policy_client(), kube=None,
                                   batcher=batcher)
    engine, bc, fe = _plane(validation=validation)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                          timeout=10)
        t0 = time.monotonic()
        _, out = _post(conn, "/v1/admit?timeout=1s", _review("slow"))
        elapsed = time.monotonic() - t0
        assert elapsed < 2.0, "verdict landed after the 1s budget"
        assert out["response"]["allowed"] is True  # fail-open
        assert out["response"]["status"]["code"] == 504
    finally:
        stall.set()
        fe.stop(drain_timeout=1.0)
        engine.stop(drain_timeout=1.0)


@pytest.mark.parametrize("fail_closed", [False, True])
def test_engine_unreachable_answers_per_stance(fail_closed):
    bc = BackplaneClient(default_socket_path() + ".gone")
    fe = FrontendServer(bc, port=0, addr="127.0.0.1",
                        fail_closed=fail_closed)
    fe.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                          timeout=10)
        resp, out = _post(conn, "/v1/admit", _review("x", uid="want-uid"))
        assert resp.status == 200
        assert out["response"]["allowed"] is (not fail_closed)
        assert out["response"]["status"]["code"] == 503
        # uid recovered by the lazy parse so the API server can match
        # the response to its request
        assert out["response"]["uid"] == "want-uid"
    finally:
        fe.stop(drain_timeout=1.0)


def test_backplane_engine_fault_point():
    """Arming backplane.engine makes a HEALTHY plane answer per the
    stance (chaos hook); disarming restores real verdicts."""
    client = _policy_client()
    client.add_constraint(_need_owner_constraint())
    validation = ValidationHandler(
        client, kube=None, batcher=MicroBatcher(client, max_wait=0.001))
    engine, bc, fe = _plane(validation=validation)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                          timeout=10)
        FAULTS.inject("backplane.engine", mode="error")
        _, out = _post(conn, "/v1/admit", _review("bad"))
        assert out["response"]["allowed"] is True  # stance, not verdict
        assert out["response"]["status"]["code"] == 503
        assert FAULTS.fired("backplane.engine") == 1
        FAULTS.clear("backplane.engine")
        _, out = _post(conn, "/v1/admit", _review("bad2"))
        assert out["response"]["allowed"] is False  # real verdict again
    finally:
        fe.stop(drain_timeout=1.0)
        engine.stop(drain_timeout=1.0)


def test_backplane_client_hello_failure_does_not_deadlock(monkeypatch,
                                                          tmp_path):
    """An engine that dies between connect() and the hello send (the
    chaos suite's SIGKILL window) sends _ensure_connected into _drop()
    from inside its own _conn_lock critical section. With a
    non-reentrant lock that self-deadlocks — and every HTTP thread of
    the frontend then wedges behind the lock, hanging callers into
    their client-side timeouts instead of stance answers."""
    import socket as sk

    from gatekeeper_tpu_torch.control import backplane as bp

    path = str(tmp_path / "hello.sock")
    srv = sk.socket(sk.AF_UNIX, sk.SOCK_STREAM)
    srv.bind(path)
    srv.listen(2)
    try:
        cl = bp.BackplaneClient(path, worker_id="t")
        monkeypatch.setattr(
            bp, "_send_frame",
            lambda *a, **k: (_ for _ in ()).throw(
                OSError("peer died before hello")))
        res: list = []

        def attempt():
            try:
                cl._ensure_connected()
                res.append("connected")
            except bp.BackplaneError:
                res.append("error")

        t1 = threading.Thread(target=attempt, daemon=True)
        t1.start()
        t1.join(5)
        assert res == ["error"], \
            "hello-failure path hung instead of raising"
        # the lock must be free again: a retry takes the same path
        t2 = threading.Thread(target=attempt, daemon=True)
        t2.start()
        t2.join(5)
        assert res == ["error", "error"], \
            "connection lock was left held after the hello failure"
        cl.close()
    finally:
        srv.close()


def test_frontend_forward_stats_reach_engine_metrics():
    from gatekeeper_tpu_torch.control import metrics as gm

    client = _policy_client()
    validation = ValidationHandler(
        client, kube=None, batcher=MicroBatcher(client, max_wait=0.001))
    engine, bc, fe = _plane(validation=validation)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                          timeout=10)
        for i in range(3):
            _post(conn, "/v1/admit", _review(f"s{i}", {"owner": "x"}))
        stats = fe.stats.drain("test")
        assert stats is not None and stats["count"] == 3
        bc.send_stats(stats)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            text = gm.REGISTRY.render()
            if "gatekeeper_tpu_backplane_forward_duration_seconds_count" \
                    in text and 'worker="test"' in text:
                break
            time.sleep(0.05)
        assert 'worker="test"' in gm.REGISTRY.render()
    finally:
        fe.stop(drain_timeout=1.0)
        engine.stop(drain_timeout=1.0)


# ------------------------------------------------- full runtime (CI smoke)


def test_serving_plane_runtime_smoke():
    """What the CI `serving` job boots: a Runtime with 2 pre-forked
    frontend processes + the engine, round-tripping admit / mutate /
    admitlabel through real subprocesses, then draining cleanly."""
    from gatekeeper_tpu_torch.control.main import Runtime, build_parser

    args = build_parser().parse_args([
        "--device", "cpu",
        "--fake-kube", "--port", "0", "--prometheus-port", "0",
        "--disable-cert-rotation", "--health-addr", ":0",
        "--operation", "webhook", "--operation", "mutation-webhook",
        "--admission-workers", "2"])
    rt = Runtime(args)
    rt.args.metrics_backend = "none"
    rt.start()
    try:
        assert rt.webhook is None and rt.backplane is not None
        deadline = time.monotonic() + 10
        while rt.backplane.connected < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert rt.backplane.connected == 2
        assert rt.frontends.alive()
        conn = http.client.HTTPConnection("127.0.0.1", rt.frontends.port,
                                          timeout=15)
        for path in ("/v1/admit", "/v1/admitlabel", "/v1/mutate"):
            _, out = _post(conn, path + "?timeout=10s", _review("rt"))
            assert out["response"]["allowed"] is True, path
            assert out["response"]["uid"] == "uid-rt"
    finally:
        rt.stop()
    assert not rt.frontends.alive()


def test_supervisor_respawns_dead_frontend():
    from gatekeeper_tpu_torch.control.main import Runtime, build_parser

    args = build_parser().parse_args([
        "--device", "cpu",
        "--fake-kube", "--port", "0", "--prometheus-port", "0",
        "--disable-cert-rotation", "--health-addr", ":0",
        "--operation", "webhook", "--admission-workers", "2"])
    rt = Runtime(args)
    rt.args.metrics_backend = "none"
    rt.start()
    try:
        victim = rt.frontends._procs[0]
        victim.kill()
        victim.wait(10)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if rt.frontends.alive() and \
                    rt.frontends._procs[0] is not victim:
                break
            time.sleep(0.1)
        assert rt.frontends.alive(), "supervisor did not respawn"
        # the respawned worker serves
        conn = http.client.HTTPConnection("127.0.0.1", rt.frontends.port,
                                          timeout=15)
        for i in range(4):  # hit both workers' accept queues
            _, out = _post(conn, "/v1/admit", _review(f"r{i}"))
            assert out["response"]["allowed"] is True
            conn.close()
    finally:
        rt.stop()


# --------------------------------------------------- N-engine plane


def test_registry_snapshot_merge_delta_and_restart_reset():
    """The M-frame stats relay: an engine child's totals merge into the
    primary as deltas, and a restarted engine (totals reset to zero)
    contributes its new counts instead of a negative rewind."""
    from gatekeeper_tpu_torch.control.metrics import Registry

    src = Registry()
    dst = Registry()
    names = ("request_count", "request_duration_seconds")
    src.counter_add("request_count", "h", 3, admission_status="allowed")
    src.observe("request_duration_seconds", "h", 0.02,
                admission_status="allowed")
    snap1 = src.snapshot(names)
    dst.merge_snapshot_delta(snap1, None)
    src.counter_add("request_count", "h", 2, admission_status="allowed")
    src.observe("request_duration_seconds", "h", 0.04,
                admission_status="allowed")
    snap2 = src.snapshot(names)
    dst.merge_snapshot_delta(snap2, snap1)
    text = dst.render()
    assert 'request_count{admission_status="allowed"} 5' in text
    assert ('request_duration_seconds_count'
            '{admission_status="allowed"} 2') in text
    # engine restart: a fresh process's totals are all new work
    fresh = Registry()
    fresh.counter_add("request_count", "h", 4,
                      admission_status="allowed")
    dst.merge_snapshot_delta(fresh.snapshot(names), snap2)
    assert 'request_count{admission_status="allowed"} 9' in dst.render()


def test_router_least_load_and_failover_on_engine_death():
    """BackplaneRouter over two engines: calls succeed, and after one
    engine drops dead mid-plane the router fails over — every later
    call still gets a REAL verdict from the survivor, no stance
    answers."""
    from gatekeeper_tpu_torch.control.backplane import BackplaneRouter

    def build(tag):
        client = _policy_client()
        client.add_constraint(_need_owner_constraint())
        validation = ValidationHandler(
            client, kube=None,
            batcher=MicroBatcher(client, max_wait=0.001))
        sock = default_socket_path() + tag
        engine = BackplaneEngine(sock, validation=validation,
                                 ns_label=NamespaceLabelHandler(()))
        engine.start()
        return engine, sock

    e1, s1 = build(".r1")
    e2, s2 = build(".r2")
    router = BackplaneRouter([s1, s2], worker_id="rt")
    try:
        deadline = time.monotonic() + 5
        for i in range(8):
            body = json.dumps(_review(f"a{i}", {"owner": "me"})).encode()
            status, payload = router.call("/v1/admit", body, 5.0,
                                          time.monotonic() + 5)
            assert status == 200
            assert json.loads(payload)["response"]["allowed"] is True
        e1.abort()  # chaos: engine 1 dies with the plane live
        for i in range(8):
            body = json.dumps(_review(f"b{i}")).encode()
            status, payload = router.call("/v1/admit", body, 5.0,
                                          time.monotonic() + 5)
            assert status == 200
            out = json.loads(payload)["response"]
            assert out["allowed"] is False, "survivor must evaluate"
            assert "no owner label" in out["status"]["reason"]
    finally:
        router.close()
        e1.abort()
        e2.stop(drain_timeout=1.0)


def test_library_replication_ops_and_full_sync():
    """L frames: a replica engine's LibrarySink applies incremental ops
    (bumping ITS client's generation) and a full sync reconciles —
    replaying the snapshot and dropping templates/constraints the
    primary no longer carries."""
    from gatekeeper_tpu_torch.control.engine import LibrarySink

    replica = Backend(RegoDriver()).new_client([K8sValidationTarget()])
    sink = LibrarySink(replica)
    sock = default_socket_path() + ".lib"
    engine = BackplaneEngine(sock, library_sink=sink)
    engine.start()
    ctl = BackplaneClient(sock, worker_id="ctl")
    try:
        primary = _policy_client()
        primary.add_constraint(_need_owner_constraint())
        ops = []
        primary.on_change = lambda op, obj: ops.append((op, obj))
        gen0 = replica.generation
        ctl.control({"op": "sync",
                     "library": primary.snapshot_library()})
        assert replica.template_kinds() == ["K8sNeedOwner"]
        assert replica.library_index() == {
            "K8sNeedOwner": ["need-owner"]}
        assert replica.generation > gen0
        # incremental op: primary adds a constraint, the observer fires,
        # the op replicates, the replica's OWN generation bumps
        primary.add_constraint(_need_owner_constraint("second"))
        assert ops and ops[-1][0] == "add_constraint"
        gen1 = replica.generation
        ctl.control({"op": ops[-1][0], "obj": ops[-1][1]})
        assert replica.library_index() == {
            "K8sNeedOwner": ["need-owner", "second"]}
        assert replica.generation > gen1
        # sync reconciliation: the primary dropped a constraint the
        # replica still carries — the sync must remove it
        primary.remove_constraint(_need_owner_constraint("second"))
        ctl.control({"op": "sync",
                     "library": primary.snapshot_library()})
        assert replica.library_index() == {
            "K8sNeedOwner": ["need-owner"]}
        # unknown op is refused, not swallowed
        with pytest.raises(BackplaneError):
            ctl.control({"op": "no-such-op"})
    finally:
        ctl.close()
        engine.stop(drain_timeout=1.0)


def test_multi_engine_runtime_burst_with_engine_kill():
    """The acceptance e2e: a Runtime with --admission-engines 3 (this
    process is engine 0; engines 1 and 2 are spawned children, each
    with its own Client/MicroBatcher/socket) and 2 pre-forked frontends
    routing across all three. An open-loop burst of unique reviews must
    complete with ZERO unanswered admissions while engine 1 is
    SIGKILLed mid-burst; the library replicated to the children must
    produce correct verdicts; the supervisor must respawn the victim
    and resync it."""
    from gatekeeper_tpu_torch.control import metrics as gm
    from gatekeeper_tpu_torch.control.main import Runtime, build_parser

    args = build_parser().parse_args([
        "--device", "cpu",
        "--fake-kube", "--port", "0", "--prometheus-port", "0",
        "--disable-cert-rotation", "--health-addr", ":0",
        "--operation", "webhook", "--admission-workers", "2",
        "--admission-engines", "3"])
    rt = Runtime(args)
    rt.args.metrics_backend = "none"
    rt.start()
    try:
        assert rt.engines is not None
        assert rt.engines.alive_count() == 2
        # library ingested AFTER boot replicates to every engine child
        rt.opa.add_template(_policy_client().get_template("K8sNeedOwner"))
        rt.opa.add_constraint(_need_owner_constraint())
        results: list = []
        res_lock = threading.Lock()
        kill_at = threading.Event()

        def worker(k):
            conn = http.client.HTTPConnection(
                "127.0.0.1", rt.frontends.port, timeout=30)
            mine = []
            for j in range(24):
                name = f"w{k}n{j}"
                labeled = (j % 2 == 0)
                review = _review(name,
                                 {"owner": "me"} if labeled else None)
                try:
                    _, out = _post(conn, "/v1/admit?timeout=15s", review)
                    mine.append((name, labeled,
                                 out["response"]["allowed"],
                                 out["response"]["uid"]))
                except Exception as e:  # an unanswered admission
                    mine.append((name, labeled, f"UNANSWERED: {e}",
                                 None))
                if k == 0 and j == 6:
                    kill_at.set()
            with res_lock:
                results.extend(mine)

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(6)]
        for t in threads:
            t.start()
        kill_at.wait(30)
        rt.engines.kill_engine(1)  # chaos: one engine process dies
        for t in threads:
            t.join(90)
        assert len(results) == 6 * 24
        for name, labeled, allowed, uid in results:
            assert isinstance(allowed, bool), \
                f"unanswered admission {name}: {allowed}"
            assert allowed is labeled, (name, labeled, allowed)
            assert uid == f"uid-{name}"
        # the victim respawns and resyncs
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if rt.engines.alive_count() == 2 and \
                    not rt.engines._dirty.get(1):
                break
            time.sleep(0.2)
        assert rt.engines.alive_count() == 2, "engine not respawned"
        # requests spread across engine processes: the relayed
        # per-engine counters prove the frontends actually routed
        rt.engines.poll_stats()
        text = gm.REGISTRY.render()
        assert 'gatekeeper_tpu_engine_requests_total' in text
        spread = [e for e in ("1", "2")
                  if f'engine="{e}"' in text]
        assert spread, "no requests reached any engine child"
    finally:
        rt.stop()
    assert not rt.frontends.alive()


# ------------------------------------- the port against the JAX package

def _runtime_args(pkg: str, flags: list):
    """A Runtime's flags for one package: the port's on the CPU."""
    if pkg == "torch":
        from gatekeeper_tpu_torch.control.main import build_parser
        flags = ["--device", "cpu"] + flags
    else:
        from gatekeeper_tpu.control.main import build_parser
    return build_parser().parse_args([
        "--fake-kube", "--port", "0", "--prometheus-port", "0",
        "--disable-cert-rotation", "--health-addr", ":0"] + flags)


def _need_owner_library():
    """(the need-owner template, its constraint) as kube objects, the
    ones _policy_client and _need_owner_constraint build; a client of
    either package ingests them."""
    template = {
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
    return template, _need_owner_constraint()


def _plane_bodies(pkg: str, flags: list, reviews: list) -> list:
    """Each review's response body, raw, through one package's Runtime
    (`flags`) and its pre-forked frontends, after the need-owner
    library is added through its client."""
    from importlib import import_module

    main = import_module(
        "gatekeeper_tpu_torch.control.main" if pkg == "torch"
        else "gatekeeper_tpu.control.main")
    rt = main.Runtime(_runtime_args(pkg, flags))
    rt.args.metrics_backend = "none"
    rt.start()
    try:
        template, constraint = _need_owner_library()
        rt.opa.add_template(template)
        rt.opa.add_constraint(constraint)
        conn = http.client.HTTPConnection("127.0.0.1", rt.frontends.port,
                                          timeout=15)
        out = []
        for review in reviews:
            conn.request("POST", "/v1/admit?timeout=10s",
                         json.dumps(review),
                         {"Content-Type": "application/json"})
            out.append(conn.getresponse().read())
        conn.close()
    finally:
        rt.stop()
    assert not rt.frontends.alive()
    return out


@pytest.mark.parametrize("flags", [
    ["--operation", "webhook", "--admission-workers", "2"],
    ["--operation", "webhook", "--admission-workers", "2",
     "--admission-engines", "2"]], ids=["workers", "engines"])
def test_runtime_plane_bodies_equal_the_jax_package(flags):
    """Both packages' Runtime with the same plane flags (the port's on
    --device cpu; with --admission-engines 2 its engine 1 is a port
    child): every /v1/admit body through the frontends is byte-equal."""
    reviews = [_review(f"eq{i}", {"owner": "me"} if i % 2 else None)
               for i in range(12)]
    got = _plane_bodies("torch", flags, reviews)
    want = _plane_bodies("jax", flags, reviews)
    assert got == want
    assert [json.loads(b)["response"]["allowed"] for b in got] == \
        [bool(i % 2) for i in range(12)]


def _burst_with_kill(pkg: str) -> list:
    """The engine-kill burst of test_multi_engine_runtime_burst_with_
    engine_kill through one package's Runtime: per review (name,
    allowed, uid), sorted."""
    from importlib import import_module

    main = import_module(
        "gatekeeper_tpu_torch.control.main" if pkg == "torch"
        else "gatekeeper_tpu.control.main")
    rt = main.Runtime(_runtime_args(pkg, [
        "--operation", "webhook", "--admission-workers", "2",
        "--admission-engines", "3"]))
    rt.args.metrics_backend = "none"
    rt.start()
    results: list = []
    lock = threading.Lock()
    kill_at = threading.Event()
    try:
        template, constraint = _need_owner_library()
        rt.opa.add_template(template)
        rt.opa.add_constraint(constraint)

        def worker(k):
            conn = http.client.HTTPConnection(
                "127.0.0.1", rt.frontends.port, timeout=30)
            mine = []
            for j in range(16):
                name = f"w{k}n{j}"
                review = _review(name, {"owner": "me"} if j % 2 == 0
                                 else None)
                try:
                    _, out = _post(conn, "/v1/admit?timeout=15s", review)
                    mine.append((name, out["response"]["allowed"],
                                 out["response"]["uid"]))
                except Exception as e:
                    mine.append((name, f"UNANSWERED: {e}", None))
                if k == 0 and j == 4:
                    kill_at.set()
            with lock:
                results.extend(mine)

        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        kill_at.wait(30)
        rt.engines.kill_engine(1)
        for t in threads:
            t.join(90)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not (
                rt.engines.alive_count() == 2
                and not rt.engines._dirty.get(1)):
            time.sleep(0.2)
        assert rt.engines.alive_count() == 2
    finally:
        rt.stop()
    return sorted(results)


def test_engine_kill_burst_equal_the_jax_package():
    """Three engines (two children), engine 1 SIGKILLed mid-burst, in
    both packages' Runtime (the port's on --device cpu, its children
    gatekeeper_tpu_torch processes on the CPU): every admission
    answered, and the two transcripts equal."""
    got = _burst_with_kill("torch")
    want = _burst_with_kill("jax")
    assert len(got) == 4 * 16
    assert all(isinstance(allowed, bool) for _n, allowed, _u in got), got
    assert got == want


def _replicated(pkg: str) -> list:
    """Replication ops and full syncs applied to one package's replica
    through its LibrarySink over a BackplaneEngine's L frames: the
    replica's library and verdicts after each step."""
    from importlib import import_module

    pre = "gatekeeper_tpu_torch" if pkg == "torch" else "gatekeeper_tpu"
    client_mod = import_module(f"{pre}.client")
    bp = import_module(f"{pre}.control.backplane")
    engine_mod = import_module(f"{pre}.control.engine")
    target = import_module(f"{pre}.target").K8sValidationTarget
    replica = client_mod.Backend(client_mod.RegoDriver()).new_client(
        [target()])
    sock = bp.default_socket_path() + f".eq-{pkg}"
    engine = bp.BackplaneEngine(
        sock, library_sink=engine_mod.LibrarySink(replica))
    engine.start()
    ctl = bp.BackplaneClient(sock, worker_id="ctl")
    template, constraint = _need_owner_library()
    primary = client_mod.Backend(client_mod.RegoDriver()).new_client(
        [target()])
    primary.add_template(template)
    primary.add_constraint(constraint)
    steps = []

    def state():
        res = replica.review(
            {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": "p", "namespace": "d"}})
        steps.append([replica.library_index(),
                      sorted(r.msg for r in res.results())])

    try:
        ctl.control({"op": "sync", "library": primary.snapshot_library(),
                     "data": None})
        state()
        second = _need_owner_constraint("second")
        ctl.control({"op": "add_constraint", "obj": second})
        ctl.control({"op": "add_data", "obj": {
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": "d"}}})
        state()
        ctl.control({"op": "sync", "library": primary.snapshot_library()})
        state()
        ctl.control({"op": "remove_template", "obj": template})
        state()
    finally:
        ctl.close()
        engine.stop(drain_timeout=1.0)
    return steps


def test_replication_ops_and_full_sync_equal_the_jax_package():
    """The L-frame library ops (incremental add, data, the full sync's
    drop of extras, a template removal) leave each package's replica
    with the same library and the same verdicts."""
    got = _replicated("torch")
    want = _replicated("jax")
    assert got == want
    assert got[1][0] == {"K8sNeedOwner": ["need-owner", "second"]}
    assert got[2][0] == {"K8sNeedOwner": ["need-owner"]}
    assert got[3] == [{}, []]
