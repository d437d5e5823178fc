"""The port's admission webhook against the JAX package's.

The same AdmissionReviews go through both packages' `WebhookServer` (on
port 0, loopback) over HTTP; the response bodies must be byte-equal. The
port serves on `TorchDriver(device="cpu")` (the kernels' plain versions),
the JAX package on `TpuDriver()`, both pinned to their device paths
(`_use_device_for_batch = lambda n: True`). All comparisons are exact.

Also here: the port's copies of the in-process serving-plane cases of
tests/test_serving_plane.py (keep-alive, the `?timeout=` query,
`encode_envelope`, the decision cache), each run through both packages
with equal transcripts, and the namespace-label and mutate endpoints.
"""

from __future__ import annotations

import base64
import http.client
import json
import signal
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

from gatekeeper_tpu import mutation as jmutation
from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.control import kube as jkube
from gatekeeper_tpu.control import webhook as jwebhook
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import mutation as tmutation
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.control import kube as tkube
from gatekeeper_tpu_torch.control import webhook as twebhook
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

from .test_torch_frontend import fixture_objects, library_constraints

TARGET = "admission.k8s.gatekeeper.sh"
PER_TEST_TIMEOUT_S = 120
N_INVENTORY = 200   # corpus objects loaded as inventory (joins fire)
N_REVIEWS = 120     # corpus manifests sent per operation
CLIENTS = 16        # concurrent keep-alive connections per server
BATCH = 16          # the micro-batcher's largest batch

JAX = types.SimpleNamespace(
    name="jax", Backend=JBackend, Target=JTarget, policies=jpol,
    webhook=jwebhook, kube=jkube, mutation=jmutation,
    driver=lambda: TpuDriver())
TORCH = types.SimpleNamespace(
    name="torch", Backend=TBackend, Target=TTarget, policies=tpol,
    webhook=twebhook, kube=tkube, mutation=tmutation,
    driver=lambda: TorchDriver(device="cpu"))


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


# ------------------------------------------------------------ the servers


def _mutators(P) -> "object":
    system = P.mutation.MutationSystem()
    pod = [{"groups": [""], "versions": ["v1"], "kinds": ["Pod"]}]
    system.upsert({
        "apiVersion": "mutations.gatekeeper.sh/v1alpha1", "kind": "Assign",
        "metadata": {"name": "pull"},
        "spec": {"applyTo": pod,
                 "location": "spec.containers[name: *].imagePullPolicy",
                 "parameters": {"assign": {"value": "Always"}}}})
    system.upsert({
        "apiVersion": "mutations.gatekeeper.sh/v1alpha1",
        "kind": "AssignMetadata", "metadata": {"name": "team"},
        "spec": {"location": "metadata.labels.team",
                 "parameters": {"assign": {"value": "platform"}}}})
    system.upsert({
        "apiVersion": "mutations.gatekeeper.sh/v1alpha1",
        "kind": "ModifySet", "metadata": {"name": "tol"},
        "spec": {"applyTo": pod, "location": "spec.tolerations",
                 "match": {"namespaces": ["ns1", "ns2"]},
                 "parameters": {"operation": "merge",
                                "values": {"fromList": [{"key": "gpu"}]}}}})
    return system


def _serve(P):
    """A WebhookServer over the whole shipped library (23 templates and
    their constraints), the corpus as inventory, namespaces ns0-ns9 in a
    FakeKube (ns10 and up are NotFound), the decision cache off so that
    every review is evaluated, and a mutator library."""
    drv = P.driver()
    drv._use_device_for_batch = lambda n: True  # pin the device path
    client = P.Backend(drv).new_client([P.Target()])
    for name in P.policies.names():
        client.add_template(P.policies.load(name))
    for c in library_constraints():
        client.add_constraint(c)
    for o in fixture_objects(N_INVENTORY):
        client.add_data(o)
    # compile each batch-row bucket a device batch can have up front
    # (MIN_DEVICE_BATCH 4 to BATCH; the JAX package compiles one XLA
    # program per shape): a compile inside a request could pass its
    # deadline, and the webhook would answer 504 per its stance
    handler = client.targets[TARGET]
    reviews = [handler.handle_review(o)[1]
               for o in fixture_objects(N_REVIEWS)]
    for k in (4, 8, BATCH):
        drv.review_batch(TARGET, reviews[:k])
    kube = P.kube.FakeKube()
    for i in range(10):
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": f"ns{i}",
                                  "labels": {"env": f"e{i % 3}"}}})
    wh = P.webhook
    validation = wh.ValidationHandler(
        client, kube=kube,
        batcher=wh.MicroBatcher(client, max_wait=0.02, max_batch=BATCH),
        decision_cache_size=0)
    mutation = wh.MutationHandler(_mutators(P), kube=kube)
    server = wh.WebhookServer(validation, wh.NamespaceLabelHandler(
        ("exempt",)), port=0, addr="127.0.0.1", mutation=mutation)
    server.start()
    return types.SimpleNamespace(server=server, driver=drv, client=client)


@pytest.fixture(scope="module")
def servers():
    out = {P.name: _serve(P) for P in (JAX, TORCH)}
    yield out
    for s in out.values():
        s.server.stop(drain_timeout=1.0)


def _post_raw(port: int, path: str, body: bytes,
              conn: http.client.HTTPConnection = None) -> tuple:
    conn = conn or http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, body, {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, resp.read()


def _send_all(port: int, path: str, bodies: list) -> list:
    """(status, body bytes) per request, sent by CLIENTS keep-alive
    connections at once so that the micro-batcher seals real batches."""
    def worker(k):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            return [(i, _post_raw(port, path, bodies[i], conn))
                    for i in range(k, len(bodies), CLIENTS)]
        finally:
            conn.close()

    with ThreadPoolExecutor(CLIENTS) as ex:
        parts = list(ex.map(worker, range(CLIENTS)))
    out = [None] * len(bodies)
    for part in parts:
        for i, r in part:
            out[i] = r
    return out


def admission_review(obj: dict, op: str, uid: str) -> dict:
    group, _, version = obj["apiVersion"].rpartition("/")
    meta = obj.get("metadata") or {}
    request = {"uid": uid, "operation": op,
               "kind": {"group": group, "version": version,
                        "kind": obj["kind"]},
               "name": meta.get("name"), "namespace": meta.get("namespace"),
               "userInfo": {"username": "tester"}}
    if op == "CREATE":
        request["object"] = obj
    elif op == "UPDATE":
        old = json.loads(json.dumps(obj))
        old["metadata"]["labels"] = {"previous": "true"}
        request["object"] = obj
        request["oldObject"] = old
    else:  # DELETE: the old object is what is evaluated
        request["object"] = None
        request["oldObject"] = obj
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": request}


@pytest.mark.parametrize("op", ["CREATE", "UPDATE", "DELETE"])
def test_admit_corpus_byte_equal(servers, op):
    """The corpus manifests (every kind the 23 templates match) as
    AdmissionReviews: the port's /v1/admit bodies equal the JAX
    package's byte for byte, and the port's compiled kinds were served
    on its device path."""
    objs = fixture_objects(N_REVIEWS)
    bodies = [json.dumps(admission_review(o, op, f"{op}-{i}")).encode()
              for i, o in enumerate(objs)]
    counts0 = servers["torch"].driver.eval_counts()
    # the API server's longest webhook timeout
    got = {name: _send_all(s.server.port, "/v1/admit?timeout=30s", bodies)
           for name, s in servers.items()}
    for name, res in got.items():
        # every review was evaluated: no deadline, shed or error answer
        codes = {(json.loads(b)["response"].get("status") or {}).get("code")
                 for s, b in res if s == 200}
        assert all(s == 200 for s, _b in res) and codes <= {None, 403}, \
            (name, codes)
    assert got["torch"] == got["jax"]
    allowed = [json.loads(b)["response"]["allowed"]
               for _s, b in got["torch"]]
    assert allowed.count(False) > 0  # the corpus violates the library
    counts = servers["torch"].driver.eval_counts()
    device = {k for (k, p), n in counts.items()
              if p == "device" and n > counts0.get((k, p), 0)}
    assert device, "no compiled kind took the port's device path"


ADVERSARIAL = [
    b"not json at all",
    b"\xff\xfe garbage bytes",
    b"{}",
    json.dumps({"request": None}).encode(),
    json.dumps({"request": {"uid": "u"}}).encode(),
    json.dumps({"request": {"uid": "u", "kind": "notadict",
                            "object": []}}).encode(),
    json.dumps({"request": {"uid": "u",
                            "kind": {"group": 1, "version": [],
                                     "kind": {}},
                            "object": {"metadata": None}}}).encode(),
]


@pytest.mark.parametrize("path", ["/v1/admit", "/v1/admitlabel",
                                  "/v1/mutate"])
@pytest.mark.parametrize("body", ADVERSARIAL,
                         ids=[f"payload{i}" for i in range(len(ADVERSARIAL))])
def test_adversarial_payloads_equal(servers, path, body):
    """tests/test_control_plane.py's adversarial payloads: 400 for an
    unparseable body, else a fail-open 200, identical in both packages."""
    got = {name: _post_raw(s.server.port, path, body)
           for name, s in servers.items()}
    assert got["torch"] == got["jax"]
    status, payload = got["torch"]
    assert status in (200, 400)
    if status == 200:
        assert json.loads(payload)["response"]["allowed"] is True


def _ns_review(name, labels, uid):
    meta = {"name": name}
    if labels is not None:
        meta["labels"] = labels
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "kind": {"group": "", "version": "v1",
                                 "kind": "Namespace"},
                        "object": {"apiVersion": "v1", "kind": "Namespace",
                                   "metadata": meta}}}


IGNORE = {twebhook.IGNORE_LABEL: "true"}
ENDPOINT_CASES = {
    "admitlabel-plain": ("/v1/admitlabel", _ns_review("a", None, "l1")),
    "admitlabel-ignored": ("/v1/admitlabel", _ns_review("a", IGNORE, "l2")),
    "admitlabel-exempt": ("/v1/admitlabel",
                          _ns_review("exempt", IGNORE, "l3")),
    "admitlabel-v1beta1": ("/v1/admitlabel", dict(
        _ns_review("b", {"x": "y"}, "l4"),
        apiVersion="admission.k8s.io/v1beta1")),
    "mutate-delete": ("/v1/mutate", admission_review(
        fixture_objects(1)[0], "DELETE", "m-del")),
    "mutate-gatekeeper-resource": ("/v1/mutate", {"request": {
        "uid": "m-own", "kind": {"group": "mutations.gatekeeper.sh",
                                 "version": "v1alpha1", "kind": "Assign"},
        "object": {"spec": {}}, "userInfo": {"username": "alice"}}}),
    "mutate-service-account": ("/v1/mutate", {"request": dict(
        admission_review(fixture_objects(1)[0], "CREATE", "m-sa")["request"],
        userInfo={"username": twebhook.SERVICE_ACCOUNT})}),
}


@pytest.mark.parametrize("case", sorted(ENDPOINT_CASES))
def test_endpoint_cases_equal(servers, case):
    path, review = ENDPOINT_CASES[case]
    body = json.dumps(review).encode()
    got = {name: _post_raw(s.server.port, path, body)
           for name, s in servers.items()}
    assert got["torch"] == got["jax"]
    status, payload = got["torch"]
    assert status == 200
    out = json.loads(payload)["response"]
    assert out["uid"] == (review["request"].get("uid") or "")
    if case == "admitlabel-ignored":
        assert out["allowed"] is False and out["status"]["code"] == 403
    else:
        assert out["allowed"] is True and "patch" not in out


def test_mutate_corpus_patches_equal(servers):
    """Every corpus manifest through /v1/mutate: the JSONPatches (base64)
    are byte-equal, and they apply the mutators."""
    objs = fixture_objects(N_REVIEWS)
    bodies = [json.dumps(admission_review(o, "CREATE", f"m-{i}")).encode()
              for i, o in enumerate(objs)]
    got = {name: _send_all(s.server.port, "/v1/mutate", bodies)
           for name, s in servers.items()}
    assert got["torch"] == got["jax"]
    patched = 0
    for obj, (status, payload) in zip(objs, got["torch"]):
        assert status == 200
        resp = json.loads(payload)["response"]
        assert resp["allowed"] is True
        if "patch" not in resp:
            continue
        patched += 1
        ops = json.loads(base64.b64decode(resp["patch"]))
        after = tmutation.apply_patch(obj, ops)
        assert after["metadata"]["labels"]["team"] == \
            (obj["metadata"].get("labels") or {}).get("team", "platform")
        if obj["kind"] == "Pod":
            assert all(c.get("imagePullPolicy") == "Always"
                       for c in after["spec"].get("containers", []))
    assert patched == len(objs)  # every object gains the team label


# ------------------------------------- the in-process serving-plane cases


def _policy_client(P):
    client = P.Backend(P.driver()).new_client([P.Target()])
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


def case_keepalive(P):
    """The server answers HTTP/1.1 and two requests reuse one
    connection."""
    wh = P.webhook
    server = wh.WebhookServer(None, wh.NamespaceLabelHandler(()), port=0)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        review = {"apiVersion": "admission.k8s.io/v1",
                  "kind": "AdmissionReview",
                  "request": {"uid": "ka-1", "object": {
                      "metadata": {"name": "ns1"}}}}
        resp, out1 = _post(conn, "/v1/admitlabel", review)
        assert resp.version == 11, "server must answer HTTP/1.1"
        assert not resp.will_close, "server closed a keep-alive connection"
        sock_before = conn.sock
        assert sock_before is not None
        resp, out2 = _post(conn, "/v1/admitlabel", review)
        assert out2["response"]["uid"] == "ka-1"
        assert conn.sock is sock_before, \
            "second request did not reuse the connection"
        return [out1, out2]
    finally:
        server.stop(drain_timeout=1.0)


TIMEOUT_QUERIES = ["timeout=5s", "timeout=5s&timeout=10s",
                   "timeout=&timeout=3s", "timeout=1%6D10s",
                   "timeout=2%2E5", "timeout", "&&=&timeout&x", "",
                   "a=b&c", "timeout=bogus", "timeout=0s"]


def case_parse_timeout_query(P):
    out = [P.webhook.parse_timeout_query(q) for q in TIMEOUT_QUERIES]
    assert out == [5.0, 5.0, 3.0, 70.0, 2.5, None, None, None, None, None,
                   None]
    return out


def case_http_timeout_query(P):
    """A duplicate + percent-encoded query string lands in
    request.timeoutSeconds through the real HTTP server."""
    seen = {}
    wh = P.webhook

    class Probe:
        batcher = wh.MicroBatcher(None, evaluate=lambda reviews:
                                  [[] for _ in reviews])

        def handle(self, review):
            seen["timeout"] = review["request"].get("timeoutSeconds")
            return {"apiVersion": review.get("apiVersion"),
                    "kind": review.get("kind"),
                    "response": {"uid": "p", "allowed": True}}

    server = wh.WebhookServer(Probe(), None, port=0)
    server.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        _resp, out = _post(conn, "/v1/admit?timeout=7%73&timeout=30s",
                           _review("q1"))
        assert seen["timeout"] == 7.0
        return [seen["timeout"], out]
    finally:
        server.stop(drain_timeout=1.0)


ENVELOPES = [
    {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
     "response": {"uid": "5f0e-11:d.x_Y", "allowed": True}},
    {"apiVersion": "admission.k8s.io/v1beta1", "kind": "AdmissionReview",
     "response": {"uid": "u", "allowed": False,
                  "status": {"code": 403, "reason": 'msg "quoted" \\'}}},
    # an exotic uid takes the fallback, not broken JSON
    {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
     "response": {"uid": 'u"\n', "allowed": True}},
    # extra keys (patch) take the fallback
    {"apiVersion": None, "kind": None,
     "response": {"uid": "u", "allowed": True, "patchType": "JSONPatch",
                  "patch": "W10="}},
]


def case_encode_envelope(P):
    out = [P.webhook.encode_envelope(env) for env in ENVELOPES]
    for env, raw in zip(ENVELOPES, out):
        assert json.loads(raw) == env
    return out


def case_decision_cache_hits_across_uid_churn(P):
    client = _policy_client(P)
    client.add_constraint(_need_owner_constraint())
    wh = P.webhook
    handler = wh.ValidationHandler(client, kube=None,
                                   batcher=wh.MicroBatcher(client,
                                                           max_wait=0.001))
    try:
        out1 = handler.handle(_review("p1", {"owner": "me"}, uid="u-1"))
        out2 = handler.handle(_review("p1", {"owner": "me"}, uid="u-2"))
        assert out1["response"]["allowed"] and out2["response"]["allowed"]
        # same object, different uid: one evaluation, one hit, and each
        # response carries its own uid
        assert handler.cache.hits == 1
        assert out1["response"]["uid"] == "u-1"
        assert out2["response"]["uid"] == "u-2"
        out3 = handler.handle(_review("bad", None, uid="u-3"))
        out4 = handler.handle(_review("bad", None, uid="u-4"))
        assert out4["response"]["allowed"] is False
        assert handler.cache.hits == 2
        return [out1, out2, out3, out4, handler.cache.hits,
                handler.cache.misses]
    finally:
        handler.batcher.stop()


def case_decision_cache_invalidated_by_constraint_update(P):
    """A cached allow flips to deny after a constraint lands and bumps
    the library generation, and back when it goes."""
    client = _policy_client(P)  # template only: no constraint yet
    wh = P.webhook
    handler = wh.ValidationHandler(client, kube=None,
                                   batcher=wh.MicroBatcher(client,
                                                           max_wait=0.001))
    try:
        outs = [handler.handle(_review("pod-a", None, uid="u-1"))]
        assert outs[0]["response"]["allowed"] is True
        outs.append(handler.handle(_review("pod-a", None, uid="u-2")))
        assert handler.cache.hits == 1
        gen_before = client.generation
        client.add_constraint(_need_owner_constraint())
        assert client.generation > gen_before
        outs.append(handler.handle(_review("pod-a", None, uid="u-3")))
        assert outs[-1]["response"]["allowed"] is False, \
            "stale cached allow served after a constraint update"
        client.remove_constraint(_need_owner_constraint())
        outs.append(handler.handle(_review("pod-a", None, uid="u-4")))
        assert outs[-1]["response"]["allowed"] is True
        return outs + [handler.cache.hits]
    finally:
        handler.batcher.stop()


def case_decision_cache_ns_label_key(P):
    DC = P.webhook.DecisionCache
    ns = {"metadata": {"name": "d", "labels": {"env": "prod"}}}
    ns2 = {"metadata": {"name": "d", "labels": {"env": "dev"}}}
    ns3 = {"metadata": {"name": "d", "labels": {"env": "prod"},
                        "annotations": {"owner": "x"}}}
    assert DC.ns_key(ns) != DC.ns_key(ns2)
    # the whole namespace object keys the cache, not its labels alone
    assert DC.ns_key(ns) != DC.ns_key(ns3)
    assert DC.ns_key(None) == b""
    # uid and timeoutSeconds are noise; object content is signal
    r = _review("x", {"owner": "me"})["request"]
    r2 = dict(r, uid="other", timeoutSeconds=3)
    r3 = _review("x", {"owner": "you"})["request"]
    assert DC.request_key(r) == DC.request_key(r2)
    assert DC.request_key(r) != DC.request_key(r3)
    return [DC.ns_key(ns), DC.ns_key(ns2), DC.ns_key(ns3),
            DC.request_key(r), DC.request_key(r3)]


def case_decision_cache_log_denies_reevaluates_denials(P):
    """--log-denies: every denial re-evaluates; allows still serve from
    the cache."""
    client = _policy_client(P)
    client.add_constraint(_need_owner_constraint())
    wh = P.webhook
    handler = wh.ValidationHandler(client, kube=None, log_denies=True,
                                   batcher=wh.MicroBatcher(client,
                                                           max_wait=0.001))
    try:
        outs = [handler.handle(_review("bad", None, uid=uid))
                for uid in ("a", "b")]
        assert all(o["response"]["allowed"] is False for o in outs)
        assert handler.cache.hits == 0  # denials never hit
        outs += [handler.handle(_review("ok", {"owner": "me"}, uid=uid))
                 for uid in ("c", "d")]
        assert handler.cache.hits == 1  # allows still do
        return outs + [handler.cache.hits]
    finally:
        handler.batcher.stop()


def case_decision_cache_lru_bound(P):
    cache = P.webhook.DecisionCache(size=4)
    for i in range(10):
        cache.put((bytes([i]), 0, 0), {"allowed": True})
    assert len(cache) == 4
    return [len(cache), [cache.get((bytes([i]), 0, 0)) for i in range(10)]]


SERVING_CASES = [case_keepalive, case_parse_timeout_query,
                 case_http_timeout_query, case_encode_envelope,
                 case_decision_cache_hits_across_uid_churn,
                 case_decision_cache_invalidated_by_constraint_update,
                 case_decision_cache_ns_label_key,
                 case_decision_cache_log_denies_reevaluates_denials,
                 case_decision_cache_lru_bound]


@pytest.mark.parametrize("case", SERVING_CASES,
                         ids=[c.__name__[5:] for c in SERVING_CASES])
def test_serving_plane_case_equal(case):
    assert case(TORCH) == case(JAX)
