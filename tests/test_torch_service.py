"""gRPC service tests beyond the shared conformance matrix
(tests/test_torch_client.py runs its whole e2e suite over the wire
already): batched review RPC, the server backed by TorchDriver on the
CPU, error envelope round-tripping, and concurrent client requests. The
port's copy of tests/test_service.py; its last case holds the port's
server against the JAX package's."""

import threading

import pytest

pytest.importorskip("grpc")

from gatekeeper_tpu_torch.client.types import (  # noqa: E402
    ClientError,
    UnrecognizedConstraintError,
)
from gatekeeper_tpu_torch.service import RemoteClient, make_server  # noqa: E402
from gatekeeper_tpu_torch.target import AugmentedUnstructured  # noqa: E402

TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8sreqlbl"},
    "spec": {
        "crd": {"spec": {
            "names": {"kind": "K8sReqLbl"},
            "validation": {"openAPIV3Schema": {"properties": {
                "labels": {"type": "array",
                           "items": {"type": "string"}}}}},
        }},
        "targets": [{"target": "admission.k8s.gatekeeper.sh", "rego": """
package k8sreqlbl
violation[{"msg": msg}] {
  provided := {l | input.review.object.metadata.labels[l]}
  required := {l | l := input.parameters.labels[_]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("missing: %v", [missing])
}
"""}],
    },
}

CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sReqLbl", "metadata": {"name": "need-owner"},
    "spec": {"parameters": {"labels": ["owner"]}},
}


def ns(name, labels=None):
    meta = {"name": name}
    if labels:
        meta["labels"] = labels
    return {"apiVersion": "v1", "kind": "Namespace", "metadata": meta}


@pytest.fixture(params=["rego", "torch"])
def remote(request):
    server, port = make_server(driver=request.param, device="cpu")
    server.start()
    rc = RemoteClient(f"127.0.0.1:{port}")
    try:
        yield rc
    finally:
        rc.close()
        server.stop(grace=None)


def test_review_batch_rpc(remote):
    remote.add_template(TEMPLATE)
    remote.add_constraint(CONSTRAINT)
    objs = [AugmentedUnstructured(ns(f"n{i}",
                                     {"owner": "x"} if i % 2 else None))
            for i in range(10)]
    out = remote.review_batch(objs)
    assert len(out) == 10
    for i, resps in enumerate(out):
        msgs = [r.msg for r in resps.results()]
        if i % 2:
            assert msgs == []
        else:
            assert msgs == ['missing: {"owner"}']


def test_review_stream_pipelined_batches(remote):
    """Streaming ingest: batches pipeline over ONE
    bidirectional stream, responses come back per batch in order, and
    a bad batch answers an in-stream error without killing the
    stream's earlier results."""
    remote.add_template(TEMPLATE)
    remote.add_constraint(CONSTRAINT)
    batches = [
        [AugmentedUnstructured(ns("a0")),
         AugmentedUnstructured(ns("a1", {"owner": "x"}))],
        [AugmentedUnstructured(ns("b0", {"owner": "y"}))],
        [AugmentedUnstructured(ns("c0"))],
    ]
    out = list(remote.review_stream(batches))
    assert len(out) == 3
    assert [[len(r.results()) for r in b] for b in out] == \
        [[1, 0], [0], [1]]
    assert out[0][0].results()[0].msg == 'missing: {"owner"}'


def test_review_stream_bad_batch_survives_on_the_wire(remote):
    """A malformed batch answers an in-stream {"error": ...} message;
    the batches before AND after it still evaluate — one bad manifest
    must not kill a million-manifest scan's stream."""
    import grpc as grpc_mod  # noqa: F401 - importorskip'd above

    from gatekeeper_tpu_torch.service.server import (
        SERVICE_NAME,
        _dumps,
        _loads,
    )

    remote.add_template(TEMPLATE)
    remote.add_constraint(CONSTRAINT)
    call = remote._channel.stream_stream(
        f"/{SERVICE_NAME}/ReviewStream",
        request_serializer=_dumps, response_deserializer=_loads)
    msgs = [
        {"reviews": [{"object": ns("ok", {"owner": "x"})}]},
        {"reviews": [{"bogus": 1}]},  # no object/admissionRequest/raw
        {"reviews": [{"object": ns("bad")}]},
    ]
    out = list(call(iter(msgs)))
    assert len(out) == 3
    assert "responses" in out[0]
    assert out[1].get("error", {}).get("error") == "ClientError"
    # the stream SURVIVED the bad batch and kept evaluating
    results = out[2]["responses"][0]["byTarget"][
        "admission.k8s.gatekeeper.sh"]["results"]
    assert len(results) == 1


def test_ingest_surface_excludes_library_lifecycle():
    """--ingest-grpc serves the evaluation-only method set: bulk
    callers can stream reviews but can never rewrite the serving
    library through the ingest port."""
    from gatekeeper_tpu_torch.client import Backend, RegoDriver
    from gatekeeper_tpu_torch.service import INGEST_METHODS
    from gatekeeper_tpu_torch.service.client import RemoteTransportError
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    client = Backend(RegoDriver()).new_client([K8sValidationTarget()])
    client.add_template(TEMPLATE)
    client.add_constraint(CONSTRAINT)
    server, port = make_server(client=client, expose=INGEST_METHODS)
    server.start()
    rc = RemoteClient(f"127.0.0.1:{port}")
    try:
        out = list(rc.review_stream(
            [[AugmentedUnstructured(ns("x"))]]))
        assert len(out) == 1 and len(out[0][0].results()) == 1
        with pytest.raises(RemoteTransportError):
            rc.add_template(TEMPLATE)
        with pytest.raises(RemoteTransportError):
            rc.reset()
    finally:
        rc.close()
        server.stop(grace=None)


def test_audit_over_wire(remote):
    remote.add_template(TEMPLATE)
    remote.add_constraint(CONSTRAINT)
    remote.add_data(ns("bad"))
    remote.add_data(ns("good", {"owner": "me"}))
    results = remote.audit().results()
    assert [r.resource["metadata"]["name"] for r in results] == ["bad"]
    assert results[0].constraint["metadata"]["name"] == "need-owner"
    assert results[0].enforcement_action == "deny"


def test_error_envelope_roundtrip(remote):
    with pytest.raises(UnrecognizedConstraintError) as ei:
        remote.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "NoSuchKind", "metadata": {"name": "x"}, "spec": {}})
    assert ei.value.kind == "NoSuchKind"
    bad = dict(TEMPLATE, spec=dict(TEMPLATE["spec"]))
    bad["spec"]["targets"] = [{"target": "admission.k8s.gatekeeper.sh",
                               "rego": "package x\nviolation[{"}]
    with pytest.raises(ClientError):
        remote.add_template(bad)


def test_concurrent_clients(remote):
    remote.add_template(TEMPLATE)
    remote.add_constraint(CONSTRAINT)
    errs = []

    def worker(i):
        try:
            for j in range(5):
                resps = remote.review(
                    AugmentedUnstructured(ns(f"w{i}-{j}")))
                assert len(resps.results()) == 1
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs


def test_template_kinds_and_dump(remote):
    remote.add_template(TEMPLATE)
    assert remote.template_kinds() == ["K8sReqLbl"]
    assert remote.knows_kind("K8sReqLbl")
    assert "modules" in remote.dump()
    remote.reset()
    assert remote.template_kinds() == []


def test_unhandled_dict_parity(remote):
    """A dict the local handler can't classify must come back unhandled
    over the wire too (r3 code-review finding: the wire mapping used to
    wrap it, silently making it handled)."""
    from gatekeeper_tpu_torch.client import Backend, RegoDriver
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    local = Backend(RegoDriver()).new_client([K8sValidationTarget()])
    weird = {"foo": 1}
    assert sorted(local.review(weird).by_target) == \
        sorted(remote.review(weird).by_target) == []


def test_transport_error_is_not_client_error():
    from gatekeeper_tpu_torch.service import RemoteClient, RemoteTransportError

    rc = RemoteClient("127.0.0.1:1")  # nothing listens there
    with pytest.raises(RemoteTransportError):
        rc.template_kinds()
    rc.close()


def test_bind_failure_raises():
    server, port = make_server(driver="rego")
    server.start()
    try:
        # newer grpc raises RuntimeError itself; the port==0 OSError path
        # covers versions that signal failure by returning 0
        with pytest.raises((OSError, RuntimeError)):
            make_server(driver="rego", address=f"127.0.0.1:{port}")
    finally:
        server.stop(grace=None)


def test_join_templates_over_the_wire(remote):
    """The join templates through the gRPC seam: the inventory-join
    templates (device-compiled in the TorchDriver-backed server) must
    produce the same audit/review answers as a local interpreter
    client."""
    from gatekeeper_tpu_torch import policies
    from gatekeeper_tpu_torch.client import Backend, RegoDriver
    from gatekeeper_tpu_torch.target import AugmentedUnstructured, \
        K8sValidationTarget

    rc = remote

    def ingress(name, ns, hosts):
        return {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
                "metadata": {"name": name, "namespace": ns},
                "spec": {"rules": [{"host": h} for h in hosts]}}

    local = Backend(RegoDriver()).new_client([K8sValidationTarget()])
    outs = []
    for client in (rc, local):
        client.add_template(policies.load("general/uniqueingresshost"))
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sUniqueIngressHost",
            "metadata": {"name": "uniq"}, "spec": {}})
        client.add_data(ingress("a", "ns1", ["x.com"]))
        client.add_data(ingress("b", "ns2", ["x.com", "y.com"]))
        client.add_data(ingress("c", "ns3", ["z.com"]))
        aud = sorted((r.msg,
                      (r.resource or {}).get("metadata", {}).get("name"))
                     for r in client.audit().results())
        rev = sorted(r.msg for r in client.review(
            AugmentedUnstructured(ingress("new", "ns9",
                                          ["y.com"]))).results())
        own = sorted(r.msg for r in client.review(
            AugmentedUnstructured(ingress("c", "ns3",
                                          ["z.com"]))).results())
        outs.append((aud, rev, own))
    assert outs[0] == outs[1]
    aud, rev, own = outs[0]
    assert len(aud) == 2 and rev and own == []


# ------------------------------------- the port against the JAX package

def _service_transcript(server_mod, driver: str, **kw) -> list:
    """One package's server (`driver`) through the port's RemoteClient:
    the ReviewBatch RPC, a ReviewStream of two batches and the join
    templates' audit and review; per answer the results' (message,
    constraint, resource name)."""
    from gatekeeper_tpu_torch import policies

    server, port = server_mod.make_server(driver=driver, **kw)
    server.start()
    rc = RemoteClient(f"127.0.0.1:{port}")

    def keys(resps):
        return [(r.msg, r.constraint["metadata"]["name"],
                 (r.resource or {}).get("metadata", {}).get("name"))
                for r in resps.results()]

    out = []
    try:
        rc.add_template(TEMPLATE)
        rc.add_constraint(CONSTRAINT)
        objs = [AugmentedUnstructured(ns(f"n{i}", {"owner": "x"}
                                         if i % 3 == 0 else None))
                for i in range(9)]
        out.append([keys(r) for r in rc.review_batch(objs)])
        out.append([[keys(r) for r in b]
                    for b in rc.review_stream([objs[:4], objs[4:]])])
        rc.add_template(policies.load("general/uniqueingresshost"))
        rc.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sUniqueIngressHost",
            "metadata": {"name": "uniq"}, "spec": {}})
        for name, nsn, hosts in (("a", "ns1", ["x.com"]),
                                 ("b", "ns2", ["x.com", "y.com"]),
                                 ("c", "ns3", ["z.com"])):
            rc.add_data({"apiVersion": "networking.k8s.io/v1",
                         "kind": "Ingress",
                         "metadata": {"name": name, "namespace": nsn},
                         "spec": {"rules": [{"host": h} for h in hosts]}})
        out.append(keys(rc.audit()))
    finally:
        rc.close()
        server.stop(grace=None)
    return out


def test_torch_server_equals_the_jax_package_server():
    """The port's server with TorchDriver on the CPU answers the batch,
    the stream and the join audit as the JAX package's server with
    TpuDriver does."""
    from gatekeeper_tpu.service import server as jserver
    from gatekeeper_tpu_torch.service import server as tserver

    got = _service_transcript(tserver, "torch", device="cpu")
    want = _service_transcript(jserver, "tpu")
    assert got == want
    assert len(got[-1]) == 5 and got[0][1] == [('missing: {"owner"}',
                                                "need-owner", "n1")]
