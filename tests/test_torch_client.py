"""Client/driver conformance suite.

Python analog of the reference framework's driver-agnostic e2e suite
(vendor/.../constraint/pkg/client/e2e_tests.go): deny templates, dryrun
enforcement, autoreject, data sync + audit, template/constraint lifecycle,
validation failures. Runs against any Driver; parametrized so the port's
TorchDriver (on the CPU, behind the gRPC service) reuses it unchanged.
This is the port's copy of tests/test_client.py; its last case holds a
RemoteClient over the port's server (TorchDriver on the CPU) against one
over the JAX package's server (TpuDriver) on the same library.
"""

import pytest

from gatekeeper_tpu_torch.client import (
    Backend,
    Client,
    ClientError,
    RegoDriver,
    UnrecognizedConstraintError,
)
from gatekeeper_tpu_torch.target import (
    AugmentedReview,
    AugmentedUnstructured,
    K8sValidationTarget,
)

DENY_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8sdenyall"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "K8sDenyAll"}}},
        "targets": [{
            "target": "admission.k8s.gatekeeper.sh",
            "rego": """
package k8sdenyall
violation[{"msg": msg}] {
  msg := "denied!"
}
""",
        }],
    },
}

REQUIRED_LABELS_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8srequiredlabelstest"},
    "spec": {
        "crd": {"spec": {
            "names": {"kind": "K8sRequiredLabelsTest"},
            "validation": {"openAPIV3Schema": {"properties": {
                "labels": {"type": "array", "items": {"type": "string"}},
            }}},
        }},
        "targets": [{
            "target": "admission.k8s.gatekeeper.sh",
            "rego": """
package k8srequiredlabelstest
violation[{"msg": msg, "details": {"missing_labels": missing}}] {
  provided := {label | input.review.object.metadata.labels[label]}
  required := {label | label := input.parameters.labels[_]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("you must provide labels: %v", [missing])
}
""",
        }],
    },
}

LIB_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8swithlib"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "K8sWithLib"}}},
        "targets": [{
            "target": "admission.k8s.gatekeeper.sh",
            "rego": """
package k8swithlib
violation[{"msg": msg}] {
  data.lib.helpers.is_bad(input.review.object)
  msg := data.lib.helpers.badness
}
""",
            "libs": ["""
package lib.helpers
badness = "object is bad"
is_bad(obj) { obj.metadata.labels["bad"] }
"""],
        }],
    },
}


def constraint(kind, name, *, params=None, match=None, enforcement=None):
    c = {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind,
        "metadata": {"name": name},
        "spec": {},
    }
    if params is not None:
        c["spec"]["parameters"] = params
    if match is not None:
        c["spec"]["match"] = match
    if enforcement is not None:
        c["spec"]["enforcementAction"] = enforcement
    return c


def obj(kind, name, *, api_version="v1", namespace=None, labels=None, spec=None):
    o = {"apiVersion": api_version, "kind": kind, "metadata": {"name": name}}
    if namespace:
        o["metadata"]["namespace"] = namespace
    if labels is not None:
        o["metadata"]["labels"] = labels
    if spec is not None:
        o["spec"] = spec
    return o


def admission_request(o, operation="CREATE", old=None, namespace=None):
    group, _, version = (o.get("apiVersion") or "").rpartition("/")
    req = {
        "uid": "test-uid",
        "kind": {"group": group, "version": version, "kind": o["kind"]},
        "operation": operation,
        "name": o["metadata"]["name"],
        "object": o,
    }
    if old is not None:
        req["oldObject"] = old
    ns = namespace or o["metadata"].get("namespace")
    if ns:
        req["namespace"] = ns
    return req


@pytest.fixture(params=["local", "grpc", "grpc-torch"])
def client(request):
    """Every conformance case runs three times: against the in-process
    Client and against a live localhost gRPC service (service/) through
    RemoteClient, whose server evaluates with RegoDriver or with
    TorchDriver on the CPU — the wire protocol must not change any
    semantics."""
    if request.param == "local":
        yield Backend(RegoDriver()).new_client([K8sValidationTarget()])
        return
    pytest.importorskip("grpc")
    from gatekeeper_tpu_torch.service import RemoteClient, make_server

    server, port = make_server(
        driver="torch" if request.param == "grpc-torch" else "rego",
        device="cpu")
    server.start()
    rc = RemoteClient(f"127.0.0.1:{port}")
    try:
        yield rc
    finally:
        rc.close()
        server.stop(grace=None)


def test_deny_all(client):
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(constraint("K8sDenyAll", "deny-all"))
    rsp = client.review(AugmentedReview(admission_request(obj("Pod", "p1"))))
    results = rsp.results()
    assert len(results) == 1
    assert results[0].msg == "denied!"
    assert results[0].enforcement_action == "deny"
    assert results[0].constraint["metadata"]["name"] == "deny-all"
    assert results[0].resource["kind"] == "Pod"


def test_dryrun_enforcement_action(client):
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(
        constraint("K8sDenyAll", "dry", enforcement="dryrun"))
    rsp = client.review(AugmentedReview(admission_request(obj("Pod", "p"))))
    assert [r.enforcement_action for r in rsp.results()] == ["dryrun"]


def test_required_labels_params_and_details(client):
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    client.add_constraint(constraint(
        "K8sRequiredLabelsTest", "need-gk", params={"labels": ["gatekeeper"]}))
    bad = obj("Namespace", "ns1")
    rsp = client.review(AugmentedReview(admission_request(bad)))
    results = rsp.results()
    assert len(results) == 1
    assert results[0].msg == 'you must provide labels: {"gatekeeper"}'
    assert results[0].metadata["details"] == {"missing_labels": ["gatekeeper"]}
    good = obj("Namespace", "ns2", labels={"gatekeeper": "yes"})
    assert client.review(AugmentedReview(admission_request(good))).results() == []


def test_template_libs_are_namespaced(client):
    client.add_template(LIB_TEMPLATE)
    client.add_constraint(constraint("K8sWithLib", "lib-c"))
    bad = obj("Pod", "p", labels={"bad": "yes"})
    rsp = client.review(AugmentedReview(admission_request(bad)))
    assert [r.msg for r in rsp.results()] == ["object is bad"]
    ok = obj("Pod", "p2", labels={})
    assert client.review(AugmentedReview(admission_request(ok))).results() == []


def test_match_kinds_namespaces_and_labels(client):
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(constraint("K8sDenyAll", "pods-only", match={
        "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]}))
    assert client.review(
        AugmentedReview(admission_request(obj("Pod", "p")))).results()
    assert not client.review(
        AugmentedReview(admission_request(obj("Service", "s")))).results()

    client.add_constraint(constraint("K8sDenyAll", "ns-scoped", match={
        "namespaces": ["prod"]}))
    in_prod = client.review(AugmentedReview(
        admission_request(obj("Pod", "p", namespace="prod"))))
    assert {r.constraint["metadata"]["name"] for r in in_prod.results()} == \
        {"pods-only", "ns-scoped"}

    client.add_constraint(constraint("K8sDenyAll", "labeled", match={
        "kinds": [{"apiGroups": ["*"], "kinds": ["*"]}],
        "labelSelector": {"matchExpressions": [
            {"key": "env", "operator": "In", "values": ["prod"]}]},
    }))
    labeled = client.review(AugmentedReview(
        admission_request(obj("Service", "svc", labels={"env": "prod"}))))
    assert {r.constraint["metadata"]["name"] for r in labeled.results()} == \
        {"labeled"}


def test_autoreject_when_namespace_not_cached(client):
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(constraint("K8sDenyAll", "ns-sel", match={
        "kinds": [{"apiGroups": [""], "kinds": ["Service"]}],
        "namespaceSelector": {"matchLabels": {"team": "a"}},
    }))
    req = admission_request(obj("Service", "s", namespace="unknown"))
    rsp = client.review(AugmentedReview(req))
    assert [r.msg for r in rsp.results()] == ["Namespace is not cached in OPA."]

    # sideloading the namespace (webhook fetches it) resolves the selector
    ns = obj("Namespace", "unknown", labels={"team": "a"})
    rsp = client.review(AugmentedReview(req, namespace=None), tracing=False)
    rsp2 = client.review(AugmentedReview(admission_request(
        obj("Service", "s", namespace="unknown"))))
    # now cache the namespace instead
    client.add_data(ns)
    rsp3 = client.review(AugmentedReview(req))
    assert [r.msg for r in rsp3.results()] == ["denied!"]
    # non-matching cached namespace -> no match, no autoreject
    client.add_data(obj("Namespace", "unknown", labels={"team": "b"}))
    assert client.review(AugmentedReview(req)).results() == []


def test_add_data_and_audit(client):
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    client.add_constraint(constraint(
        "K8sRequiredLabelsTest", "need-owner", params={"labels": ["owner"]}))
    client.add_data(obj("Namespace", "unlabeled"))
    client.add_data(obj("Namespace", "labeled", labels={"owner": "me"}))
    client.add_data(obj("Pod", "pod-1", namespace="default"))
    rsp = client.audit()
    results = rsp.results()
    assert len(results) == 2  # unlabeled ns + pod
    by_name = {r.resource["metadata"]["name"] for r in results}
    assert by_name == {"unlabeled", "pod-1"}
    assert all(r.msg == 'you must provide labels: {"owner"}' for r in results)
    # removing data removes findings
    client.remove_data(obj("Pod", "pod-1", namespace="default"))
    assert len(client.audit().results()) == 1


def test_audit_review_shapes(client):
    """Audit reviews carry kind/name/namespace the way regolib's
    make_review does (src.rego:40-61)."""
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(constraint("K8sDenyAll", "deny-prod", match={
        "namespaces": ["prod"]}))
    client.add_data(obj("Pod", "p1", namespace="prod"))
    client.add_data(obj("Pod", "p2", namespace="dev"))
    client.add_data(obj("Namespace", "prod"))
    results = client.audit().results()
    # only the namespaced prod pod matches the namespaces selector;
    # the Namespace object itself has metadata.name == "prod"  -> matches too
    names = {r.resource["metadata"]["name"] for r in results}
    assert names == {"p1", "prod"}


def test_inventory_visible_to_templates(client):
    templ = {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8suniquename"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sUniqueName"}}},
            "targets": [{
                "target": "admission.k8s.gatekeeper.sh",
                "rego": """
package k8suniquename
violation[{"msg": msg}] {
  other := data.inventory.namespace[ns][_]["Pod"][name]
  name == input.review.object.metadata.name
  ns != input.review.object.metadata.namespace
  msg := sprintf("name collision with %v/%v", [ns, name])
}
""",
            }],
        },
    }
    client.add_template(templ)
    client.add_constraint(constraint("K8sUniqueName", "uniq"))
    client.add_data(obj("Pod", "dup", namespace="other"))
    req = admission_request(obj("Pod", "dup", namespace="mine"))
    rsp = client.review(AugmentedReview(req))
    assert [r.msg for r in rsp.results()] == ["name collision with other/dup"]


def test_remove_constraint_and_template(client):
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(constraint("K8sDenyAll", "deny-all"))
    req = AugmentedReview(admission_request(obj("Pod", "p")))
    assert client.review(req).results()
    client.remove_constraint(constraint("K8sDenyAll", "deny-all"))
    assert client.review(req).results() == []
    client.add_constraint(constraint("K8sDenyAll", "deny-all"))
    client.remove_template(DENY_TEMPLATE)
    with pytest.raises(UnrecognizedConstraintError):
        client.add_constraint(constraint("K8sDenyAll", "deny-all"))
    assert client.review(req).results() == []


def test_reset(client):
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(constraint("K8sDenyAll", "deny-all"))
    client.add_data(obj("Namespace", "ns"))
    client.reset()
    req = AugmentedReview(admission_request(obj("Pod", "p")))
    assert client.review(req).results() == []
    assert client.audit().results() == []


def test_template_validation_errors(client):
    bad_name = {**DENY_TEMPLATE, "metadata": {"name": "wrong-name"}}
    with pytest.raises(ClientError):
        client.add_template(bad_name)
    no_targets = {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8sfoo"},
        "spec": {"crd": {"spec": {"names": {"kind": "K8sFoo"}}}},
    }
    with pytest.raises(ClientError):
        client.add_template(no_targets)
    no_violation = {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8sbar"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sBar"}}},
            "targets": [{"target": "admission.k8s.gatekeeper.sh",
                         "rego": "package k8sbar\nallow { true }"}],
        },
    }
    with pytest.raises(ClientError, match="violation"):
        client.add_template(no_violation)
    bad_data_ref = {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8sbaz"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sBaz"}}},
            "targets": [{"target": "admission.k8s.gatekeeper.sh",
                         "rego": """
package k8sbaz
violation[{"msg": "x"}] { data.constraints.secret }
"""}],
        },
    }
    with pytest.raises(ClientError, match="data reference"):
        client.add_template(bad_data_ref)


def test_constraint_validation_errors(client):
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    wrong_kind = constraint("K8sOther", "c1")
    with pytest.raises(UnrecognizedConstraintError):
        client.add_constraint(wrong_kind)
    wrong_group = constraint("K8sRequiredLabelsTest", "c2")
    wrong_group["apiVersion"] = "other.group/v1beta1"
    with pytest.raises(ClientError, match="wrong group"):
        client.add_constraint(wrong_group)
    bad_params = constraint("K8sRequiredLabelsTest", "c3",
                            params={"labels": "not-a-list"})
    with pytest.raises(ClientError, match="expected array"):
        client.add_constraint(bad_params)
    bad_operator = constraint("K8sRequiredLabelsTest", "c4", match={
        "labelSelector": {"matchExpressions": [
            {"key": "k", "operator": "Bogus"}]}})
    with pytest.raises(Exception, match="invalid operator|not in enum"):
        client.add_constraint(bad_operator)
    bad_name = constraint("K8sRequiredLabelsTest", "Not_A_DNS_Name")
    with pytest.raises(ClientError, match="Invalid Name"):
        client.add_constraint(bad_name)


def test_template_dedupe_and_update(client):
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    client.add_constraint(constraint(
        "K8sRequiredLabelsTest", "need-a", params={"labels": ["a"]}))
    # re-adding identical template keeps constraints
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    req = AugmentedReview(admission_request(obj("Namespace", "n")))
    assert client.review(req).results()
    # updating the rego swaps behavior
    import copy
    updated = copy.deepcopy(REQUIRED_LABELS_TEMPLATE)
    updated["spec"]["targets"][0]["rego"] = """
package k8srequiredlabelstest
violation[{"msg": "always"}] { true }
"""
    client.add_template(updated)
    assert [r.msg for r in client.review(req).results()] == ["always"]


def test_create_crd_shape(client):
    crd = client.create_crd(REQUIRED_LABELS_TEMPLATE)
    assert crd["metadata"]["name"] == \
        "k8srequiredlabelstest.constraints.gatekeeper.sh"
    assert crd["spec"]["names"]["kind"] == "K8sRequiredLabelsTest"
    assert crd["spec"]["scope"] == "Cluster"
    spec_props = crd["spec"]["validation"]["openAPIV3Schema"][
        "properties"]["spec"]["properties"]
    assert set(spec_props) == {"match", "parameters", "enforcementAction"}


def test_review_of_unstructured_object(client):
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(constraint("K8sDenyAll", "deny-all"))
    rsp = client.review(AugmentedUnstructured(obj("Pod", "p")))
    assert [r.msg for r in rsp.results()] == ["denied!"]
    # plain unstructured dicts work too
    rsp = client.review(obj("Pod", "p2"))
    assert [r.msg for r in rsp.results()] == ["denied!"]


def test_dump_contains_state(client):
    client.add_template(DENY_TEMPLATE)
    client.add_constraint(constraint("K8sDenyAll", "deny-all"))
    client.add_data(obj("Namespace", "ns1"))
    dump = client.dump()
    assert "deny-all" in dump and "ns1" in dump


# ------------------------------------- the port against the JAX package

def _remote_transcript(server_mod, driver: str, **kw) -> list:
    """One package's gRPC server (`driver`), through the port's
    RemoteClient (the wire is the same), over a fixed scenario: templates with params, libs and matches, data, each
    review, and the audit; per call its results' (message, constraint,
    action, resource, details), in order."""
    from gatekeeper_tpu_torch.service import RemoteClient

    server, port = server_mod.make_server(driver=driver, **kw)
    server.start()
    rc = RemoteClient(f"127.0.0.1:{port}")
    out = []

    def keep(results):
        out.append([(r.msg, r.constraint["metadata"]["name"],
                     r.enforcement_action,
                     (r.resource or {}).get("metadata", {}).get("name"),
                     (r.metadata or {}).get("details"))
                    for r in results])

    try:
        rc.add_template(DENY_TEMPLATE)
        rc.add_template(REQUIRED_LABELS_TEMPLATE)
        rc.add_template(LIB_TEMPLATE)
        rc.add_constraint(constraint("K8sDenyAll", "pods-only", match={
            "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
            enforcement="dryrun"))
        rc.add_constraint(constraint(
            "K8sRequiredLabelsTest", "need-owner",
            params={"labels": ["owner"]}))
        rc.add_constraint(constraint("K8sWithLib", "lib-c"))
        objs = [obj("Namespace", "unlabeled"),
                obj("Namespace", "labeled", labels={"owner": "me"}),
                obj("Pod", "p", namespace="labeled", labels={"bad": "y"}),
                obj("Service", "s", namespace="labeled")]
        for o in objs:
            rc.add_data(o)
        for o in objs:
            keep(rc.review(AugmentedReview(admission_request(o))).results())
        keep(rc.review_batch([AugmentedUnstructured(o)
                              for o in objs])[1].results())
        keep(rc.audit().results())
        rc.remove_constraint(constraint(
            "K8sRequiredLabelsTest", "need-owner"))
        keep(rc.audit().results())
    finally:
        rc.close()
        server.stop(grace=None)
    return out


def test_torch_server_equals_the_jax_package_server():
    """RemoteClient over the port's server with TorchDriver on the CPU
    gives the results of RemoteClient over the JAX package's server
    with TpuDriver, on the same library, data and reviews."""
    pytest.importorskip("grpc")
    from gatekeeper_tpu.service import server as jserver
    from gatekeeper_tpu_torch.service import server as tserver

    got = _remote_transcript(tserver, "torch", device="cpu")
    want = _remote_transcript(jserver, "tpu")
    assert got == want
    assert got[-2] and len(got[-1]) < len(got[-2])
