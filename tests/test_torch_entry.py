"""The port's process entry point (control/main.py) against the JAX
package's.

  * tests/test_e2e_scenarios.py's agilebank table through both packages'
    `Runtime` (the port's with `--device cpu`), one cluster each for the
    whole table, admission over real HTTP: every response body equal,
    byte for byte;
  * the Runtime, cert and upgrade cases of tests/test_control_plane.py,
    each through both packages, their transcripts (verdicts, statuses,
    kube objects) equal;
  * the SLO cases of tests/test_observability.py (:984, :1027, :1053,
    :1064, :1244), against both packages' `control/slo.py`;
  * what the port rewired: `--device` (the card by default, raising
    without one; `cpu` the only way onto the host), the card count for
    `--admission-engines 0`, `/debug/profile` on torch.profiler,
    `--compile-cache-dir` as Triton's cache; each flag whose path
    needs the multi-process plane or the service building it on the CPU
    with the port's children; and the `scan` subcommand, which runs the
    port's control/scan.py and returns the JAX package's exit code.

Every test runs under a hard SIGALRM timeout.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import re
import signal
import ssl
import tempfile
import threading
import time
import types
from pathlib import Path

import pytest
import yaml

from gatekeeper_tpu.control import certs as jcerts
from gatekeeper_tpu.control import controllers as jcontrollers
from gatekeeper_tpu.control import slo as jslo
from gatekeeper_tpu.control import upgrade as jupgrade
from gatekeeper_tpu.control import webhook as jwebhook
from gatekeeper_tpu_torch.control import certs as tcerts
from gatekeeper_tpu_torch.control import controllers as tcontrollers
from gatekeeper_tpu_torch.control import slo as tslo
from gatekeeper_tpu_torch.control import upgrade as tupgrade
from gatekeeper_tpu_torch.control import webhook as twebhook

from . import test_torch_warm_restart as wr

JAX = types.SimpleNamespace(**vars(wr.JAX), certs=jcerts,
                            controllers=jcontrollers, slo=jslo,
                            upgrade=jupgrade, webhook=jwebhook)
TORCH = types.SimpleNamespace(**vars(wr.TORCH), certs=tcerts,
                              controllers=tcontrollers, slo=tslo,
                              upgrade=tupgrade, webhook=twebhook)
PKG = pytest.mark.parametrize("ns", [TORCH, JAX], ids=["torch", "jax"])

PER_TEST_TIMEOUT_S = 120

requires_crypto = pytest.mark.skipif(
    __import__("importlib").util.find_spec("cryptography") is None,
    reason="cryptography not installed (cert rotation is gated on it)")


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


def both(case, *args):
    got = case(TORCH, *args)
    want = case(JAX, *args)
    norm = lambda v: json.loads(json.dumps(v, default=repr))  # noqa: E731
    return norm(got), norm(want)


def _args(ns, flags: list):
    return ns.main.build_parser().parse_args(flags + ns.device)


@contextlib.contextmanager
def _runtime(ns, flags=None):
    """tests/test_control_plane.py's `runtime` fixture for one package:
    a started Runtime on a FakeKube, stopped at the end."""
    rt = ns.main.Runtime(_args(ns, flags or [
        "--fake-kube", "--port", "0", "--prometheus-port", "0",
        "--health-addr", ":0", "--disable-cert-rotation", "--log-denies"]))
    rt.args.metrics_backend = "none"
    rt.start()
    try:
        yield rt
    finally:
        rt.stop()


# ------------------------------------- tests/test_e2e_scenarios.py

DEMO = Path(__file__).resolve().parent.parent / "demo" / "agilebank"
TEMPLATE_GVK = ("templates.gatekeeper.sh", "v1beta1", "ConstraintTemplate")
CONSTRAINT_GROUP = "constraints.gatekeeper.sh"


def load(rel: str) -> dict:
    return yaml.safe_load((DEMO / rel).read_text())


def load_dir(rel: str) -> list[dict]:
    return [yaml.safe_load(p.read_text())
            for p in sorted((DEMO / rel).glob("*.yaml"))]


def admission_review(obj, operation="CREATE", username="alice", old=None,
                     uid="uid-e2e"):
    group, _, version = (obj.get("apiVersion") or "").rpartition("/")
    req = {
        "uid": uid,
        "kind": {"group": group, "version": version, "kind": obj["kind"]},
        "operation": operation,
        "name": obj["metadata"]["name"],
        "userInfo": {"username": username},
        "object": obj if operation != "DELETE" else None,
    }
    if old is not None:
        req["oldObject"] = old
    ns_ = obj["metadata"].get("namespace")
    if ns_:
        req["namespace"] = ns_
    return {"apiVersion": "admission.k8s.io/v1beta1",
            "kind": "AdmissionReview", "request": req}


@pytest.fixture(scope="module")
def rts():
    """One Runtime per package for the whole scenario table, like one
    deployed cluster for the whole bats run."""
    out = {}
    for ns in (TORCH, JAX):
        runtime = ns.main.Runtime(_args(ns, [
            "--fake-kube", "--port", "0", "--prometheus-port", "0",
            "--health-addr", ":0", "--disable-cert-rotation",
            "--exempt-namespace", "gatekeeper-system"]))
        runtime.args.metrics_backend = "none"
        runtime.kube.register_kind(("networking.k8s.io", "v1", "Ingress"),
                                   namespaced=True)
        for ns_name in ("gatekeeper-system", "payments", "production",
                        "staging"):
            runtime.kube.create({"apiVersion": "v1", "kind": "Namespace",
                                 "metadata": {"name": ns_name}})
        runtime.start()
        out[ns.name] = runtime
    yield out
    for runtime in out.values():
        runtime.stop()


def post(rt, path: str, payload: dict) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", rt.webhook.port,
                                      timeout=10)
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json"})
    return conn.getresponse().read()


def admit_both(rts, obj, path="/v1/admit", **kw) -> dict:
    """The same AdmissionReview to both packages' webhooks: the bodies
    must be equal byte for byte; returns the response."""
    bodies = {name: post(rt, path, admission_review(obj, **kw))
              for name, rt in rts.items()}
    assert bodies["torch"] == bodies["jax"]
    return json.loads(bodies["torch"])["response"]


def each(rts, fn):
    """fn(runtime) on both packages' runtimes; the results equal."""
    out = {name: json.loads(json.dumps(fn(rt), default=repr))
           for name, rt in rts.items()}
    assert out["torch"] == out["jax"]
    return out["torch"]


def _statuses(kube, gvk) -> dict:
    out = {}
    for o in kube.list(gvk):
        st = dict(o.get("status") or {})
        st.pop("auditTimestamp", None)
        out[o["metadata"]["name"]] = st
    return out


def test_01_templates_apply_and_crds_established(rts):
    def step(rt):
        for tpl in load_dir("templates"):
            rt.kube.create(tpl)
        rt.manager.drain()
        out = []
        for tpl in load_dir("templates"):
            kind = tpl["spec"]["crd"]["spec"]["names"]["kind"]
            crd = rt.kube.get(
                ("apiextensions.k8s.io", "v1beta1",
                 "CustomResourceDefinition"),
                f"{kind.lower()}.{CONSTRAINT_GROUP}")
            assert crd["spec"]["names"]["kind"] == kind
            stored = rt.kube.get(TEMPLATE_GVK, tpl["metadata"]["name"])
            assert stored["status"]["created"] is True
            assert rt.opa.knows_kind(kind)
            out.append([crd["spec"], stored["status"]])
        return out

    each(rts, step)


def test_02_constraints_apply_and_enforce(rts):
    def step(rt):
        for c in load_dir("constraints") + [
                load("dryrun/unique_ingress_host.yaml")]:
            rt.kube.create(c)
        rt.manager.drain()
        stored = rt.kube.get((CONSTRAINT_GROUP, "v1beta1",
                              "K8sRequiredLabels"), "all-must-have-owner")
        assert stored["status"]["byPod"][0]["enforced"] is True
        return stored["status"]

    each(rts, step)


def test_03_sync_config_populates_inventory(rts):
    def step(rt):
        rt.kube.create(load("sync.yaml"))
        rt.kube.create(load("existing_resources/payments_service.yaml"))
        rt.kube.create(load("dryrun/existing_ingress.yaml"))
        rt.manager.drain()
        dump = json.loads(rt.opa.dump())
        inv = dump["data"]["external"]["admission.k8s.gatekeeper.sh"]
        assert "payments" in inv["namespace"]["production"]["v1"]["Service"]
        assert "checkout" in \
            inv["namespace"]["payments"]["networking.k8s.io/v1"]["Ingress"]
        return inv

    each(rts, step)


def test_04_namespace_label_webhook_serving(rts):
    bad = {"apiVersion": "v1", "kind": "Namespace",
           "metadata": {"name": "sneaky",
                        "labels": {"admission.gatekeeper.sh/ignore":
                                   "yes-please"}}}
    assert admit_both(rts, bad, path="/v1/admitlabel")["allowed"] is False
    exempt = {"apiVersion": "v1", "kind": "Namespace",
              "metadata": {"name": "gatekeeper-system",
                           "labels": {"admission.gatekeeper.sh/ignore":
                                      "no-self-managing"}}}
    assert admit_both(rts, exempt, path="/v1/admitlabel")["allowed"] is True


def test_05_required_labels_denies_bad_namespace(rts):
    resp = admit_both(rts, load("bad_resources/namespace.yaml"))
    assert resp["allowed"] is False
    assert "owner" in resp["status"]["reason"]
    assert admit_both(rts, load("good_resources/namespace.yaml"))[
        "allowed"] is True


def test_06_container_limits(rts):
    assert admit_both(rts, load("bad_resources/opa_no_limits.yaml"))[
        "allowed"] is False
    assert admit_both(rts, load("bad_resources/opa_limits_too_high.yaml"))[
        "allowed"] is False
    assert admit_both(rts, load("good_resources/opa.yaml"))[
        "allowed"] is True


def test_07_allowed_repos_in_production(rts):
    resp = admit_both(rts, load("bad_resources/opa_wrong_repo.yaml"))
    assert resp["allowed"] is False
    assert "repo" in resp["status"]["reason"]


def test_08_unique_service_selector_join(rts):
    resp = admit_both(rts, load("bad_resources/duplicate_service.yaml"))
    assert resp["allowed"] is False
    assert "same selector" in resp["status"]["reason"]
    distinct = {"apiVersion": "v1", "kind": "Service",
                "metadata": {"name": "ledger", "namespace": "production"},
                "spec": {"selector": {"app": "ledger"},
                         "ports": [{"port": 80}]}}
    assert admit_both(rts, distinct)["allowed"] is True


def test_09_dryrun_constraint_allows_but_audits(rts):
    conflicting = load("dryrun/conflicting_ingress.yaml")
    # dryrun: admission must NOT deny the conflicting ingress
    assert admit_both(rts, conflicting)["allowed"] is True

    # ... but the audit must report it once it exists in the cluster
    def step(rt):
        rt.kube.create(conflicting)
        rt.manager.drain()
        rt.audit.audit_once()
        stored = rt.kube.get((CONSTRAINT_GROUP, "v1beta1",
                              "K8sUniqueIngressHost"), "unique-ingress-host")
        viol = stored["status"].get("violations") or []
        assert any(v["enforcementAction"] == "dryrun" for v in viol)
        assert {v["name"] for v in viol} >= {"checkout", "checkout-v2"}
        return viol

    each(rts, step)


def test_10_audit_reports_required_label_violations(rts):
    def step(rt):
        rt.kube.create({"apiVersion": "v1", "kind": "Namespace",
                        "metadata": {"name": "ownerless"}})
        rt.manager.drain()
        rt.audit.audit_once()
        stored = rt.kube.get((CONSTRAINT_GROUP, "v1beta1",
                              "K8sRequiredLabels"), "all-must-have-owner")
        viol = stored["status"].get("violations") or []
        assert any(v["name"] == "ownerless" for v in viol)
        assert stored["status"]["totalViolations"] >= 1
        assert any("owner" in v["message"] for v in viol)
        return [_statuses(rt.kube, (CONSTRAINT_GROUP, "v1beta1", k))
                for k in ("K8sRequiredLabels", "K8sContainerLimits",
                          "K8sAllowedRepos", "K8sUniqueServiceSelector",
                          "K8sUniqueIngressHost")]

    each(rts, step)


def test_11_remediated_resources_pass(rts):
    fixed = load("bad_resources/namespace.yaml")
    fixed["metadata"]["labels"] = {"owner": "treasury.agilebank.demo"}
    assert admit_both(rts, fixed)["allowed"] is True


def test_12_deleting_constraint_stops_enforcement(rts):
    def step(rt):
        rt.kube.delete((CONSTRAINT_GROUP, "v1beta1", "K8sRequiredLabels"),
                       "all-must-have-owner")
        rt.manager.drain()

    each(rts, step)
    assert admit_both(rts, load("bad_resources/namespace.yaml"))[
        "allowed"] is True


def test_13_health_endpoints(rts):
    """healthz/readyz on --health-addr (reference main.go:205-212)."""
    def step(rt):
        assert rt.health is not None, "--health-addr must serve"
        conn = http.client.HTTPConnection("127.0.0.1", rt.health.port,
                                          timeout=10)
        out = []
        for path in ("/healthz", "/readyz", "/nosuch"):
            conn.request("GET", path)
            resp = conn.getresponse()
            out.append([path, resp.status, resp.read().decode()])
        assert out[0][1:] == [200, "ok"] and out[1][1] == 200
        assert out[2][1] == 404
        return out

    each(rts, step)


def _example_fixtures(ns):
    """The example/ content dir: template + namespaceSelector
    constraint + resources drive admission and discovery audit on a
    fresh runtime."""
    ex = Path(__file__).resolve().parent.parent / "example"
    with _runtime(ns, ["--fake-kube", "--port", "0", "--prometheus-port",
                       "0", "--health-addr", ":0",
                       "--disable-cert-rotation"]) as runtime:
        kube = runtime.kube
        kube.create(yaml.safe_load(
            (ex / "templates/required-labels.yaml").read_text()))
        runtime.manager.drain()
        kube.create(yaml.safe_load(
            (ex / "constraints/pods-in-prod-namespaces.yaml").read_text()))
        runtime.manager.drain()
        kube.create(yaml.safe_load(
            (ex / "resources/prod-namespace.yaml").read_text()))
        bad_pod = yaml.safe_load((ex / "resources/bad-pod.yaml").read_text())
        out = runtime.webhook.validation.handle(admission_review(bad_pod))
        assert out["response"]["allowed"] is False
        assert "owner" in out["response"]["status"]["reason"]
        # a pod in a namespace the selector does not match sails through
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": "dev-sandbox"}})
        free_pod = json.loads(json.dumps(bad_pod))
        free_pod["metadata"]["namespace"] = "dev-sandbox"
        out2 = runtime.webhook.validation.handle(admission_review(free_pod))
        assert out2["response"]["allowed"] is True
        # discovery audit resolves the selector from the live cluster
        kube.create(bad_pod)
        runtime.audit.audit_once()
        stored = kube.get((CONSTRAINT_GROUP, "v1beta1",
                           "K8sRequiredLabelsList"),
                          "prod-pods-must-have-owner")
        viol = stored["status"].get("violations") or []
        assert any(v["name"] == "checkout-worker" for v in viol), viol
        return [out, out2, viol]


def test_14_example_fixtures_end_to_end():
    got, want = both(_example_fixtures)
    assert got == want


# ------------------------------------ tests/test_control_plane.py

CP_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8srequiredlabels"},
    "spec": {
        "crd": {"spec": {
            "names": {"kind": "K8sRequiredLabels"},
            "validation": {"openAPIV3Schema": {"properties": {
                "labels": {"type": "array", "items": {"type": "string"}}}}},
        }},
        "targets": [{
            "target": "admission.k8s.gatekeeper.sh",
            "rego": """
package k8srequiredlabels
violation[{"msg": msg}] {
  provided := {l | input.review.object.metadata.labels[l]}
  required := {l | l := input.parameters.labels[_]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("missing labels: %v", [missing])
}
""",
        }],
    },
}

CP_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels",
    "metadata": {"name": "ns-must-have-owner"},
    "spec": {
        "match": {"kinds": [{"apiGroups": [""], "kinds": ["Namespace"]}]},
        "parameters": {"labels": ["owner"]},
    },
}
CP_GVK = (CONSTRAINT_GROUP, "v1beta1", "K8sRequiredLabels")


def cp_review(obj, operation="CREATE", username="alice", old=None):
    return admission_review(obj, operation=operation, username=username,
                            old=old, uid="uid-1")


def nsobj(name, labels=None):
    o = {"apiVersion": "v1", "kind": "Namespace", "metadata": {"name": name}}
    if labels is not None:
        o["metadata"]["labels"] = labels
    return o


def _policy(runtime, constraint=CP_CONSTRAINT):
    runtime.kube.create(CP_TEMPLATE)
    runtime.manager.drain()
    if constraint is not None:
        runtime.kube.create(json.loads(json.dumps(constraint)))
        runtime.manager.drain()


def _full_lifecycle(ns):
    with _runtime(ns) as runtime:
        kube = runtime.kube
        out = []
        kube.create(CP_TEMPLATE)
        runtime.manager.drain()
        crd = kube.get(("apiextensions.k8s.io", "v1beta1",
                        "CustomResourceDefinition"),
                       "k8srequiredlabels.constraints.gatekeeper.sh")
        assert crd["spec"]["names"]["kind"] == "K8sRequiredLabels"
        templ = kube.get(TEMPLATE_GVK, "k8srequiredlabels")
        assert templ["status"]["created"] is True
        assert templ["status"]["byPod"][0]["observedGeneration"] == 0
        assert runtime.opa.knows_kind("K8sRequiredLabels")
        out.append([crd["spec"], templ["status"]])
        kube.create(CP_CONSTRAINT)
        runtime.manager.drain()
        stored = kube.get(CP_GVK, "ns-must-have-owner")
        assert stored["status"]["byPod"][0]["enforced"] is True
        handler = runtime.webhook.validation
        for obj in (nsobj("shipping"), nsobj("ok", {"owner": "me"})):
            out.append(handler.handle(cp_review(obj)))
        assert out[1]["response"]["allowed"] is False
        assert "missing labels" in out[1]["response"]["status"]["reason"]
        assert out[2]["response"]["allowed"] is True
        kube.create(nsobj("bad-1"))
        kube.create(nsobj("good-1", {"owner": "me"}))
        runtime.audit.audit_once()
        stored = kube.get(CP_GVK, "ns-must-have-owner")
        viol = stored["status"]["violations"]
        assert any(v["name"] == "bad-1" for v in viol)
        assert stored["status"]["totalViolations"] >= 1
        assert all(v["enforcementAction"] == "deny" for v in viol)
        out.append(_statuses(kube, CP_GVK))
        kube.delete(CP_GVK, "ns-must-have-owner")
        runtime.manager.drain()
        last = handler.handle(cp_review(nsobj("shipping")))
        assert last["response"]["allowed"] is True
        kube.delete(TEMPLATE_GVK, "k8srequiredlabels")
        runtime.manager.drain()
        assert not runtime.opa.knows_kind("K8sRequiredLabels")
        return out + [last]


def test_full_lifecycle():
    got, want = both(_full_lifecycle)
    assert got == want


def _violation_limit(ns):
    with _runtime(ns) as runtime:
        _policy(runtime)
        runtime.audit.limit = 3
        for i in range(10):
            runtime.kube.create(nsobj(f"bad-{i}"))
        runtime.audit.audit_once()
        stored = runtime.kube.get(CP_GVK, "ns-must-have-owner")
        assert len(stored["status"]["violations"]) == 3
        assert stored["status"]["totalViolations"] == 10
        return _statuses(runtime.kube, CP_GVK)


def test_audit_respects_violation_limit():
    got, want = both(_violation_limit)
    assert got == want


def _sync_config(ns):
    with _runtime(ns) as runtime:
        kube = runtime.kube
        kube.create({
            "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
            "metadata": {"name": "config",
                         "namespace": "gatekeeper-system"},
            "spec": {"sync": {"syncOnly": [
                {"group": "", "version": "v1", "kind": "Namespace"}]}},
        })
        kube.create(nsobj("synced-ns", {"team": "a"}))
        runtime.manager.drain()
        time.sleep(0.05)
        runtime.manager.drain()
        key = ("external", "admission.k8s.gatekeeper.sh", "cluster", "v1",
               "Namespace", "synced-ns")
        data = runtime.opa.driver.get_data(key)
        assert data is not None and data["metadata"]["name"] == "synced-ns"
        kube.delete(("", "v1", "Namespace"), "synced-ns")
        runtime.manager.drain()
        assert runtime.opa.driver.get_data(key) is None
        return data


def test_sync_config_populates_inventory():
    got, want = both(_sync_config)
    assert got == want


def _dryrun(ns):
    with _runtime(ns) as runtime:
        c = json.loads(json.dumps(CP_CONSTRAINT))
        c["spec"]["enforcementAction"] = "dryrun"
        _policy(runtime, c)
        out = runtime.webhook.validation.handle(cp_review(nsobj("shipping")))
        assert out["response"]["allowed"] is True
        runtime.kube.create(nsobj("bad-dry"))
        runtime.audit.audit_once()
        stored = runtime.kube.get(CP_GVK, "ns-must-have-owner")
        assert any(v["enforcementAction"] == "dryrun"
                   for v in stored["status"]["violations"])
        return [out, _statuses(runtime.kube, CP_GVK)]


def test_dryrun_constraint_does_not_deny():
    got, want = both(_dryrun)
    assert got == want


def _namespace_selector(ns):
    with _runtime(ns) as runtime:
        kube = runtime.kube
        c = json.loads(json.dumps(CP_CONSTRAINT))
        c["metadata"]["name"] = "owner-in-prod-ns"
        c["spec"]["match"] = {
            "kinds": [{"apiGroups": [""], "kinds": ["Pod"]}],
            "namespaceSelector": {"matchLabels": {"env": "prod"}},
        }
        _policy(runtime, c)
        kube.create(nsobj("prod-ns", {"env": "prod"}))
        kube.create(nsobj("dev-ns", {"env": "dev"}))
        for name, namespace in (("unlabeled-prod", "prod-ns"),
                                ("unlabeled-dev", "dev-ns")):
            kube.create({"apiVersion": "v1", "kind": "Pod",
                         "metadata": {"name": name,
                                      "namespace": namespace}})
        runtime.audit.audit_once()
        stored = kube.get(CP_GVK, "owner-in-prod-ns")
        viol = stored["status"]["violations"]
        names = {v["name"] for v in viol}
        assert "unlabeled-prod" in names, viol
        assert "unlabeled-dev" not in names, viol
        assert all("not cached in OPA" not in v["message"] for v in viol)
        return _statuses(kube, CP_GVK)


def test_discovery_audit_resolves_namespace_selector():
    got, want = both(_namespace_selector)
    assert got == want


def _resource_validation(ns):
    with _runtime(ns) as runtime:
        handler = runtime.webhook.validation
        bad_template = json.loads(json.dumps(CP_TEMPLATE))
        bad_template["spec"]["targets"][0]["rego"] = "package broken\n}{"
        out = [handler.handle(cp_review(bad_template)),
               handler.handle(cp_review(CP_TEMPLATE))]
        assert out[0]["response"]["allowed"] is False
        assert out[0]["response"]["status"]["code"] == 422
        assert out[1]["response"]["allowed"] is True
        _policy(runtime, None)
        bad_c = json.loads(json.dumps(CP_CONSTRAINT))
        bad_c["spec"]["enforcementAction"] = "warn-everyone"
        out.append(handler.handle(cp_review(bad_c)))
        assert out[2]["response"]["allowed"] is False
        return out


def test_gatekeeper_resource_validation():
    got, want = both(_resource_validation)
    assert got == want


def _delete_and_self(ns):
    with _runtime(ns) as runtime:
        _policy(runtime)
        review = cp_review(nsobj("victim"), operation="DELETE",
                           old=nsobj("victim"))
        review["request"]["object"] = None
        out = [runtime.webhook.validation.handle(review)]
        assert out[0]["response"]["allowed"] is False
        out.append(runtime.webhook.validation.handle(cp_review(
            nsobj("shipping"), username="system:serviceaccount:"
            "gatekeeper-system:gatekeeper-admin")))
        assert out[1]["response"]["allowed"] is True
        return out


def test_delete_and_self_service_account_reviews():
    """tests/test_control_plane.py's delete-operation (the old object
    is reviewed) and self-service-account (short-circuits) cases, on
    one runtime."""
    got, want = both(_delete_and_self)
    assert got == want


def _envelopes(ns):
    with _runtime(ns) as runtime:
        h = runtime.webhook.ns_label
        labeled = nsobj("sneaky", {"admission.gatekeeper.sh/ignore": "true"})
        out = [h.handle(cp_review(labeled)),
               h.handle(cp_review(nsobj("plain", {})))]
        assert out[0]["response"]["allowed"] is False
        assert out[1]["response"]["allowed"] is True
        review = cp_review(nsobj("anything"), username="system:"
                           "serviceaccount:gatekeeper-system:gatekeeper-admin")
        for handler in (runtime.webhook.validation, runtime.webhook.ns_label):
            v1 = dict(review, apiVersion="admission.k8s.io/v1")
            for req in (v1, review, {"request": review["request"]}):
                resp = handler.handle(req)
                out.append(resp)
                assert resp["kind"] == "AdmissionReview"
            assert out[-3]["apiVersion"] == "admission.k8s.io/v1"
            assert out[-2]["apiVersion"] == "admission.k8s.io/v1beta1"
            assert out[-1]["apiVersion"] == "admission.k8s.io/v1beta1"
        return out


def test_namespace_label_webhook_and_envelopes():
    """tests/test_control_plane.py's namespace-label webhook case and its
    envelope-echo case, on one runtime."""
    got, want = both(_envelopes)
    assert got == want


def _over_https(ns):
    with _runtime(ns) as runtime:
        _policy(runtime)
        kube = runtime.kube
        with tempfile.TemporaryDirectory() as td:
            rotator = ns.certs.CertRotator(kube, td)
            rotator.refresh_certs()
            secret = kube.get(("", "v1", "Secret"),
                              "gatekeeper-webhook-server-cert",
                              "gatekeeper-system")
            assert "tls.crt" in secret["data"]
            server = ns.webhook.WebhookServer(
                runtime.webhook.validation, runtime.webhook.ns_label,
                port=0, certfile=f"{td}/tls.crt", keyfile=f"{td}/tls.key")
            server.start()
            try:
                ctx = ssl.create_default_context(cafile=f"{td}/ca.crt")
                ctx.check_hostname = False  # SANs name the cluster DNS
                conn = http.client.HTTPSConnection(
                    "127.0.0.1", server.port, context=ctx, timeout=10)
                conn.request("POST", "/v1/admit",
                             json.dumps(cp_review(nsobj("shipping"))),
                             {"Content-Type": "application/json"})
                resp = json.loads(conn.getresponse().read())
                assert resp["response"]["allowed"] is False
                assert resp["response"]["uid"] == "uid-1"
            finally:
                server.server.shutdown()
        return [sorted(secret["data"]), resp]


@requires_crypto
def test_webhook_over_https():
    got, want = both(_over_https)
    assert got == want


VWH_GVK = ("admissionregistration.k8s.io", "v1beta1",
           "ValidatingWebhookConfiguration")


def _cert_injects_vwh(ns):
    kube = ns.kube.FakeKube()
    kube.create({
        "apiVersion": "admissionregistration.k8s.io/v1beta1",
        "kind": "ValidatingWebhookConfiguration",
        "metadata": {"name": "gatekeeper-validating-webhook-configuration"},
        "webhooks": [{"name": "validation.gatekeeper.sh",
                      "clientConfig": {"service": {"name": "gk"}}},
                     {"name": "check-ignore-label.gatekeeper.sh",
                      "clientConfig": {}}],
    })
    with tempfile.TemporaryDirectory() as td:
        ns.certs.CertRotator(kube, td).refresh_certs()
        files = sorted(os.listdir(td))
    vwh = kube.get(VWH_GVK, "gatekeeper-validating-webhook-configuration")
    bundles = [w["clientConfig"].get("caBundle") for w in vwh["webhooks"]]
    assert all(bundles)
    return [files, [w["name"] for w in vwh["webhooks"]]]


@requires_crypto
def test_cert_rotation_injects_vwh():
    got, want = both(_cert_injects_vwh)
    assert got == want


# a rotation under the suite's load (six workers) can take many seconds
# of RSA key generation: each wait below has this deadline, the two
# together inside the test's hard timeout
ROTATION_DEADLINE_S = 50


@requires_crypto
@PKG
def test_vwh_recreate_reinjects_ca_bundle(ns):
    """ReconcileVWH analog (reference certs.go:454-530): a VWH recreated
    between 12-hour refresh ticks must get the caBundle re-injected by
    the watch-driven reconciler, not wait for the next tick; a deleted
    secret is regenerated and re-injected."""
    vwh = {
        "apiVersion": "admissionregistration.k8s.io/v1beta1",
        "kind": "ValidatingWebhookConfiguration",
        "metadata": {"name": "gatekeeper-validating-webhook-configuration"},
        "webhooks": [{"name": "validation.gatekeeper.sh",
                      "clientConfig": {"service": {"name": "gk"}}}],
    }
    with _runtime(ns) as runtime, tempfile.TemporaryDirectory() as td:
        kube = runtime.kube
        kube.create(json.loads(json.dumps(vwh)))
        rotator = ns.certs.CertRotator(kube, td)
        rotator.refresh_certs()
        assert kube.get(VWH_GVK, vwh["metadata"]["name"])["webhooks"][0][
            "clientConfig"].get("caBundle")
        rotator.start_reconciler(runtime.manager.wm)
        try:
            # recreate the VWH with no bundle; the reconciler must
            # restore it without any timer tick
            kube.delete(VWH_GVK, vwh["metadata"]["name"])
            kube.create(json.loads(json.dumps(vwh)))
            deadline = time.time() + ROTATION_DEADLINE_S
            bundle = None
            while time.time() < deadline:
                cur = kube.get(VWH_GVK, vwh["metadata"]["name"])
                bundle = cur["webhooks"][0]["clientConfig"].get("caBundle")
                if bundle:
                    break
                time.sleep(0.02)
            assert bundle, "caBundle not re-injected on VWH recreate"
            # secret deleted: reconciler regenerates and re-injects
            kube.delete(("", "v1", "Secret"),
                        "gatekeeper-webhook-server-cert",
                        "gatekeeper-system")
            deadline = time.time() + ROTATION_DEADLINE_S
            ok = False
            while time.time() < deadline:
                try:
                    sec = kube.get(("", "v1", "Secret"),
                                   "gatekeeper-webhook-server-cert",
                                   "gatekeeper-system")
                except ns.kube.NotFound:
                    time.sleep(0.02)
                    continue
                if (sec.get("data") or {}).get("tls.crt"):
                    ok = True
                    break
                time.sleep(0.02)
            assert ok, "secret not regenerated after delete"
        finally:
            rotator.stop()
            # the reconciler writes the cert files after the secret:
            # let it finish before the directory is removed
            rotator._reconcile_thread.join(30)


def _upgrade(ns):
    kube = ns.kube.FakeKube()
    kube.register_kind(TEMPLATE_GVK, namespaced=False)
    kube.register_kind(CP_GVK, namespaced=False)
    kube.create(CP_TEMPLATE)
    kube.create(CP_CONSTRAINT)
    rv_before = kube.get(TEMPLATE_GVK,
                         "k8srequiredlabels")["metadata"]["resourceVersion"]
    touched = ns.upgrade.UpgradeManager(kube).upgrade()
    assert touched == 2
    rv_after = kube.get(TEMPLATE_GVK,
                        "k8srequiredlabels")["metadata"]["resourceVersion"]
    assert rv_after != rv_before
    return [touched, rv_before, rv_after, [list(c) for c in kube.calls]]


def test_upgrade_manager_touches_objects():
    got, want = both(_upgrade)
    assert got == want


def _metrics_rendered(ns):
    with _runtime(ns) as runtime:
        _policy(runtime)
        runtime.kube.create(nsobj("bad-metrics"))
        runtime.audit.audit_once()
        runtime.webhook.validation.handle(cp_review(nsobj("nope")))
        text = ns.metrics.REGISTRY.render()
        names = ("violations", "audit_duration_seconds",
                 "audit_last_run_time", "request_count",
                 "request_duration_seconds", "constraints",
                 "constraint_templates",
                 "gatekeeper_tpu_device_programs_warm")
        missing = [n for n in names if n not in text]
        assert not missing, f"metrics missing: {missing}"
        return missing


def test_metrics_rendered():
    got, want = both(_metrics_rendered)
    assert got == want


def _fixpoint(ns):
    with _runtime(ns) as runtime:
        _policy(runtime)
        kube = runtime.kube
        rv0 = kube.get(CP_GVK, "ns-must-have-owner")["metadata"][
            "resourceVersion"]
        trv0 = kube.get(TEMPLATE_GVK,
                        "k8srequiredlabels")["metadata"]["resourceVersion"]
        time.sleep(0.5)  # idle: no event should cause further writes
        runtime.manager.drain()
        rv1 = kube.get(CP_GVK, "ns-must-have-owner")["metadata"][
            "resourceVersion"]
        trv1 = kube.get(TEMPLATE_GVK,
                        "k8srequiredlabels")["metadata"]["resourceVersion"]
        assert rv0 == rv1, "constraint status keeps rewriting"
        assert trv0 == trv1, "template status keeps rewriting"
        return [rv0 == rv1, trv0 == trv1]


def test_status_writes_reach_fixpoint():
    got, want = both(_fixpoint)
    assert got == want


def _not_resurrected(ns):
    with _runtime(ns) as runtime:
        _policy(runtime)
        kube = runtime.kube
        stale = kube.get(CP_GVK, "ns-must-have-owner")
        kube.delete(CP_GVK, "ns-must-have-owner")
        runtime.manager.drain()
        # the race: a stale MODIFIED delivered after the delete
        runtime.manager.constraint_ctrl.reconcile(
            ns.kube.WatchEvent("MODIFIED", stale))
        out = runtime.webhook.validation.handle(
            cp_review(nsobj("anything")))
        assert out["response"]["allowed"] is True, \
            "deleted constraint still denying admissions"
        return out


def test_deleted_constraint_not_resurrected_by_stale_event():
    got, want = both(_not_resurrected)
    assert got == want


ADVERSARIAL = [
    b"not json at all",
    b"\xff\xfe garbage bytes",
    b"{}",
    json.dumps({"request": None}).encode(),
    json.dumps({"request": {"uid": "u"}}).encode(),
    json.dumps({"request": {"uid": "u", "kind": "notadict",
                            "object": []}}).encode(),
    json.dumps({"request": {"uid": "u",
                            "kind": {"group": 1, "version": [], "kind": {}},
                            "object": {"metadata": None}}}).encode(),
]


def _adversarial(ns):
    with _runtime(ns) as runtime:
        out = []
        for body in ADVERSARIAL:
            for path in ("/v1/admit", "/v1/admitlabel"):
                conn = http.client.HTTPConnection(
                    "127.0.0.1", runtime.webhook.port, timeout=10)
                conn.request("POST", path, body,
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                data = r.read()
                out.append([path, r.status, data.decode("utf-8", "replace")])
                if r.status == 400:
                    continue  # unparseable body rejected at the transport
                assert r.status == 200
                assert json.loads(data)["response"]["allowed"] is True
        # and the server still serves real traffic afterwards
        out.append(json.loads(post(runtime, "/v1/admit",
                                   cp_review(nsobj("post-fuzz")))))
        assert out[-1]["response"] is not None
        return out


def test_webhook_survives_adversarial_payloads():
    got, want = both(_adversarial)
    assert got == want


def _reuse_port(ns):
    import socket

    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        flags = ["--fake-kube", "--port", str(port), "--prometheus-port",
                 "0", "--health-addr", ":0", "--disable-cert-rotation",
                 "--webhook-reuse-port", "--operation", "webhook"]
        with _runtime(ns, flags), _runtime(ns, flags):
            s.close()
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("POST", "/v1/admit",
                         json.dumps(cp_review(nsobj("x"))),
                         {"Content-Type": "application/json"})
            out = json.loads(conn.getresponse().read())
            assert out["response"]["allowed"] is True  # no constraints
            return out


def test_webhook_reuse_port_flag():
    got, want = both(_reuse_port)
    assert got == want


def _from_cache(ns):
    with _runtime(ns, ["--fake-kube", "--port", "0", "--prometheus-port",
                       "0", "--health-addr", ":0",
                       "--disable-cert-rotation",
                       "--audit-from-cache", "true"]) as rt:
        kube = rt.kube
        c = json.loads(json.dumps(CP_CONSTRAINT))
        # match Namespaces AND Pods so the sync filter is what decides
        c["spec"]["match"]["kinds"] = [
            {"apiGroups": [""], "kinds": ["Namespace", "Pod"]}]
        kube.create(CP_TEMPLATE)
        rt.manager.drain()
        kube.create(c)
        kube.create({
            "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
            "metadata": {"name": "config",
                         "namespace": "gatekeeper-system"},
            "spec": {"sync": {"syncOnly": [
                {"group": "", "version": "v1", "kind": "Namespace"}]}},
        })
        kube.create(nsobj("unlabeled-ns"))
        kube.create({"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": "unlabeled-pod",
                                  "namespace": "unlabeled-ns"}})
        rt.manager.drain()
        rt.audit.audit_once()
        stored = kube.get(CP_GVK, "ns-must-have-owner")
        names = {v["name"] for v in stored["status"]["violations"]}
        assert "unlabeled-ns" in names, names
        # pods are not synced: invisible to the from-cache sweep
        assert "unlabeled-pod" not in names, names
        assert stored["status"]["totalViolations"] == len(names)
        return _statuses(kube, CP_GVK)


def test_audit_from_cache_sweeps_synced_inventory_only():
    got, want = both(_from_cache)
    assert got == want


def _teardown(ns):
    with _runtime(ns) as runtime:
        kube = runtime.kube
        _policy(runtime, None)
        stored = kube.get(TEMPLATE_GVK, "k8srequiredlabels")
        assert ns.controllers.FINALIZER in (
            stored["metadata"].get("finalizers") or [])
    stored = kube.get(TEMPLATE_GVK, "k8srequiredlabels")
    assert ns.controllers.FINALIZER not in (
        stored["metadata"].get("finalizers") or [])
    return stored["metadata"].get("finalizers")


def test_teardown_scrubs_finalizers_on_shutdown():
    got, want = both(_teardown)
    assert got == want


# ------------------------------------ tests/test_observability.py SLOs


def _slo_registry(ns):
    reg = ns.metrics.Registry()
    for v in (0.01, 0.02, 0.05, 0.05, 0.05):  # all under 0.1
        reg.observe("request_duration_seconds", "h", v,
                    admission_status="allow")
    reg.counter_add("request_count", "c", 100, admission_status="allow")
    return reg


def _burn_rates(ns):
    reg = _slo_registry(ns)
    eng = ns.slo.SloEngine(ns.slo.default_objectives(
        admission_p99_s=0.1, availability_target=0.99),
        registry=reg, sample_interval_s=15)
    eng.sample(now=0.0)
    rates = [eng.burn_rates(now=400.0)]
    for slo, by_window in rates[0].items():
        for w, ent in by_window.items():
            assert ent["burn_rate"] == 0.0, (slo, w, ent)
    reg.counter_add("request_count", "c", 10, admission_status="allow")
    reg.counter_add("request_count", "c", 10, admission_status="shed")
    rates.append(eng.burn_rates(now=400.0))
    av = rates[-1]["availability"]
    assert av["5m"]["burn_rate"] == pytest.approx(50.0)
    assert av["5m"]["bad"] == 10 and av["5m"]["total"] == 20
    for _ in range(5):
        reg.observe("request_duration_seconds", "h", 0.05,
                    admission_status="allow")
    for _ in range(3):
        reg.observe("request_duration_seconds", "h", 2.0,
                    admission_status="allow")
    rates.append(eng.burn_rates(now=401.0))
    lat = rates[-1]["admission_p99_latency"]["5m"]
    assert lat["bad"] == 3 and lat["total"] == 8
    assert lat["burn_rate"] == pytest.approx(37.5)
    eng.export(now=402.0)
    text = reg.render()
    assert 'gatekeeper_tpu_slo_burn_rate{slo="availability"' \
        ',window="5m"}' in text
    assert 'gatekeeper_tpu_slo_target{slo="admission_p99_latency"} ' \
        '0.99' in text
    return [rates, text]


def test_slo_burn_rates_multi_window():
    got, want = both(_burn_rates)
    assert got == want


def _anchoring(ns):
    reg = _slo_registry(ns)
    eng = ns.slo.SloEngine(ns.slo.default_objectives(
        availability_target=0.99), registry=reg, sample_interval_s=15)
    eng.sample(now=0.0)
    for t in range(1, 240):
        eng.sample(now=t * 15.0)
    reg.counter_add("request_count", "c", 10, admission_status="error")
    av = eng.burn_rates(now=240 * 15.0)["availability"]
    assert av["5m"]["burn_rate"] > 0
    assert av["5m"]["window_actual_s"] >= 300
    assert av["1h"]["window_actual_s"] >= 3600
    assert av["5m"]["total"] <= av["1h"]["total"]
    return av


def test_slo_window_anchoring_prefers_full_window():
    got, want = both(_anchoring)
    assert got == want


@PKG
def test_slo_objective_validation(ns):
    with pytest.raises(ValueError):
        ns.slo.SloObjective("x", "latency", 1.0, "m", threshold_s=0.1)
    with pytest.raises(ValueError):
        ns.slo.SloObjective("x", "latency", 0.99, "m")  # no threshold
    with pytest.raises(ValueError):
        ns.slo.SloObjective("x", "weird", 0.99, "m")


def _debug_slo(ns):
    eng = ns.slo.SloEngine(ns.slo.default_objectives(),
                           registry=_slo_registry(ns), sample_interval_s=15)
    eng.sample(now=0.0)
    status = eng.status(now=10.0)
    names = {o["name"] for o in status["objectives"]}
    assert names == {"admission_p99_latency", "availability",
                     "violation_detection_p99"}
    for o in status["objectives"]:
        assert "windows" in o and "target" in o
    assert status["alert_reference_burn_rates"]["5m"] == 14.4
    return status


def test_debug_slo_provider_shape():
    got, want = both(_debug_slo)
    assert got == want


def _slo_stop(ns):
    reg = _slo_registry(ns)
    eng = ns.slo.SloEngine(ns.slo.default_objectives(
        availability_target=0.99), registry=reg, sample_interval_s=15)
    eng.sample(now=0.0)
    reg.counter_add("request_count", "c", 10, admission_status="shed")
    eng.export(now=400.0)
    m = re.search(r'gatekeeper_tpu_slo_burn_rate\{slo="availability",'
                  r'window="5m"\} (\S+)', reg.render())
    assert m and float(m.group(1)) > 0
    eng.stop()
    text = reg.render()
    lines = [ln for ln in text.splitlines()
             if ln.startswith("gatekeeper_tpu_slo_burn_rate")]
    for line in lines:
        assert line.endswith(" 0"), line
    return lines


def test_slo_engine_stop_zeroes_burn_gauges():
    got, want = both(_slo_stop)
    assert got == want


# ------------------------------------------- what the port rewired


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    """The Runtime's driver is on the card unless `--device cpu` says
    otherwise: with no card visible the default raises at construction,
    in the Runtime and in warm-cache, and never falls back to the
    host."""
    import torch

    from gatekeeper_tpu_torch.client.drivers import DriverError

    import logging as _logging

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parser = TORCH.main.build_parser()
    args = parser.parse_args(["--fake-kube", "--operation", "audit"])
    assert args.device == "cuda"
    with pytest.raises(DriverError, match="no CUDA card"):
        TORCH.main.Runtime(args)
    # warm-cache is a CLI entrypoint: its glog.setup() turns off the
    # "gatekeeper" logger's propagation, which would blind caplog for
    # every later test in this process — snapshot and restore
    gklog = _logging.getLogger("gatekeeper")
    saved = (gklog.handlers[:], gklog.propagate, gklog.level)
    try:
        with pytest.raises(DriverError, match="no CUDA card"):
            TORCH.main.warm_cache_main(["--state-dir", str(tmp_path)])
    finally:
        gklog.handlers[:], gklog.propagate, gklog.level = saved
    rt = TORCH.main.Runtime(parser.parse_args(
        ["--fake-kube", "--operation", "audit", "--device", "cpu"]))
    assert rt.opa.driver.device.type == "cpu"


# each flag whose path needs the multi-process plane or the policy
# service, and what the Runtime must have built for it
WAITING = [
    (["--admission-workers", "2"], "frontends"),
    (["--admission-engines", "2"], "engines"),
    (["--audit-shards", "2"], "audit_shards"),
    (["--ingest-grpc", "--ingest-port", "0"], "ingest_server"),
    (["--adaptive-control"], "adaptive"),
]


def _child_commands(rt) -> list:
    """The command lines of the Runtime's live children (engines, audit
    shards, frontends), read from /proc."""
    pids = []
    for sup in (rt.engines, rt.audit_shards):
        if sup is not None:
            pids += list(sup.child_pids().values())
    if rt.frontends is not None:
        pids += [p.pid for p in rt.frontends._procs
                 if p is not None and p.poll() is None]
    return [Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
            for pid in pids]


@pytest.mark.parametrize("flags,plane", WAITING,
                         ids=[f[0].lstrip("-") for f, _m in WAITING])
def test_unported_path_fails_at_construction(flags, plane):
    """Each flag whose path needs the multi-process plane or the
    service builds that plane on `--device cpu`, serves and stops
    cleanly. Its children run the port's modules, on the CPU (the
    primary's --device reaches them)."""
    with _runtime(TORCH, ["--fake-kube", "--port", "0", "--health-addr",
                          ":0", "--prometheus-port", "0",
                          "--disable-cert-rotation"] + flags) as rt:
        assert getattr(rt, plane) is not None
        cmds = _child_commands(rt)
        for cmd in cmds:
            module = cmd[cmd.index(b"-m") + 1].decode()
            assert module.startswith("gatekeeper_tpu_torch.control."), cmd
            if module.endswith(".engine"):
                dev = [cmd[i + 1] for i, a in enumerate(cmd)
                       if a == b"--device"]
                assert dev[-1] == b"cpu", cmd
        # two frontends; one frontend and engine 1; two shards
        assert len(cmds) == {"frontends": 2, "engines": 2,
                             "audit_shards": 2}.get(plane, 0)
        children = [sup for sup in (rt.engines, rt.audit_shards)
                    if sup is not None]
    for sup in children:
        assert sup.child_pids() == {}


def test_scan_subcommand_returns_the_reference_exit_code(tmp_path):
    """main's `scan` subcommand runs the port's control/scan.py (with
    `--device cpu`) and returns the JAX package's exit code on the same
    input: 1 for a tree with a denied manifest, 0 for a clean one."""
    import logging as _logging

    from gatekeeper_tpu_torch import policies

    pol = tmp_path / "pol.yaml"
    with open(pol, "w") as f:
        yaml.safe_dump_all([
            policies.load("general/requiredlabels"),
            {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
             "kind": "K8sRequiredLabels", "metadata": {"name": "o"},
             "spec": {"parameters": {"labels": [{"key": "owner"}]}}}], f)
    codes = {}
    for tree, labels in (("denied", None), ("clean", {"owner": "me"})):
        src = tmp_path / tree
        src.mkdir()
        with open(src / "m.yaml", "w") as f:
            yaml.safe_dump_all([{
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "p", "namespace": "a",
                             **({"labels": labels} if labels else {})},
                "spec": {"containers": [{"name": "c", "image": "x"}]}}], f)
        argv = ["scan", str(src), "--policies", str(pol), "--loaders", "0",
                "--output", str(tmp_path / f"{tree}.jsonl")]
        # both scan_mains call glog.setup(), which turns off the shared
        # "gatekeeper" logger's propagation and would blind caplog for
        # every later test in this process: snapshot and restore it
        gklog = _logging.getLogger("gatekeeper")
        saved = (gklog.handlers[:], gklog.propagate, gklog.level)
        try:
            codes[tree] = (TORCH.main.main(argv + ["--device", "cpu"]),
                           JAX.main.main(argv))
        finally:
            gklog.handlers[:], gklog.propagate, gklog.level = saved
    assert codes == {"denied": (1, 1), "clean": (0, 0)}


def test_auto_engine_count_on_the_cpu_is_one():
    """--admission-engines 0 asks for one engine per visible card; a
    driver on the CPU counts one, so the process serves in-process with
    no backplane (the JAX package counts jax.devices())."""
    with _runtime(TORCH, ["--fake-kube", "--port", "0", "--health-addr",
                          ":0", "--prometheus-port", "0",
                          "--disable-cert-rotation", "--admission-engines",
                          "0"]) as rt:
        assert TORCH.main._card_count(rt.opa.driver) == 1
        assert rt.backplane is None and rt.engines is None
        assert rt.webhook is not None


def test_debug_profile_writes_a_torch_profiler_trace():
    """/debug/profile arms a device-trace window on torch.profiler
    (utils/profiling.device_trace): the window's directory gets a
    Chrome trace, and a second request inside the window is refused."""
    with _runtime(TORCH) as rt:
        armed = rt.debug_providers()["profile"]("seconds=0.5")
        assert armed["armed"] is True and armed["seconds"] == 0.5
        assert "pt.trace.json" in armed["viewer"]
        assert rt._debug_profile("seconds=1")["armed"] is False
        for t in threading.enumerate():
            if t.name == "debug-profile":
                t.join(60)
        traces = [f for f in os.listdir(armed["log_dir"])
                  if f.endswith(".pt.trace.json")]
        assert traces, os.listdir(armed["log_dir"])


def test_compile_cache_dir_is_tritons_cache(monkeypatch, tmp_path):
    """--compile-cache-dir points Triton's kernel cache at the volume
    unless TRITON_CACHE_DIR is set already."""
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    flags = ["--fake-kube", "--operation", "audit",
             "--compile-cache-dir", str(tmp_path / "cc")]
    TORCH.main.Runtime(_args(TORCH, flags))
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "cc")
    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "mine"))
    TORCH.main.Runtime(_args(TORCH, flags))
    assert os.environ["TRITON_CACHE_DIR"] == str(tmp_path / "mine")
