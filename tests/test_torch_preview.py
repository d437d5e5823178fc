"""The port's what-if preview (control/preview.py over audit_kind).

The port's copies of tests/test_streaming.py's preview cases, on
`TorchDriver(device="cpu")` (the kernels' plain versions) over the
general library and `synth_mixed_objects`; where a case produces a
verdict, the JAX package's PreviewEngine on `TpuDriver()` must produce
the same one on the same inputs (violation count, reviewed objects,
path, cold flag and samples; exact).
"""

from __future__ import annotations

import http.client
import json

import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.control.preview import PreviewEngine as JPreview
from gatekeeper_tpu.control.preview import PreviewError as JPreviewError
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.control.metrics import REGISTRY
from gatekeeper_tpu_torch.control.preview import PreviewEngine, PreviewError
from gatekeeper_tpu_torch.control.webhook import WebhookServer
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.parallel.workload import (
    GENERAL_CONSTRAINTS,
    REQUIRED_LABELS_TEMPLATE,
    synth_mixed_objects,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget


def _mixed_client(n=3000, jax=False):
    if jax:
        driver, backend, target, pol = TpuDriver(), JBackend, JTarget, jpol
    else:
        driver, backend, target, pol = (TorchDriver(device="cpu"),
                                        TBackend, TTarget, tpol)
    client = backend(driver).new_client([target()])
    for name in pol.names():
        if name.startswith("general/"):
            client.add_template(pol.load(name))
    for o in synth_mixed_objects(n):
        client.add_data(o)
    return driver, client


def _verdict(out: dict) -> dict:
    return {k: v for k, v in out.items() if k != "duration_s"}


def key(results):
    return sorted(
        (r.msg, (r.resource or {}).get("kind") or "",
         ((r.resource or {}).get("metadata") or {}).get("namespace") or "",
         ((r.resource or {}).get("metadata") or {}).get("name") or "")
        for r in results)


def test_preview_device_matches_interpreter_on_general_library():
    """Every general-library candidate swept through audit_kind's device
    path (K2 + K1's plain versions, K4's for the joins) gives the
    interpreter oracle's violation set exactly, and the public entry
    gives the JAX package's verdict."""
    driver, client = _mixed_client()
    driver._use_device_for_batch = lambda n: True  # force the device
    jdriver, jclient = _mixed_client(jax=True)
    jdriver._use_device_for_batch = lambda n: True
    pv, jpv = PreviewEngine(client), JPreview(jclient)
    checked = 0
    paths = set()
    for kind, cname, params in GENERAL_CONSTRAINTS:
        con = {"kind": kind, "metadata": {"name": cname},
               "spec": ({"parameters": params} if params else {})}
        ent, _ = pv._ensure_template(None, kind)
        jpv._ensure_template(None, kind)
        alias_con = dict(con, kind=ent["alias"],
                         apiVersion="constraints.gatekeeper.sh/v1beta1")
        device, path = driver.audit_kind(
            next(iter(client.targets)), ent["alias"], [alias_con])
        oracle = pv._interp_eval(ent["alias"], [alias_con])
        assert key(device) == key(oracle), \
            f"{kind}: device/{path} diverges from interpreter"
        paths.add(path)
        checked += 1
        payload = {"constraint": dict(
            con, apiVersion="constraints.gatekeeper.sh/v1beta1")}
        out = pv.preview(payload)
        assert out["violations"] == len(oracle)
        assert _verdict(out) == _verdict(jpv.preview(payload))
    assert checked == len(GENERAL_CONSTRAINTS)
    assert paths == {"device", "join"}


def test_preview_isolates_serving_library():
    """Compiling and sweeping a candidate bumps no client generation and
    adds no serving kind; a repeat hits the compiled alias."""
    driver, client = _mixed_client(200)
    pv = PreviewEngine(client)
    gen0 = client.generation
    kinds0 = set(client.template_kinds())
    payload = {"constraint": {
        "kind": "K8sRequiredLabels", "metadata": {"name": "w"},
        "spec": {"match": {"kinds": [{"apiGroups": [""],
                                      "kinds": ["Pod"]}]},
                 "parameters": {"labels": [{"key": "owner"}]}}}}
    out = pv.preview(payload)
    assert out["reviewed"] > 0
    assert client.generation == gen0
    assert set(client.template_kinds()) == kinds0
    out2 = pv.preview(payload)
    assert out2["cold"] is False
    _jd, jclient = _mixed_client(200, jax=True)
    jpv = JPreview(jclient)
    assert [_verdict(jpv.preview(payload)) for _ in range(2)] == \
        [_verdict(out), _verdict(out2)]


def _candidate(kind):
    tpl = json.loads(json.dumps(REQUIRED_LABELS_TEMPLATE))
    tpl["spec"]["crd"]["spec"]["names"]["kind"] = kind
    tpl["metadata"]["name"] = kind.lower()
    return {"template": tpl,
            "constraint": {"kind": kind, "metadata": {"name": "w"},
                           "spec": {"parameters": {"labels": [
                               {"key": "no-such-label"}]}}}}


def test_preview_lru_eviction_recompiles_evicted_candidate():
    """A candidate pushed out of the compiled-alias LRU recompiles cold
    and still gives the full violation set."""
    driver, client = _mixed_client(100)
    pv = PreviewEngine(client)
    pv.MAX_COMPILED = 1
    first = pv.preview(_candidate("K8sEvictA"))
    assert first["cold"] is True and first["violations"] > 0
    pv.preview(_candidate("K8sEvictB"))  # evicts K8sEvictA
    assert len(pv._compiled) == 1
    again = pv.preview(_candidate("K8sEvictA"))
    assert again["cold"] is True
    assert again["violations"] == first["violations"]
    _jd, jclient = _mixed_client(100, jax=True)
    jpv = JPreview(jclient)
    jpv.MAX_COMPILED = 1
    assert _verdict(jpv.preview(_candidate("K8sEvictA"))) == \
        _verdict(first)


def test_preview_candidate_template_and_errors():
    """A not-yet-installed template rides the request; caller mistakes
    are PreviewErrors (HTTP 400), never 500s."""
    driver, client = _mixed_client(100)
    pv = PreviewEngine(client)
    candidate = json.loads(json.dumps(REQUIRED_LABELS_TEMPLATE))
    candidate["spec"]["crd"]["spec"]["names"]["kind"] = "K8sNovelKind"
    candidate["metadata"]["name"] = "k8snovelkind"
    payload = {"template": candidate,
               "constraint": {"kind": "K8sNovelKind",
                              "metadata": {"name": "novel"},
                              "spec": {"parameters": {"labels": [
                                  {"key": "nonexistent-label"}]}}}}
    out = pv.preview(payload)
    assert out["kind"] == "K8sNovelKind" and out["violations"] > 0
    assert "K8sNovelKind" not in client.template_kinds()
    bad = [{},
           {"constraint": {"kind": "NoSuchTemplateKind",
                           "metadata": {"name": "x"}}},
           {"constraint": {"kind": "K8sRequiredLabels",
                           "metadata": {"name": "x"},
                           "spec": {"enforcementAction": "bogus"}}}]
    errors = []
    for p in bad:
        with pytest.raises(PreviewError) as e:
            pv.preview(p)
        errors.append(str(e.value))
    status, body = pv.handle_http(b"{not json")
    assert status == 400
    status2, body2 = pv.handle_http(json.dumps({
        "constraint": {"kind": "K8sRequiredLabels",
                       "metadata": {"name": "w"},
                       "spec": {"parameters": {"labels": [
                           {"key": "team"}]}}}}).encode())
    assert status2 == 200
    assert json.loads(body2)["reviewed"] >= 0
    assert 'gatekeeper_tpu_preview_requests_total{outcome="invalid"}' in \
        REGISTRY.render()
    # the JAX package answers the same candidate and the same mistakes
    _jd, jclient = _mixed_client(100, jax=True)
    jpv = JPreview(jclient)
    assert _verdict(jpv.preview(payload)) == _verdict(out)
    jerrors = []
    for p in bad:
        with pytest.raises(JPreviewError) as e:
            jpv.preview(p)
        jerrors.append(str(e.value))
    assert jerrors == errors
    assert jpv.handle_http(b"{not json") == (status, body)


def test_preview_served_on_dedicated_listener():
    """A WebhookServer with only the preview engine 404s admission
    routes and answers /v1/preview."""
    driver, client = _mixed_client(100)
    server = WebhookServer(None, None, port=0,
                           preview=PreviewEngine(client))
    server.start()
    try:
        conn = http.client.HTTPConnection("localhost", server.port,
                                          timeout=30)
        conn.request("POST", "/v1/admit", body=b"{}")
        resp = conn.getresponse()
        assert resp.status == 404
        resp.read()
        conn.request("POST", "/v1/preview", body=json.dumps({
            "constraint": {"kind": "K8sRequiredLabels",
                           "metadata": {"name": "w"},
                           "spec": {"parameters": {"labels": [
                               {"key": "team"}]}}}}).encode())
        resp = conn.getresponse()
        assert resp.status == 200
        out = json.loads(resp.read())
        assert out["reviewed"] == 100 and out["path"] in ("device",
                                                          "interp")
        conn.close()
    finally:
        server.stop(drain_timeout=1.0)
