"""The driver surfaces that the control plane calls, against TpuDriver.

`templates_debug`, `audit_broadcast_spec`, `set_audit_shard`,
`audit_kind`, the `on_kind_results` observer, `note_busy` /
`duty_cycle` and `eval_compiled_pairs_slabbed` of the port's
TorchDriver (on the CPU, the kernels' plain versions) must equal the
JAX package's TpuDriver's on the same libraries and inventory: the
general library and the pod-security-policy library, over the fleet-scan
corpus. Both drivers are pinned to their device paths
(`_use_device_for_batch = lambda n: True`). Every comparison is exact.

Also here: the metrics hooks that come back with `control/metrics.py`,
each counter read after the event that moves it.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.control import metrics as jmetrics
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.parallel.workload import REQUIRED_LABELS_TEMPLATE
from gatekeeper_tpu.parallel.workload import synth_constraints
from gatekeeper_tpu.parallel.workload import synth_objects
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.control import metrics as tmetrics
from gatekeeper_tpu_torch.ir import TorchDriver, aot
from gatekeeper_tpu_torch.parallel.workload import (
    GENERAL_CONSTRAINTS,
    PSP_CONSTRAINTS,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils.faults import FAULTS

from .test_torch_frontend import fixture_objects

TARGET = "admission.k8s.gatekeeper.sh"
LIBRARIES = {"general": GENERAL_CONSTRAINTS, "pod-security-policy":
             PSP_CONSTRAINTS}
N_OBJECTS = 240


def key(results):
    return [(r.msg, r.constraint["metadata"]["name"], r.constraint["kind"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


def constraint(kind, name, params):
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1", "kind": kind,
            "metadata": {"name": name},
            "spec": ({"parameters": params} if params else {})}


def library_pair(lib: str, objs=None):
    """(TpuDriver, its client), (TorchDriver, its client) with one
    library, its constraints and the corpus ingested in the same
    order."""
    out = []
    for backend, target, drv, pol in (
            (JBackend, JTarget, TpuDriver(), jpol),
            (TBackend, TTarget, TorchDriver(device="cpu"), tpol)):
        drv._use_device_for_batch = lambda n: True
        client = backend(drv).new_client([target()])
        for name in pol.names():
            if name.startswith(lib + "/"):
                client.add_template(pol.load(name))
        for c in LIBRARIES[lib]:
            client.add_constraint(constraint(*c))
        for o in (objs if objs is not None
                  else fixture_objects(N_OBJECTS)):
            client.add_data(o)
        out.append((drv, client))
    return out


@pytest.fixture(scope="module", params=sorted(LIBRARIES))
def pair(request):
    return request.param, library_pair(request.param)


def _debug_view(drv) -> dict:
    """templates_debug() without the fields that name each package's own
    compiler (compile events, the source pointer) or its mesh."""
    dbg = drv.templates_debug()
    return {"keys": sorted(dbg), "warm": sorted(dbg["warm"]),
            "templates": {
                k: {"fields": sorted(e), "state": e["state"],
                    "fallback": e["fallback"],
                    "quarantine": e["quarantine"],
                    "eval_counts": e["eval_counts"]}
                for k, e in dbg["templates"].items()}}


def test_templates_debug_equal(pair):
    lib, ((jd, jc), (td, tc)) = pair
    before = _debug_view(td)
    assert before == _debug_view(jd)
    kinds = {c[0] for c in LIBRARIES[lib]}
    assert set(before["templates"]) == kinds
    joins = {"K8sUniqueIngressHost", "K8sUniqueServiceSelector"} & kinds
    for kind, ent in before["templates"].items():
        assert ent["state"] == ("join" if kind in joins else "compiled")
    assert td.templates_debug()["mesh"] is None
    # after an audit, the eval counts by path agree too
    assert key(tc.audit().results()) == key(jc.audit().results())
    assert _debug_view(td) == _debug_view(jd)


def test_audit_broadcast_spec_equal(pair):
    _lib, ((jd, _jc), (td, _tc)) = pair
    spec = td.audit_broadcast_spec()
    assert spec == jd.audit_broadcast_spec()
    assert spec["kinds"]["Namespace"] is None


def test_audit_shard_ownership_equal(pair):
    """Each of three shards sweeps the same objects in both drivers and
    returns the same results; together the shards cover the inventory
    once; clearing the shard restores the whole plane."""
    _lib, ((jd, jc), (td, tc)) = pair

    def names(drv):
        return [(r["kind"]["kind"], r.get("namespace"), r.get("name"))
                for r in drv._inventory_reviews(TARGET)]

    full = names(td)
    assert full == names(jd)
    owned = []
    try:
        for sid in range(3):
            jd.set_audit_shard(sid, 3)
            td.set_audit_shard(sid, 3)
            assert td._audit_shard == jd._audit_shard == (sid, 3)
            mine = names(td)
            assert mine == names(jd)
            assert key(tc.audit().results()) == key(jc.audit().results())
            owned += mine
    finally:
        jd.set_audit_shard(None)
        td.set_audit_shard(None)
    assert sorted(owned, key=repr) == sorted(full, key=repr)
    assert td._audit_shard is None and names(td) == full


def test_audit_kind_equal(pair):
    """The preview's core: each kind's constraints swept alone over the
    whole inventory, same results and path."""
    lib, ((jd, _jc), (td, _tc)) = pair
    by_kind: dict = {}
    for c in LIBRARIES[lib]:
        by_kind.setdefault(c[0], []).append(constraint(*c))
    paths = set()
    for kind, cons in sorted(by_kind.items()):
        jres, jpath = jd.audit_kind(TARGET, kind, cons)
        tres, tpath = td.audit_kind(TARGET, kind, cons)
        assert (key(tres), tpath) == (key(jres), jpath), kind
        paths.add(tpath)
    assert paths <= {"device", "join", "empty"} and "device" in paths


def test_on_kind_results_calls_equal(pair):
    """The streaming status writer's observer: one call per kind with its
    results, in the same order, for a full audit and a delta-served one
    after churn."""
    _lib, ((jd, jc), (td, tc)) = pair
    calls = {"jax": [], "torch": []}
    jd.on_kind_results = lambda t, k, res: calls["jax"].append(
        (t, k, key(res)))
    td.on_kind_results = lambda t, k, res: calls["torch"].append(
        (t, k, key(res)))
    try:
        for client in (jc, tc):
            client.audit()
        obj = dict(fixture_objects(1)[0])
        obj["metadata"] = dict(obj["metadata"], labels={"churned": "1"})
        for client in (jc, tc):
            client.add_data(obj)
            client.audit()
    finally:
        jd.on_kind_results = td.on_kind_results = None
    assert calls["torch"] == calls["jax"]
    n_kinds = len({c[0] for c in LIBRARIES[_lib]})
    assert len(calls["torch"]) == 2 * n_kinds


def _sample_after(drv, last: float) -> float:
    """duty_cycle() once at least its 50 ms window has passed since
    `last`."""
    time.sleep(max(0.0, 0.06 - (time.monotonic() - last)))
    return drv.duty_cycle()


def test_duty_cycle_rises_after_a_batch(pair):
    _lib, ((jd, jc), (td, tc)) = pair
    objs = fixture_objects(60)
    for drv, client in ((jd, jc), (td, tc)):
        _sample_after(drv, time.monotonic())   # seed the EMA
        t = time.monotonic()
        idle = _sample_after(drv, t)           # an idle window
        t = time.monotonic()
        client.review_batch(objs)
        busy = _sample_after(drv, t)
        assert 0.0 < busy <= 1.0 and busy > idle


def test_eval_compiled_pairs_slabbed_equal():
    """The slab iterator (bench.py's sweep/materialize pipeline) yields
    eval_compiled_pairs' pairs in order, over several slabs in the port
    (a 256-row chunk) and one in the JAX package, equal to TpuDriver's."""
    objs = synth_objects(1500, violate_frac=0.1, seed=0)
    cons = synth_constraints(12, seed=1)
    drivers = []
    for backend, target, drv in ((JBackend, JTarget, TpuDriver()),
                                 (TBackend, TTarget,
                                  TorchDriver(device="cpu"))):
        client = backend(drv).new_client([target()])
        client.add_template(REQUIRED_LABELS_TEMPLATE)
        for c in cons:
            client.add_constraint(c)
        drivers.append(drv)
    jd, td = drivers
    td.sweep_chunk = 256
    kind = "K8sRequiredLabels"
    reviews = [{"kind": {"group": "", "version": "v1",
                         "kind": o["kind"]},
                "name": o["metadata"]["name"], "object": o} for o in objs]
    out = []
    for drv in (jd, td):
        ct = drv.compiled_for(kind)
        slabs = list(drv.eval_compiled_pairs_slabbed(ct, kind, reviews,
                                                     cons))
        rows = np.concatenate([r for r, _c in slabs])
        cols = np.concatenate([c for _r, c in slabs])
        whole = drv.eval_compiled_pairs(ct, kind, reviews, cons)
        assert rows.tolist() == whole[0].tolist()
        assert cols.tolist() == whole[1].tolist()
        out.append((len(slabs), rows.tolist(), cols.tolist()))
    assert out[1][0] > 1 and out[0][0] == 1
    assert out[1][1:] == out[0][1:] and len(out[1][1]) > 0


# ---------------------------------------------------------------- metrics


def counter(metrics, name: str, **labels) -> float:
    m = metrics.REGISTRY._metrics.get(name)
    if m is None:
        return 0.0
    with m.lock:
        return m.values.get(metrics._lv(labels), 0.0)


def test_materialize_and_msg_cache_counters_equal():
    """An audit's materialized pairs by message path, and the message
    plan cache's misses then hits, move the port's counters exactly as
    they move the JAX package's."""
    (jd, jc), (td, tc) = library_pair("general")
    names = [("gatekeeper_tpu_audit_materialize_pairs_total", "path", p)
             for p in ("vectorized", "exact", "capped")]
    names += [("gatekeeper_tpu_audit_msg_template_cache_total", "outcome",
               o) for o in ("hit", "miss")]
    deltas = []
    for metrics, client in ((jmetrics, jc), (tmetrics, tc)):
        before = [counter(metrics, n, **{lab: v}) for n, lab, v in names]
        client.audit()
        client.add_constraint(constraint(
            "K8sContainerLimits", "limits-capped",
            {"cpu": "1", "memory": "1Gi"}))
        client.audit()
        deltas.append([counter(metrics, n, **{lab: v}) - b
                       for (n, lab, v), b in zip(names, before)])
    assert deltas[1] == deltas[0]
    vec, exact, _capped, hit, miss = deltas[1]
    assert vec + exact > 0 and hit > 0 and miss > 0


def test_quarantine_and_demotion_metrics():
    """A device-path failure raises the kind's quarantine gauge and
    counts a demotion; the successful probe lowers the gauge."""
    (_jd, _jc), (td, tc) = library_pair("general")
    kind = "K8sRequiredLabels"
    gauge = "gatekeeper_tpu_template_quarantined"
    demotions0 = counter(tmetrics, "gatekeeper_tpu_device_demotions_total",
                         kind=kind, reason="audit-eval")
    td.quarantine_base_s = 0.2
    FAULTS.inject("eval.device", mode="raise", match={"kind": kind})
    try:
        tc.audit()
    finally:
        FAULTS.reset()
    assert tmetrics.gauge_series(gauge)[(kind,)] == 1
    assert counter(tmetrics, "gatekeeper_tpu_device_demotions_total",
                   kind=kind, reason="audit-eval") == demotions0 + 1
    time.sleep(0.25)
    tc.add_data({"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": "probe"}})  # a full sweep, not delta
    tc.audit()
    assert td.quarantine_status() == {}
    assert tmetrics.gauge_series(gauge)[(kind,)] == 0


def test_compile_fallback_metric():
    """A template the compilers cannot take counts a fallback by its
    reason code, as in the JAX package."""
    tpl = {"apiVersion": "templates.gatekeeper.sh/v1beta1",
           "kind": "ConstraintTemplate",
           "metadata": {"name": "k8sdatareader"},
           "spec": {"crd": {"spec": {"names": {"kind": "K8sDataReader"}}},
                    "targets": [{"target": TARGET, "rego": """
package k8sdatareader
violation[{"msg": msg}] {
  count(data.inventory.cluster) > 1000000
  msg := sprintf("%v", [input.review.object.metadata.name])
}
"""}]}}
    seen = []
    for metrics, backend, target, drv in (
            (jmetrics, JBackend, JTarget, TpuDriver()),
            (tmetrics, TBackend, TTarget, TorchDriver(device="cpu"))):
        reason = None
        client = backend(drv).new_client([target()])
        client.add_template(tpl)
        reason = drv.fallback_reasons()["K8sDataReader"]["reason"]
        seen.append((reason, counter(
            metrics, "gatekeeper_tpu_compile_fallback_total",
            kind="K8sDataReader", reason=reason)))
    assert seen[1] == seen[0] and seen[1][1] >= 1


def test_compile_store_and_cache_metrics(tmp_path):
    """The program store's gauges at set_dir, a noted acquisition's
    counter and seconds, and the compile-cache gauge."""
    store = aot.AotStore()
    assert store.set_dir(str(tmp_path))
    assert tmetrics.gauge_series("gatekeeper_tpu_aot_store_enabled")[()] \
        == 1.0
    assert tmetrics.gauge_series(
        "gatekeeper_tpu_aot_store_programs")[()] == 0
    before = counter(tmetrics, "gatekeeper_tpu_compile_total",
                     source="fresh", outcome="ok")
    errors = counter(tmetrics, "gatekeeper_tpu_compile_total",
                     source="fresh", outcome="error")
    store.note("fresh", 0.25, kind="K8sRequiredLabels")
    store.note("fresh", 0.5, kind="K8sRequiredLabels", outcome="error")
    assert counter(tmetrics, "gatekeeper_tpu_compile_total",
                   source="fresh", outcome="ok") == before + 1
    assert counter(tmetrics, "gatekeeper_tpu_compile_total",
                   source="fresh", outcome="error") == errors + 1
    assert tmetrics.REGISTRY._metrics[
        "gatekeeper_tpu_compile_seconds"].counts[("fresh",)] >= 1
    ok = aot.enable_compile_cache()
    assert tmetrics.gauge_series(
        "gatekeeper_tpu_compile_cache_enabled")[()] == (1.0 if ok else 0.0)
