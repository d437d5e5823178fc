"""The port's vectorized violation materialization and the audit
manager's pre-materialization cap against the JAX package's.

The ten cases of tests/test_materialize_vec.py, each run through both
packages (TorchDriver on the CPU in the port, TpuDriver in the JAX
package) on the same objects: within a package the vectorized messages
must equal the exact evaluator's (the reference's own check), and the
two packages' transcripts (messages, details, actions and order per
kind, the plans' presence, the cap's split) must be equal. The cap
cases (:278, :319, :333) also run through each package's
AuditManager: its sweep arms the cap, a direct `client.audit()` on the
same driver right after stays uncapped, and the published statuses are
equal.
"""

from __future__ import annotations

import numpy as np
import pytest

import bench_configs as bc

from .test_torch_audit import both, statuses

TARGET = "admission.k8s.gatekeeper.sh"


def mk_client(P, drv=None):
    drv = drv or P.driver()
    return drv, P.Backend(drv).new_client([P.Target()])


def _pairs(P, drv, kind, cons, reviews):
    """Device firing pairs of one kind over its candidate reviews."""
    lookup_ns = drv._namespace_lookup(TARGET)
    ct = drv.compiled_for(kind)
    assert ct is not None, f"{kind} must device-compile for this test"
    mask = P.batch.match_masks(cons, reviews, lookup_ns)
    cand = np.flatnonzero(mask.any(axis=1))
    cand_reviews = [reviews[int(i)] for i in cand]
    rows, cols = drv.eval_compiled_pairs(
        ct, kind, cand_reviews, cons,
        feat_key=(drv._data_gen, hash(cand.tobytes())), cand=cand,
        target=TARGET)
    keep = mask[cand[rows], cols]
    return cand, cand_reviews, rows[keep], cols[keep]


def _materialize_both(P, drv, kind, cons, reviews, with_cand=True):
    """tests/test_materialize_vec.py's helper: one kind's device pairs
    materialized through the vectorized plan and with the plan
    disabled. Returns (vec_results, exact_results, n_pairs,
    plan_active)."""
    inventory = drv._inventory_tree(TARGET)
    cand, cand_reviews, rows, cols = _pairs(P, drv, kind, cons, reviews)
    kw = {"cand": cand} if with_cand else {}
    plan_active = drv._vec_msgs(TARGET, kind, cons, cand_reviews, rows,
                                cols, cand if with_cand else None) \
        is not None
    r_vec = drv.materialize_pairs(TARGET, cons, cand_reviews, rows, cols,
                                  inventory, **kw)
    orig = drv._vec_msgs
    drv._vec_msgs = lambda *a, **k: None
    try:
        r_exact = drv.materialize_pairs(TARGET, cons, cand_reviews, rows,
                                        cols, inventory, **kw)
    finally:
        drv._vec_msgs = orig
    return r_vec, r_exact, len(rows), plan_active


def _key(r):
    """The reference's key, with the review's identity."""
    return (r.constraint["kind"], r.constraint["metadata"]["name"],
            r.msg, r.metadata, r.enforcement_action, id(r.review))


def _wire(results) -> list:
    """The reference's key across packages: the review by its name."""
    return [[r.constraint["kind"], r.constraint["metadata"]["name"],
             r.msg, r.metadata, r.enforcement_action,
             (r.review or {}).get("name")] for r in results]


def _load_library(P, prefix, constraints, objects):
    drv, client = mk_client(P)
    for name in P.pol.names():
        if name.startswith(prefix):
            client.add_template(P.pol.load(name))
    for kind, cname, params in constraints:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {}),
        })
    for o in objects:
        client.add_data(o)
    return drv, client


def _library_bit_equal(P, prefix, constraints, objects):
    drv, _client = _load_library(P, prefix, constraints, objects)
    reviews = drv._inventory_reviews(TARGET)
    cons_all = drv._constraints(TARGET)
    out, vec_kinds, total = [], set(), 0
    for kind in sorted({c.get("kind") for c in cons_all}):
        cons = [c for c in cons_all if c.get("kind") == kind]
        if drv.compiled_for(kind) is None:
            out.append([kind, None])
            continue
        r_vec, r_exact, n, active = _materialize_both(P, drv, kind, cons,
                                                      reviews)
        assert [_key(r) for r in r_vec] == [_key(r) for r in r_exact], \
            f"{kind}: vectorized messages diverge from the evaluator"
        if active:
            vec_kinds.add(kind)
        total += n
        out.append([kind, active, _wire(r_vec)])
    return out, vec_kinds, total


def case_psp_library_bit_equal(P):
    """:94."""
    out, vec_kinds, total = _library_bit_equal(
        P, "pod-security-policy/", bc.PSP_CONSTRAINTS,
        bc.synth_pods_psp(1500))
    assert total > 0
    assert {"K8sPSPSELinux", "K8sPSPForbiddenSysctls"} <= vec_kinds
    return out


def case_general_library_bit_equal(P):
    """:122."""
    out, _vec_kinds, _total = _library_bit_equal(
        P, "general/", bc.GENERAL_CONSTRAINTS, bc.synth_mixed_objects(1200))
    return out


def case_plan_gating_per_axis_witnesses_stay_exact(P):
    """:137."""
    drv, client = _load_library(P, "pod-security-policy/",
                                bc.PSP_CONSTRAINTS, bc.synth_pods_psp(50))
    for name in P.pol.names():
        if name.startswith("general/"):
            client.add_template(P.pol.load(name))
    plans = {k: drv._msg_plan(k) is not None for k in (
        "K8sPSPSELinux", "K8sPSPForbiddenSysctls", "K8sPSPHostNamespace",
        "K8sHttpsOnly", "K8sPSPAllowPrivilegeEscalationContainer",
        "K8sPSPPrivilegedContainer", "K8sPSPCapabilities",
        "K8sRequiredLabels")}
    assert plans == {
        "K8sPSPSELinux": True, "K8sPSPForbiddenSysctls": True,
        "K8sPSPHostNamespace": True, "K8sHttpsOnly": True,
        "K8sPSPAllowPrivilegeEscalationContainer": False,
        "K8sPSPPrivilegedContainer": False, "K8sPSPCapabilities": False,
        "K8sRequiredLabels": False}
    return plans


VECDIFF_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "vecdiff"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "VecDiff"}}},
        "targets": [{"target": "admission.k8s.gatekeeper.sh", "rego": """
package vecdiff

violation[{"msg": msg, "details": {}}] {
  input.review.object.metadata.labels["flag"] == "bad"
  msg := sprintf("object <%v> in namespace <%v> flagged (note: %v, max: %v)", [input.review.object.metadata.name, input.review.object.metadata.namespace, input.parameters.note, input.parameters.max])
}
"""}],
    },
}

VECDIFF_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "VecDiff", "metadata": {"name": "vd"},
    "spec": {"parameters": {"note": "uñícødé «note»", "max": 3}},
}


def _vecdiff_client(P, pods):
    drv, client = mk_client(P)
    client.add_template(VECDIFF_TEMPLATE)
    client.add_constraint(VECDIFF_CONSTRAINT)
    for p in pods:
        client.add_data(p)
    return drv, client


def _pod(name, ns="d", flag="bad"):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns,
                         "labels": {"flag": flag}}}


def _vecdiff_pairs(P, pods):
    drv, _client = _vecdiff_client(P, pods)
    reviews = drv._inventory_reviews(TARGET)
    cons = drv._constraints(TARGET)
    r_vec, r_exact, n, active = _materialize_both(P, drv, "VecDiff", cons,
                                                  reviews)
    assert [_key(r) for r in r_vec] == [_key(r) for r in r_exact]
    return drv, r_vec, n, active


def case_multiarg_sprintf_unicode_and_oversize_witnesses(P):
    """:200."""
    long_name = "pé-" + "x" * (P.vecmat.MAX_WITNESS_STRLEN + 10)
    pods = [_pod("pød-世界"), _pod(long_name), _pod("plain"),
            _pod("skipped", flag="ok")]
    drv, r_vec, n, active = _vecdiff_pairs(P, pods)
    assert drv._msg_plan("VecDiff") is not None
    assert active and n == 3
    msgs = sorted(r.msg for r in r_vec)
    assert any("uñícødé «note»" in m for m in msgs)
    assert any(long_name in m for m in msgs)
    assert all("max: 3)" in m for m in msgs)
    return _wire(r_vec)


def case_absent_and_nonstring_witnesses_veto_to_exact(P):
    """:226."""
    pods = [_pod("named"),
            {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": "no-ns", "labels": {"flag": "bad"}}}]
    _drv, r_vec, _n, active = _vecdiff_pairs(P, pods)
    assert active
    assert sorted(r.review["name"] for r in r_vec) == ["named"]
    return _wire(r_vec)


def case_undefined_param_witness_skips_constraint(P):
    """:247."""
    drv, client = mk_client(P)
    client.add_template(VECDIFF_TEMPLATE)
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "VecDiff", "metadata": {"name": "no-note"},
        "spec": {"parameters": {"max": 1}},
    })
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "VecDiff", "metadata": {"name": "with-note"},
        "spec": {"parameters": {"note": "n", "max": 1}},
    })
    for p in [_pod("a"), _pod("b")]:
        client.add_data(p)
    reviews = drv._inventory_reviews(TARGET)
    cons = drv._constraints(TARGET)
    r_vec, r_exact, _n, active = _materialize_both(P, drv, "VecDiff", cons,
                                                   reviews)
    assert active
    assert [_key(r) for r in r_vec] == [_key(r) for r in r_exact]
    assert {r.constraint["metadata"]["name"] for r in r_vec} == \
        {"with-note"}
    return _wire(r_vec)


def _manager_sweep(P, drv, client, limit):
    """An audit-from-cache manager sweep capped at `limit` on the
    client's driver (the device path pinned), then a direct audit on
    the same driver: their results, and the status the sweep published
    on a kube holding the constraint."""
    drv._dev_batch_lat_s = 1e-6
    drv._host_pair_rate = 1.0
    kube = P.kube.FakeKube()
    kube.apply(dict(VECDIFF_CONSTRAINT))
    mgr = P.audit.AuditManager(kube, client, audit_from_cache=True,
                               constraint_violations_limit=limit,
                               gc_stale_statuses=False,
                               stream_status_writes=False)
    swept = mgr.audit_once()
    direct = client.audit().results()
    mgr.stop()
    gvk = ("constraints.gatekeeper.sh", "v1beta1", "VecDiff")
    return swept, direct, statuses(kube, [gvk])


def case_cap_before_materialization(P):
    """:278: with the cap armed, each constraint's first `cap` pairs
    materialize full messages and the rest are count-only; a manager
    sweep with the same limit splits its results the same way and
    publishes the capped entries."""
    pods = [_pod(f"p-{i:03d}") for i in range(30)]
    drv, client = _vecdiff_client(P, pods)
    reviews = drv._inventory_reviews(TARGET)
    cons = drv._constraints(TARGET)
    inventory = drv._inventory_tree(TARGET)
    cand, cand_reviews, rows, cols = _pairs(P, drv, "VecDiff", cons,
                                            reviews)
    uncapped = drv.materialize_pairs(TARGET, cons, cand_reviews, rows,
                                     cols, inventory, cand=cand)
    drv.audit_violations_cap = 5
    drv._in_audit_sweep = True
    try:
        capped = drv.materialize_pairs(TARGET, cons, cand_reviews, rows,
                                       cols, inventory, cand=cand)
    finally:
        drv._in_audit_sweep = False
        drv.audit_violations_cap = None
    assert len(capped) == len(uncapped) == 30
    assert [r.msg for r in capped[:5]] == [r.msg for r in uncapped[:5]]
    assert all(r.msg == "" for r in capped[5:])
    assert all(r.enforcement_action == uncapped[i].enforcement_action
               for i, r in enumerate(capped))
    swept, direct, st = _manager_sweep(P, drv, client, 5)
    assert len(swept) == 30 and sum(1 for r in swept if r.msg) == 5
    assert all(r.msg for r in direct) and len(direct) == 30
    assert st["VecDiff/vd"]["totalViolations"] == 30
    assert len(st["VecDiff/vd"]["violations"]) == 5
    return [_wire(capped), _wire(swept), _wire(direct), st]


def case_cap_ignored_outside_audit_sweep(P):
    """:319: previews and direct materialization stay uncapped even with
    the cap armed on the shared driver; so does a direct audit after a
    manager's capped sweep."""
    pods = [_pod(f"q-{i}") for i in range(8)]
    drv, client = _vecdiff_client(P, pods)
    drv.audit_violations_cap = 2  # armed, but no sweep flag
    reviews = drv._inventory_reviews(TARGET)
    cons = drv._constraints(TARGET)
    r_vec, r_exact, _n, _a = _materialize_both(P, drv, "VecDiff", cons,
                                               reviews)
    assert all(r.msg for r in r_vec)
    assert [_key(r) for r in r_vec] == [_key(r) for r in r_exact]
    drv.audit_violations_cap = None
    swept, direct, st = _manager_sweep(P, drv, client, 2)
    assert drv.audit_violations_cap is None  # disarmed after the sweep
    assert sum(1 for r in swept if r.msg) == 2
    assert all(r.msg for r in direct)
    return [_wire(r_vec), _wire(swept), _wire(direct), st]


def case_manager_sweep_caps_direct_audit_stays_uncapped(P):
    """:333."""
    pods = [_pod(f"m-{i:02d}") for i in range(12)]
    drv, client = _vecdiff_client(P, pods)
    res, direct, st = _manager_sweep(P, drv, client, 4)
    assert len(res) == 12
    assert sum(1 for r in res if r.msg) == 4
    assert all(r.msg == "" for r in res[4:])
    assert len(direct) == 12
    assert all(r.msg for r in direct)
    return [_wire(res), _wire(direct), st]


def case_witness_columns_cached_and_invalidated(P):
    """:366."""
    pods = [_pod(f"w-{i}") for i in range(6)]
    drv, client = _vecdiff_client(P, pods)
    reviews = drv._inventory_reviews(TARGET)
    cons = drv._constraints(TARGET)
    r1, _e1, _n, active = _materialize_both(P, drv, "VecDiff", cons,
                                            reviews)
    assert active
    keys = [k for k in drv._witcols if k[0] == TARGET]
    assert keys
    ent_before = drv._witcols[keys[0]]
    r2, _e2, _n2, _a2 = _materialize_both(P, drv, "VecDiff", cons, reviews)
    hit = drv._witcols[keys[0]] is ent_before
    assert hit
    client.add_data(_pod("w-renamed"))
    reviews = drv._inventory_reviews(TARGET)
    r3, e3, _n3, _a3 = _materialize_both(P, drv, "VecDiff", cons, reviews)
    assert [_key(r) for r in r3] == [_key(r) for r in e3]
    assert any("w-renamed" in r.msg for r in r3)
    return [_wire(r1), _wire(r2), hit, _wire(r3)]


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_materialize_case_equal(case):
    got, want = both(case)
    assert got == want
