"""The JAX package's inventory-join suite on the port
(tests/test_ir_join.py, case for case).

The two cross-object templates of the general library compile to join
programs; their audit (twice: the steady second sweep must agree), five
admission reviews (the `not identical` own-copy exclusion) and an audit
after a delete give the same results on the port's RegoDriver, TorchDriver
on the CPU and TpuDriver, as decided and pinned, the compiled ones on the
join path; the device membership (K4's plain version on the CPU, forced
with MIN_DEVICE_REVIEWS 1) equals the host dict probe and the JAX
package's; the device inputs are keyed by membership, not by shape; and
the inventory tables by the tree's identity. Tolerance: exact.
"""

from __future__ import annotations

import numpy as np

from gatekeeper_tpu.utils.values import freeze as jfreeze
from gatekeeper_tpu_torch.utils.values import freeze as tfreeze

from . import test_ir_join as ref
from .test_torch_compile_coverage import JAX, TORCH, all_drivers
from .torch_compiler_cases import (
    JOIN_KINDS,
    JOIN_OBJS,
    JOIN_REVIEWS,
    TARGET,
    assert_served,
    bare_constraint,
    ingress,
    join_device_objects,
)


def _names(results) -> list:
    return sorted((r.msg, (r.resource or {}).get("metadata", {})
                   .get("name", "")) for r in results)


def _run(P, driver) -> list:
    """test_ir_join._run on a package's client."""
    client = P.Backend(driver).new_client([P.Target()])
    for path, kind, cname in JOIN_KINDS:
        client.add_template(P.pol.load(path))
    for path, kind, cname in JOIN_KINDS:
        client.add_constraint(bare_constraint(kind, cname))
    for o in JOIN_OBJS:
        client.add_data(o)
    out = [_names(client.audit().results())]
    out.append(_names(client.audit().results()))
    for rv in JOIN_REVIEWS:
        out.append(sorted(r.msg for r in client.review(P.Aug(rv)).results()))
    client.remove_data(JOIN_OBJS[1])
    out.append(_names(client.audit().results()))
    return out


def _join_driver(P, objs=()):
    drv = P.driver()
    client = P.Backend(drv).new_client([P.Target()])
    client.add_template(P.pol.load("general/uniqueingresshost"))
    client.add_constraint(bare_constraint("K8sUniqueIngressHost", "u"))
    for o in objs:
        client.add_data(o)
    return drv, client


def test_join_templates_compile():
    """Both templates compile to join programs in the port, the same
    kinds as TpuDriver's."""
    progs = {}
    for name, P in (("torch", TORCH), ("tpu", JAX)):
        drv = P.driver()
        client = P.Backend(drv).new_client([P.Target()])
        for path, _kind, _cname in JOIN_KINDS:
            client.add_template(P.pol.load(path))
        progs[name] = sorted(drv._join_progs)
        for _path, kind, _cname in JOIN_KINDS:
            assert drv.join_for(kind) is not None
            assert drv.compiled_for(kind) is None
        assert drv.fallback_reasons() == {}
    assert progs["torch"] == progs["tpu"] == ["K8sUniqueIngressHost",
                                              "K8sUniqueServiceSelector"]


def test_join_differential_audit_and_admission():
    """Audit, steady audit, admission and an audit after a delete: every
    driver equal, non-vacuous, the own copy excluded; the compiled
    drivers served both kinds on the join path."""
    outs = {}
    for name, (P, drv) in all_drivers().items():
        outs[name] = _run(P, drv)
        if name != "rego":
            assert_served(drv, [k for _, k, _ in JOIN_KINDS], ("join",))
    a = outs["rego"]
    assert all(o == a for o in outs.values()), outs
    assert any(a[0]), "audit found no conflicts"
    assert a[2] and a[4], "admission conflicts missing"
    assert a[3] == [] and a[6] == [], "own-copy exclusion failed"


def test_join_device_path_matches_host_path():
    """The device membership (forced) and the host dict probe agree on
    the same key tables, in the port as in the JAX package, and the two
    packages' fires are equal."""
    fires = {}
    for name, P, freeze in (("torch", TORCH, tfreeze), ("tpu", JAX, jfreeze)):
        drv, _ = _join_driver(P, join_device_objects())
        jc = drv.join_for("K8sUniqueIngressHost")
        frz = [freeze(r) for r in drv._inventory_reviews(TARGET)]
        inv = drv._inventory_tree(TARGET)
        host = np.asarray(jc.fires(frz, inv, drv._data_gen))
        saved = jc.MIN_DEVICE_REVIEWS
        try:
            jc.MIN_DEVICE_REVIEWS = 1  # force the device path
            jc._jit = None
            dev = np.asarray(jc.fires(frz, inv, drv._data_gen))
        finally:
            jc.MIN_DEVICE_REVIEWS = saved
        assert (host == dev).all(), name
        assert host.any(), "non-vacuous: some host collisions must fire"
        fires[name] = host
    assert (fires["torch"] == fires["tpu"]).all()


def test_join_device_cache_not_keyed_by_shape_alone():
    """Two same-size review batches with different membership get
    different fires on the device path, and back again."""
    got = {}
    for name, P, freeze in (("torch", TORCH, tfreeze), ("tpu", JAX, jfreeze)):
        drv, _ = _join_driver(P, [ingress("base", "ns0", ["dup.com"])])
        jc = drv.join_for("K8sUniqueIngressHost")
        inv = drv._inventory_tree(TARGET)

        def rv(rname, ns, hosts):
            return freeze({"kind": {"group": "networking.k8s.io",
                                    "version": "v1", "kind": "Ingress"},
                           "name": rname, "namespace": ns,
                           "object": ingress(rname, ns, hosts)})

        batch_a = [rv(f"a{i}", "nsA", [f"free{i}.com"]) for i in range(4)]
        batch_b = [rv(f"b{i}", "nsB", ["dup.com"]) for i in range(4)]
        saved = jc.MIN_DEVICE_REVIEWS
        try:
            jc.MIN_DEVICE_REVIEWS = 1  # force the device path
            fa = np.asarray(jc.fires(batch_a, inv, drv._data_gen))
            fb = np.asarray(jc.fires(batch_b, inv, drv._data_gen))
            fa2 = np.asarray(jc.fires(batch_a, inv, drv._data_gen))
        finally:
            jc.MIN_DEVICE_REVIEWS = saved
        assert not fa.any(), "batch A has no collisions"
        assert fb.all(), "batch B must all fire"
        assert not fa2.any(), "stale device tensors reused"
        got[name] = (fa.tolist(), fb.tolist(), fa2.tolist())
    assert got["torch"] == got["tpu"]


def test_join_inv_tables_keyed_by_tree_identity():
    """Two inventory trees at the same data generation do not share join
    tables; the same tree hits the cache."""
    for P, freeze in ((TORCH, tfreeze), (JAX, jfreeze)):
        drv, _ = _join_driver(P)
        jc = drv.join_for("K8sUniqueIngressHost")
        tree_a = freeze({"cluster": {}, "namespace": {
            "ns1": {"networking.k8s.io/v1": {"Ingress": {
                "a": ingress("a", "ns1", ["x.com"])}}}}})
        tree_b = freeze({"cluster": {}, "namespace": {}})
        tabs_a = jc.inv_tables(tree_a, 7)
        tabs_b = jc.inv_tables(tree_b, 7)
        assert len(tabs_a[0][0]) == 1, "tree A has one join key"
        assert len(tabs_b[0][0]) == 0, "tree B is empty, must not reuse A"
        assert jc.inv_tables(tree_a, 7) is tabs_a, "cache hit expected"


def test_case_copies_equal_reference():
    """tests/torch_compiler_cases.py's join inputs are the reference
    suite's own."""
    assert JOIN_OBJS == ref.OBJS and JOIN_REVIEWS == ref.REVIEWS
    assert [ref.ingress(f"i{i}", f"ns{i % 8}",
                        [f"h{i % 24}.com", f"only{i}.com"])
            for i in range(64)] == join_device_objects()
