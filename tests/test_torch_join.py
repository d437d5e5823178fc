"""The port's inventory-join path (ir/join.py, K4) against the JAX package.

The join compiler must emit the same JoinProgram, K4's plain version
must equal the JAX package's membership program (run by jax on the CPU)
on the same padded arrays, and TorchDriver's join audit and review batch
must equal TpuDriver's on the general library with duplicate hosts and
selectors injected, at MIN_DEVICE_REVIEWS 1 (the membership program
runs) and at its default (the host dict probe). Tolerance: exact
equality (booleans, ids, messages).
"""

import numpy as np
import pytest
import torch

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.ir import aot as jaot
from gatekeeper_tpu.ir import join as jjoin
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu.utils.values import freeze as jfreeze
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir import join as tjoin
from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
from gatekeeper_tpu_torch.kernels.join_member import (
    join_member,
    join_member_plain,
)
from gatekeeper_tpu_torch.parallel.workload import GENERAL_CONSTRAINTS
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget
from gatekeeper_tpu_torch.utils.values import freeze as tfreeze

from .test_torch_frontend import TARGET, fixture_objects

JOINS = {"general/uniqueingresshost": "K8sUniqueIngressHost",
         "general/uniqueserviceselector": "K8sUniqueServiceSelector"}
GENERAL = sorted(n for n in jpol.names() if n.startswith("general/"))


def key(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


def general_client(backend, target, drv, pol):
    client = backend(drv).new_client([target()])
    for name in GENERAL:
        client.add_template(pol.load(name))
    for kind, cname, params in GENERAL_CONSTRAINTS:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {})})
    return client


def with_duplicates(objs: list[dict]) -> list[dict]:
    """The corpus plus copies that collide: every 4th Ingress's host in
    another namespace, one Ingress holding two taken hosts, and every
    5th Service's selector in another namespace."""
    out = list(objs)
    ing = [o for o in objs if o["kind"] == "Ingress"]
    svc = [o for o in objs if o["kind"] == "Service"]
    for i, o in enumerate(ing[::4]):
        d = {**o, "metadata": {**o["metadata"], "name": f"dup-ing-{i}",
                               "namespace": "dup"}}
        out.append(d)
    hosts = [r["host"] for o in ing[1:3] for r in o["spec"]["rules"]]
    out.append({"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
                "metadata": {"name": "two-hosts", "namespace": "dup"},
                "spec": {"rules": [{"host": h} for h in hosts]}})
    for i, o in enumerate(svc[::5]):
        out.append({**o, "metadata": {**o["metadata"],
                                      "name": f"dup-svc-{i}",
                                      "namespace": "dup"}})
    return out


@pytest.fixture(scope="module")
def join_drivers():
    """(TpuDriver, TorchDriver(cpu)) with the two join templates."""
    jd, td = TpuDriver(), TorchDriver(device="cpu")
    for backend, target, drv, pol in ((JBackend, JTarget, jd, jpol),
                                      (TBackend, TTarget, td, tpol)):
        client = backend(drv).new_client([target()])
        for name in JOINS:
            client.add_template(pol.load(name))
    return jd, td


@pytest.mark.parametrize("kind", sorted(JOINS.values()))
def test_join_program_equal(join_drivers, kind):
    jd, td = join_drivers
    assert repr(td._join_progs[kind]) == repr(jd._join_progs[kind])
    jc, tc = jd.join_for(kind), td.join_for(kind)
    assert tc.fingerprint == jc.fingerprint == jaot.program_fingerprint(
        jd._join_progs[kind].module, "join:" + kind)
    assert tc.device == torch.device("cpu")


def k4_case(seed: int, n_u: int, G: int, N: int, hmax: int):
    """Random join tables and reviews, padded by the port's helpers:
    keys absent (below, between and above the table), equal to the first
    and last real entry, KEY_PAD; holders single or shared; identities
    equal to the holder's, other, IK_REV_MISSING and IK_INV_MISSING."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.choice(np.arange(10, 10 + 4 * n_u, 2), n_u,
                           replace=False)).astype(np.int64)
    cnt = rng.choice([1, 1, 2, 3], n_u).astype(np.int32)
    sik = rng.integers(100, 140, (G, n_u)).astype(np.int64)
    sik[rng.random((G, n_u)) < 0.2] = jjoin.IK_INV_MISSING
    sik[:, cnt >= 2] = jjoin.IK_MULTI
    pool = np.concatenate([u, u + 1, [u[0], u[-1], 0, 5, u[-1] + 7]])
    keys, iks = [], np.full((N, G), jjoin.IK_REV_MISSING, dtype=np.int32)
    for r in range(N):
        k = int(rng.integers(0, hmax + 1)) if r else hmax
        keys.append(sorted({int(x) for x in rng.choice(pool, k)}))
        for g in range(G):
            roll = rng.random()
            if roll < 0.4 and keys[r]:
                j = int(np.searchsorted(u, keys[r][0]))
                if j < n_u:
                    iks[r, g] = sik[g, j]  # the review's own stored copy
            elif roll < 0.7:
                iks[r, g] = int(rng.integers(100, 140))
    hmax = max(len(k) for k in keys)
    return tjoin.pad_inventory(u, cnt, sik) + tjoin.pad_reviews(
        keys, iks, hmax)


# (seed, len(u), G, N, hmax); len(u) 8 and 32 are powers of two: no pad
K4_CASES = [(0, 13, 1, 37, 1), (1, 8, 2, 301, 3), (2, 32, 2, 1000, 2),
            (3, 1, 1, 40, 1), (4, 100, 1, 257, 4)]


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_plain_equals_jax_program(join_drivers, case):
    seed, n_u, G, N, hmax = case
    arrs = k4_case(seed, n_u, G, N, hmax)
    u_p, cnt_p, sik_p, karr, iks = arrs
    assert (u_p.shape[0] == n_u) == (n_u & (n_u - 1) == 0)
    assert (karr == jjoin.KEY_PAD).any()
    jd, _td = join_drivers
    want = np.asarray(jd.join_for("K8sUniqueIngressHost")._jit_wrapper()(
        *arrs))
    got = join_member(*tree_from_numpy(arrs, "cpu"), tjoin.KEY_PAD)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(join_member_plain(
        *tree_from_numpy(arrs, "cpu"), tjoin.KEY_PAD).numpy(), want)
    assert want.any() and not want.all()


def test_sentinels_and_padding_equal():
    assert (tjoin.IK_INV_MISSING, tjoin.IK_REV_MISSING, tjoin.IK_MULTI,
            tjoin.KEY_PAD) == (jjoin.IK_INV_MISSING, jjoin.IK_REV_MISSING,
                               jjoin.IK_MULTI, jjoin.KEY_PAD)
    u_p, cnt_p, sik_p = tjoin.pad_inventory(
        np.array([3, 9, 11]), np.array([1, 2, 1], np.int32),
        np.array([[40, jjoin.IK_MULTI, 41]]))
    assert u_p.tolist() == [3, 9, 11, np.iinfo(np.int32).max]
    assert cnt_p.tolist() == [1, 2, 1, 0]
    assert sik_p.tolist() == [[40, jjoin.IK_MULTI, 41, jjoin.IK_MULTI]]
    karr, iks = tjoin.pad_reviews([[3], [9, 11, 12], []],
                                  np.zeros((3, 1), np.int64), 3)
    assert karr.shape == (3, 4) and karr.dtype == np.int32
    assert karr[2].tolist() == [jjoin.KEY_PAD] * 4
    assert iks.dtype == np.int32


@pytest.mark.parametrize("min_reviews", [1, None])
def test_general_library_join_audit_and_review_batch(monkeypatch,
                                                     min_reviews):
    """Audit (twice), review batch, and a re-audit after deleting one
    duplicate, through both drivers; at MIN_DEVICE_REVIEWS 1 the port's
    K4 (plain version here) serves every join evaluation."""
    if min_reviews is not None:
        monkeypatch.setattr(jjoin.JoinCompiled, "MIN_DEVICE_REVIEWS",
                            min_reviews)
        monkeypatch.setattr(tjoin.JoinCompiled, "MIN_DEVICE_REVIEWS",
                            min_reviews)
    k4 = []
    monkeypatch.setattr(tjoin, "join_member",
                        lambda *a: k4.append(a) or join_member(*a))
    objs = with_duplicates(fixture_objects(420))
    jd = TpuDriver()
    jd._dev_batch_lat_s = 1e-4  # pin the device path (cost model off)
    td = TorchDriver(device="cpu")
    td._dev_batch_lat_s = 1e-4
    out = []
    for backend, target, drv, pol in ((JBackend, JTarget, jd, jpol),
                                      (TBackend, TTarget, td, tpol)):
        client = general_client(backend, target, drv, pol)
        for o in objs:
            client.add_data(o)
        first = key(client.audit().results())
        steady = key(client.audit().results())
        batch = [key(r.results()) for r in client.review_batch(objs[-60:])]
        client.remove_data(objs[-1])
        after = key(client.audit().results())
        out.append((first, steady, batch, after))
    want, got = out
    assert got == want
    first, steady, batch, after = got
    assert steady == first and after != first
    joined = [k for k in first if k[1] in ("unique-hosts",
                                           "unique-selectors")]
    assert {k[1] for k in joined} == {"unique-hosts", "unique-selectors"}
    assert any(batch)
    counts = td.eval_counts()
    for kind in JOINS.values():
        assert counts[(kind, "join")] >= 4
        assert (kind, "interp") not in counts
    assert td.fallback_reasons() == {}
    assert bool(k4) == (min_reviews == 1)


def test_review_cache_not_keyed_by_shape_alone(monkeypatch):
    """Two same-size review batches with different membership get
    different fires through K4 (the port's copy of the JAX package's
    regression test): the review tensors are reused only when their
    bytes match."""
    monkeypatch.setattr(tjoin.JoinCompiled, "MIN_DEVICE_REVIEWS", 1)
    drv = TorchDriver(device="cpu")
    client = TBackend(drv).new_client([TTarget()])
    client.add_template(tpol.load("general/uniqueingresshost"))
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sUniqueIngressHost", "metadata": {"name": "u"},
        "spec": {}})
    client.add_data({"apiVersion": "networking.k8s.io/v1",
                     "kind": "Ingress",
                     "metadata": {"name": "base", "namespace": "ns0"},
                     "spec": {"rules": [{"host": "dup.com"}]}})
    jc = drv.join_for("K8sUniqueIngressHost")
    inv = drv._inventory_tree(TARGET)

    def rv(name, ns, host):
        obj = {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
               "metadata": {"name": name, "namespace": ns},
               "spec": {"rules": [{"host": host}]}}
        return tfreeze({"kind": {"group": "networking.k8s.io",
                                 "version": "v1", "kind": "Ingress"},
                        "name": name, "namespace": ns, "object": obj})

    batch_a = [rv(f"a{i}", "nsA", f"free{i}.com") for i in range(4)]
    batch_b = [rv(f"b{i}", "nsB", "dup.com") for i in range(4)]
    fa = jc.fires(batch_a, inv, drv._data_gen)
    fb = jc.fires(batch_b, inv, drv._data_gen)
    fa2 = jc.fires(batch_a, inv, drv._data_gen)
    assert not fa.any(), "batch A has no collisions"
    assert fb.all(), "batch B must all fire"
    assert not fa2.any(), "stale review tensors reused"
    # the inventory tensors were built once for the data generation
    assert len(jc._dev_inv_cache) == 1


def test_device_and_host_probe_agree(monkeypatch):
    """The port's membership program and its host dict probe agree on
    the same key tables, and both equal the JAX package's."""
    objs = [{"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
             "metadata": {"name": f"i{i}", "namespace": f"ns{i % 8}"},
             "spec": {"rules": [{"host": f"h{i % 24}.com"},
                                {"host": f"only{i}.com"}]}}
            for i in range(64)]
    fires = []
    for backend, target, drv, pol, mod, freeze in (
            (JBackend, JTarget, TpuDriver(), jpol, jjoin, jfreeze),
            (TBackend, TTarget, TorchDriver(device="cpu"), tpol, tjoin,
             tfreeze)):
        client = backend(drv).new_client([target()])
        client.add_template(pol.load("general/uniqueingresshost"))
        for o in objs:
            client.add_data(o)
        jc = drv.join_for("K8sUniqueIngressHost")
        frz = [freeze(r) for r in drv._inventory_reviews(TARGET)]
        inv = drv._inventory_tree(TARGET)
        host = np.asarray(jc.fires(frz, inv, drv._data_gen))
        monkeypatch.setattr(mod.JoinCompiled, "MIN_DEVICE_REVIEWS", 1)
        dev = np.asarray(jc.fires(frz, inv, drv._data_gen))
        monkeypatch.undo()
        assert np.array_equal(host, dev)
        fires.append(host)
    assert np.array_equal(fires[0], fires[1]) and fires[0].any()
