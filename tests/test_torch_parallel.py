"""The port's audit mesh (gatekeeper_tpu_torch/parallel/, the mesh half of
ir/evaltorch.py and TorchDriver) against the JAX package's.

Each case of tests/test_parallel.py runs differentially: the JAX package
on its 8 virtual CPU devices (conftest), the port on a mesh of 8 virtual
shards of the CPU (`parallel.mesh.visible_devices` substituted, as the
reference's tests rely on `jax.devices()`). Sharded must equal single
device, in both packages, and the two packages must agree: uneven
padding, the model axis, derived columns, factorization errors, the
driver's mesh audit, the capacity retry and its ratchet,
MESH_MIN_REVIEWS, the sharded join, the slab loop against the mono
dispatch, the direct slab dispatch, the sparse review batch, pad_batch,
_build_mesh's rounding, placements and the placement cache's bound.
Then K6's plain version (kernels/shard_counts.py) against the JAX
package's audit-step counts, and a randomized net: the reference's fuzz
objects through a mesh driver, a single-device driver and TpuDriver's
mesh, all pinned to the device path.

Tolerance: exact equality (booleans, integer counts, result tuples).
"""

from __future__ import annotations

import logging
import random

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.ir.features import extract_batch as jextract
from gatekeeper_tpu.ir.params import encode_params as jencode
from gatekeeper_tpu.parallel import mesh as jmesh
from gatekeeper_tpu.parallel.collectives import make_audit_step as jstep
from gatekeeper_tpu.parallel.workload import build_eval_setup as jsetup
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir import evaltorch
from gatekeeper_tpu_torch.ir import join as tjoin
from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
from gatekeeper_tpu_torch.ir.features import extract_batch as textract
from gatekeeper_tpu_torch.ir.params import encode_params as tencode
from gatekeeper_tpu_torch.kernels.join_member import join_member
from gatekeeper_tpu_torch.kernels.shard_counts import shard_counts_plain
from gatekeeper_tpu_torch.parallel import mesh as tmesh
from gatekeeper_tpu_torch.parallel.collectives import make_audit_step
from gatekeeper_tpu_torch.parallel.workload import build_eval_setup
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

from .test_differential_fuzz import CONSTRAINTS as FUZZ_CONSTRAINTS
from .test_differential_fuzz import _rand_object
from .torch_fuzz_gen import pin
from .torch_kernel_cases import k4_synthetic

TARGET = "admission.k8s.gatekeeper.sh"
CPU = torch.device("cpu")


@pytest.fixture
def cpu8(monkeypatch):
    """8 virtual shards of the CPU as the port's visible devices (the
    JAX package's conftest gives it 8 virtual CPU devices)."""
    assert len(jax.devices()) >= 8, "needs the 8-device CPU platform"
    monkeypatch.setattr(tmesh, "visible_devices", lambda device="cuda":
                        [CPU] * 8 if torch.device(device).type == "cpu"
                        else [])
    return [CPU] * 8


def _tmesh(data, model=1):
    return tmesh.make_mesh(devices=[CPU] * (data * model), data=data,
                           model=model)


# ----------------------------------------------------- the audit step

def _device_setup(pkg, template, constraints, objects):
    """Generic analog of workload.build_eval_setup for any template, in
    either package."""
    if pkg == "jax":
        driver, backend, target = TpuDriver(), JBackend, JTarget
        extract, encode = jextract, jencode
    else:
        driver, backend, target = (TorchDriver(device="cpu"), TBackend,
                                   TTarget)
        extract, encode = textract, tencode
    client = backend(driver).new_client([target()])
    client.add_template(template)
    for c in constraints:
        client.add_constraint(c)
    kind = constraints[0]["kind"]
    ct = driver.compiled_for(kind)
    assert ct is not None, f"{kind} must device-compile"
    reviews = []
    for o in objects:
        r = {"kind": {"group": "", "version": o.get("apiVersion", "v1"),
                      "kind": o["kind"]},
             "name": o["metadata"]["name"], "object": o}
        if "namespace" in o["metadata"]:
            r["namespace"] = o["metadata"]["namespace"]
        reviews.append(r)
    feats, _, _ = extract(ct.program, driver.strtab, reviews)
    cons = driver._constraints(TARGET)
    pd = [(c.get("spec") or {}).get("parameters") or {} for c in cons]
    params = encode(ct.program, pd, driver.strtab, driver.match_tables)
    derived = driver._derived_arrays(kind, ct)
    table = driver.match_tables.materialize_packed()
    return ct, feats, params, table, derived


def _run_jax(ct, feats, params, table, derived, data, model, n_valid=None):
    mesh = jmesh.make_mesh(devices=jax.devices()[: data * model],
                           data=data, model=model)
    feats, n_feat = jmesh.pad_batch(feats, data)
    n_valid = n_feat if n_valid is None else n_valid
    feats = jmesh.shard_features(feats, mesh)
    params = jmesh.shard_params(params, mesh, shard_c=model > 1)
    fires, counts = jstep(ct._eval, mesh)(feats, params, table, derived,
                                          np.int32(n_valid))
    return np.asarray(fires)[:n_valid], np.asarray(counts)


def _run_port(ct, feats, params, table, derived, data, model,
              n_valid=None):
    mesh = _tmesh(data, model)
    feats, n_feat = tmesh.pad_batch(feats, data)
    n_valid = n_feat if n_valid is None else n_valid
    feats = tmesh.shard_features(feats, mesh)
    params = tmesh.shard_params(params, mesh, shard_c=model > 1)
    fires, counts = make_audit_step(ct.words, mesh)(
        feats, params, table, derived, n_valid)
    assert fires.dtype == torch.bool and counts.dtype == torch.int32
    assert not fires[n_valid:].any(), "padding rows must be written False"
    return fires.numpy()[:n_valid], counts.numpy()


def _single_port(ct, feats, params, table, derived):
    return ct.fires(*(tree_from_numpy(x, "cpu")
                      for x in (feats, params, table, derived)))


@pytest.mark.parametrize("case", [
    # (objects, constraints, violate_frac, data, model, n_valid)
    (64, 8, 0.4, 8, 1, None),     # sharded equals single device
    (53, 4, 0.5, 8, 1, 53),       # uneven batch padding masked
    (32, 6, 0.5, 4, 2, None),     # the model axis shards constraints
], ids=["sharded_equals_single", "uneven_padding", "model_axis"])
def test_sharded_step_equals_single_device_and_jax(case):
    n_obj, n_cons, frac, data, model, n_valid = case
    _, jct, jf, jp, jt, jd, _, _ = jsetup(n_objects=n_obj,
                                          n_constraints=n_cons,
                                          violate_frac=frac)
    _, ct, f, p, t, d, _, cons = build_eval_setup(
        n_objects=n_obj, n_constraints=n_cons, violate_frac=frac,
        device="cpu")
    n = n_obj if n_valid is None else n_valid
    expected = _single_port(ct, f, p, t, d)[:n]
    fires, counts = _run_port(ct, f, p, t, d, data, model, n_valid)
    jfires, jcounts = _run_jax(jct, jf, jp, jt, jd, data, model, n_valid)
    assert fires.shape == (n, len(cons))
    assert (fires == expected).all() and (fires == jfires).all()
    assert (counts == expected.sum(axis=0)).all()
    assert (counts == jcounts).all()
    assert counts.sum() > 0


def test_derived_columns_through_the_mesh():
    """A to_number-derived vocab column (host-precomputed lookup table)
    flows to every shard as a replicated operand and agrees with the
    single-device sweep and with the JAX package's shard_map."""
    template = {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": "k8smaxreplicas"},
        "spec": {
            "crd": {"spec": {"names": {"kind": "K8sMaxReplicas"}}},
            "targets": [{"target": TARGET, "rego": """
package k8smaxreplicas
violation[{"msg": "too many replicas"}] {
  to_number(input.review.object.metadata.labels.replicas) > input.parameters.max
}
"""}],
        },
    }
    constraints = [{
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sMaxReplicas", "metadata": {"name": f"c{i}"},
        "spec": {"parameters": {"max": m}},
    } for i, m in enumerate([2, 5, 7])]
    objects = [{"apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": f"n{i}",
                             "labels": {"replicas": str(i)}}}
               for i in range(24)]
    ct, feats, params, table, derived = _device_setup(
        "torch", template, constraints, objects)
    jct, jf, jp, jt, jd = _device_setup("jax", template, constraints,
                                        objects)
    assert derived, "template must actually produce a derived column"
    expected = _single_port(ct, feats, params, table, derived)[:24]
    fires, counts = _run_port(ct, feats, params, table, derived, 8, 1, 24)
    jfires, jcounts = _run_jax(jct, jf, jp, jt, jd, 8, 1, 24)
    assert (fires == expected).all() and (fires == jfires).all()
    assert (counts == expected.sum(axis=0)).all()
    assert (counts == jcounts).all() and counts.sum() > 0
    # ground truth: replicas i violates max m iff i > m
    want = np.array([[i > m for m in [2, 5, 7]] for i in range(24)])
    assert (expected == want).all()


def test_make_mesh_validates_factorization():
    for make, devs in ((tmesh.make_mesh, [CPU] * 8),
                       (jmesh.make_mesh, jax.devices()[:8])):
        with pytest.raises(ValueError):
            make(devices=devs[:6], data=4, model=2)
        with pytest.raises(ValueError):
            make(devices=devs[:7], model=2)
    mesh = tmesh.make_mesh(devices=[CPU] * 8, model=2)
    assert dict(mesh.shape) == dict(jmesh.make_mesh(
        devices=jax.devices()[:8], model=2).shape) == {"data": 4,
                                                       "model": 2}


# ---------------------------------------------------- the driver's mesh

def _mesh_driver(n_min=64):
    """TorchDriver on the port's 8 visible virtual shards, mesh path
    forced on (the reference's _mesh_driver)."""
    drv = TorchDriver(device="cpu")
    assert drv._mesh is not None, "8 visible shards must yield a mesh"
    drv.MESH_MIN_REVIEWS = n_min
    return pin(drv)


def _jax_mesh_driver(n_min=64):
    drv = TpuDriver()
    assert drv._mesh is not None, "8-device platform must yield a mesh"
    drv.MESH_MIN_REVIEWS = n_min
    return pin(drv)


def _clients(n_min=64):
    """(port mesh, port single, JAX mesh) clients."""
    single = pin(TorchDriver(device="cpu"))
    single._mesh = None
    return [TBackend(_mesh_driver(n_min)).new_client([TTarget()]),
            TBackend(single).new_client([TTarget()]),
            JBackend(_jax_mesh_driver(n_min)).new_client([JTarget()])]


def _labels_workload(client, n, owners=True):
    pol = jpol if isinstance(client.driver, TpuDriver) else tpol
    client.add_template(pol.load("general/requiredlabels"))
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sRequiredLabels", "metadata": {"name": "need-owner"},
        "spec": {"parameters": {"labels": [{"key": "owner"}]}}})
    for i in range(n):
        o = {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": f"ns{i:05d}"}}
        if owners and i % 3 == 0:
            o["metadata"]["labels"] = {"owner": "me"}
        client.add_data(o)


def _audit_key(results):
    return sorted(_ordered(results))


def _ordered(results):
    return [(r.msg, (r.resource or {}).get("metadata", {}).get("name", ""))
            for r in results]


def test_driver_mesh_audit_equals_single_device(cpu8):
    """The production audit path sharded over the mesh (through
    client.audit()) equals the single-device driver, the interpreter
    and TpuDriver's mesh exactly, and takes the mesh path (asserted via
    last_audit_path, so this cannot go vacuous)."""
    from gatekeeper_tpu_torch.client import RegoDriver

    N = 2048
    cm, cs, cj = _clients()
    ci = TBackend(RegoDriver()).new_client([TTarget()])
    for c in (cm, cs, cj, ci):
        _labels_workload(c, N)
    got = [_audit_key(c.audit().results()) for c in (cm, cs, cj, ci)]
    assert cm.driver.last_audit_path == "mesh(data=8)"
    assert cs.driver.last_audit_path == "single(cpu)"
    assert cj.driver.last_audit_path == "mesh(data=8)"
    assert got[0] == got[1] == got[2] == got[3]
    assert len(got[0]) == N - (N + 2) // 3, "non-vacuous"
    assert cm.driver.templates_debug()["mesh"] == {"data": 8, "model": 1}
    # steady state: the results delta cache answers, no sweep
    assert _audit_key(cm.audit().results()) == got[0]
    assert cm.driver.last_audit_path == "delta(1/1)"
    # a delete breaks the journal: the full mesh sweep runs again over
    # rebuilt sharded buffers
    for c in (cm, cs, cj):
        c.remove_data({"apiVersion": "v1", "kind": "Namespace",
                       "metadata": {"name": "ns00001"}})
    again = [_audit_key(c.audit().results()) for c in (cm, cs, cj)]
    assert cm.driver.last_audit_path == "mesh(data=8)"
    assert cj.driver.last_audit_path == "mesh(data=8)"
    assert again[0] == again[1] == again[2]
    assert len(again[0]) == len(got[0]) - 1


def _all_violating(client, n):
    _labels_workload(client, n, owners=False)


def test_driver_mesh_gather_capacity_retry(cpu8):
    """Every object violating: each shard's pair block overflows its
    initial capacity and re-runs at a larger one without losing rows,
    as TpuDriver's does."""
    N = 4096  # 512 firing rows per shard > the 256 initial capacity
    cm, _cs, cj = _clients()
    for c in (cm, cj):
        _all_violating(c, N)
    out, jout = cm.audit().results(), cj.audit().results()
    assert cm.driver.last_audit_path == cj.driver.last_audit_path \
        == "mesh(data=8)"
    assert len(out) == N, f"{len(out)} != {N} (rows lost in retry?)"
    assert _audit_key(out) == _audit_key(jout)
    ct = cm.driver.compiled_for("K8sRequiredLabels")
    jct = cj.driver.compiled_for("K8sRequiredLabels")
    assert ct._rows_cap_mesh == jct._rows_cap_mesh >= 512


def test_driver_mesh_gather_capacity_ratchets(cpu8, monkeypatch):
    """Alternating small/large mesh sweeps: the per-shard capacity
    RATCHETS (never reset down), so a grow after a shrink dispatches
    each shard's K1 once, with no overflow re-run."""
    N = 4096
    cm, _cs, cj = _clients()
    for c in (cm, cj):
        _all_violating(c, N)
    assert len(cm.audit().results()) == len(cj.audit().results()) == N
    ct = cm.driver.compiled_for("K8sRequiredLabels")
    jct = cj.driver.compiled_for("K8sRequiredLabels")
    cap_grown = ct._rows_cap_mesh
    assert cap_grown >= 512

    def relabel(client, owner):
        # in-place churn (same N, same buckets): every sweep stays on the
        # mesh path with identical shapes
        for i in range(N):
            o = {"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": f"ns{i:05d}"}}
            if owner:
                o["metadata"]["labels"] = {"owner": "me"}
            client.add_data(o)
        client.driver._audit_results_cache.clear()  # force the sweep

    for c in (cm, cj):
        relabel(c, owner=True)  # shrink: no firing rows
    assert cm.audit().results() == [] == cj.audit().results()
    assert cm.driver.last_audit_path == "mesh(data=8)"
    assert ct._rows_cap_mesh == jct._rows_cap_mesh >= cap_grown, \
        "gather capacity shrank after a small sweep"

    for c in (cm, cj):
        relabel(c, owner=False)  # grow again: 512 firing rows a shard
    calls = []
    orig = evaltorch._mesh_compact
    monkeypatch.setattr(evaltorch, "_mesh_compact",
                        lambda *a: calls.append(a) or orig(*a))
    out = cm.audit().results()
    assert cm.driver.last_audit_path == "mesh(data=8)"
    assert len(out) == len(cj.audit().results()) == N
    # one K1 per shard; with a reset capacity the overflow would re-run
    # every shard's K1 mid-consume
    assert len(calls) == 8, f"overflow re-run: {len(calls)} K1 dispatches"


def test_driver_mesh_respects_min_reviews(cpu8):
    """Below the mesh threshold the driver stays single-device, as
    TpuDriver does."""
    cm, _cs, cj = _clients(n_min=1 << 30)
    for c in (cm, cj):
        _labels_workload(c, 2048)
    out, jout = cm.audit().results(), cj.audit().results()
    assert cm.driver.last_audit_path == "single(cpu)"
    assert cj.driver.last_audit_path == "single"
    assert _audit_key(out) == _audit_key(jout)
    assert len(out) == 2048 - (2048 + 2) // 3


def test_sharded_inventory_join_membership():
    """The inventory-join membership kernel (K4, ir/join.py) with the
    review keys split over 8 shards and the key table replicated equals
    one launch over every row, and the JAX package's join program under
    shard_map over its 8 devices."""
    arrs = k4_synthetic(5, 200, 2, 64, 4)
    u_p, cnt_p, sik_p, karr, iks = arrs
    want = join_member(*tree_from_numpy(arrs, "cpu"),
                       tjoin.KEY_PAD).numpy()
    mesh = _tmesh(8)
    tables = [tmesh.replicate(a, mesh) for a in (u_p, cnt_p, sik_p)]
    rev = [tmesh.place(a, mesh, "data") for a in (karr, iks)]
    got = np.concatenate([
        join_member(*(t.block(d) for t in tables),
                    *(r.block(d) for r in rev), tjoin.KEY_PAD).numpy()
        for d in range(8)])

    jd = TpuDriver()
    client = JBackend(jd).new_client([JTarget()])
    client.add_template(jpol.load("general/uniqueingresshost"))
    kernel = jd.join_for("K8sUniqueIngressHost")._jit_wrapper()
    jm = jmesh.make_mesh(devices=jax.devices()[:8], data=8, model=1)
    sharded = jax.jit(jmesh.shard_map_wrap(
        kernel, jm, (P(), P(), P(), P("data", None), P("data", None)),
        P("data")))
    jgot = np.asarray(sharded(*arrs))
    assert (got == want).all() and (jgot == want).all()
    assert want.any() and not want.all(), "non-vacuous membership split"


def test_driver_mesh_slab_loop_equals_mono(cpu8, monkeypatch):
    """The double-buffered mesh SLAB loop gives exactly the single-device
    results in the same global row-major order (its blocks come in
    (slab, shard) order and the consume reassembles them), across
    several slabs per shard, as TpuDriver's slab loop does."""
    N = 16384
    cm, cs, cj = _clients()
    for c in (cm, cj):
        c.driver.sweep_chunk = 256
        c.driver.mesh_slab_local = 512  # n_loc 2,048: 4 slabs per shard
    for c in (cm, cs, cj):
        _labels_workload(c, N)
    handles = []
    orig = cm.driver._dispatch_handle
    monkeypatch.setattr(cm.driver, "_dispatch_handle",
                        lambda *a, **k: handles.append(orig(*a, **k))
                        or handles[-1])
    got = _ordered(cm.audit().results())
    assert cm.driver.last_audit_path == "mesh(data=8)"
    assert any(isinstance(h, evaltorch._MeshSlabPairs) for h in handles), \
        "audit did not take the slab loop"
    want = _ordered(cs.audit().results())
    jgot = _ordered(cj.audit().results())
    assert cj.driver.last_audit_path == "mesh(data=8)"
    assert got == want == jgot
    assert len(got) == N - (N + 2) // 3, "non-vacuous"


def test_mesh_slab_dispatch_direct_overflow_and_order():
    """fires_pairs_mesh_dispatch with a forced small slab: every object
    firing overflows the per-shard capacity inside each slab; the retry
    loses no row and the capacity ratchets, in both packages."""
    _d, ct, f, p, t, d, reviews, _c = build_eval_setup(
        n_objects=4096, n_constraints=1, violate_frac=1.0, device="cpu")
    _jd, jct, jf, jp, jt, jdv, _jr, _jc = jsetup(
        n_objects=4096, n_constraints=1, violate_frac=1.0)
    rows = {}
    for pkg, c, args, mesh in (
            ("torch", ct, (f, p, t), _tmesh(8)),
            ("jax", jct, (jf, jp, jt),
             jmesh.make_mesh(devices=jax.devices()[:8], data=8, model=1))):
        c._rows_cap_mesh = 8  # force the per-slab overflow retry
        handle = c.fires_pairs_mesh_dispatch(
            *args, mesh, d if pkg == "torch" else jdv, chunk=128,
            n_true=len(reviews), slab=128)  # n_loc 512: 4 slabs
        rows[pkg] = np.concatenate([r for r, _c2 in handle.pairs()])
        assert c._rows_cap_mesh > 8, "gather capacity did not ratchet"
    expected = _single_port(ct, f, p, t, d)[: len(reviews)]
    want = np.flatnonzero(expected.any(axis=1))
    assert sorted(rows["torch"].tolist()) == want.tolist()
    assert rows["torch"].tolist() == rows["jax"].tolist()
    assert len(want) > 64, "non-vacuous overflow workload"
    assert ct._rows_cap_mesh == jct._rows_cap_mesh


def test_mesh_dispatch_refuses_undivisible_shapes():
    _d, ct, f, p, t, d, _r, _c = build_eval_setup(
        n_objects=64, n_constraints=2, device="cpu")
    with pytest.raises(ValueError, match="not shardable"):
        ct.fires_pairs_mesh_dispatch(f, p, t, _tmesh(3), d)
    with pytest.raises(ValueError, match="slab="):
        ct.fires_pairs_mesh_dispatch(f, p, t, _tmesh(2), d, chunk=8,
                                     slab=12)


def test_review_batch_sparse_mesh_equals_interpreter(cpu8):
    """A review batch at audit scale routes through the sparse pair path
    sharded over the mesh and equals the interpreter and TpuDriver's
    mesh exactly."""
    from gatekeeper_tpu_torch.client import RegoDriver

    N = 2048
    cm, _cs, cj = _clients()
    ri = TBackend(RegoDriver()).new_client([TTarget()])
    for c in (cm, cj, ri):
        c.driver.SPARSE_BATCH_MIN = 256
        _labels_workload(c, 0)  # template + constraint only

    def reviews():
        out = []
        for i in range(N):
            o = {"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": f"ns{i:05d}"}}
            if i % 3 == 0:
                o["metadata"]["labels"] = {"owner": "me"}
            out.append({"kind": {"group": "", "version": "v1",
                                 "kind": "Namespace"},
                        "name": o["metadata"]["name"], "object": o})
        return out

    got = cm.driver.review_batch(TARGET, reviews())
    assert cm.driver.last_review_batch_path == "mesh(data=8)"
    jgot = cj.driver.review_batch(TARGET, reviews())
    want = [ri.driver.query(("hooks", TARGET, "violation"),
                            {"review": r}).results for r in reviews()]
    key = [sorted(r.msg for r in per) for per in got]
    assert key == [sorted(r.msg for r in per) for per in want]
    assert key == [sorted(r.msg for r in per) for per in jgot]
    assert sum(1 for per in got if per) == N - (N + 2) // 3


# ------------------------------------------------- mesh edge conditions

def test_pad_batch_non_divisible_counts():
    feats = {"slot": {"a": np.arange(10, dtype=np.int32),
                      "b": np.ones((10, 3), dtype=np.float32)}}
    for mult in (8, 5):
        out, n_true = tmesh.pad_batch(feats, mult)
        jout, jn = jmesh.pad_batch(feats, mult)
        assert n_true == jn == 10
        for nm in ("a", "b"):
            assert out["slot"][nm].shape == jout["slot"][nm].shape
            assert np.array_equal(out["slot"][nm], jout["slot"][nm])
    out, _ = tmesh.pad_batch(feats, 8)
    assert out["slot"]["a"].shape == (16,) and out["slot"]["b"].shape \
        == (16, 3)
    assert (out["slot"]["a"][10:] == 0).all() and \
        (out["slot"]["b"][10:] == 0).all()


def test_build_mesh_rounds_down_to_power_of_two(cpu8, monkeypatch,
                                                caplog):
    """6 visible devices shard over 4 (with a warning) in both
    packages."""
    monkeypatch.setenv("GATEKEEPER_TPU_MESH", "6")
    with caplog.at_level(logging.WARNING,
                         logger="gatekeeper_tpu_torch.ir.driver"):
        drv = TorchDriver(device="cpu")
    assert dict(drv._mesh.shape) == {"data": 4, "model": 1}
    assert any("rounded down" in r.message for r in caplog.records
               if r.name == "gatekeeper_tpu_torch.ir.driver")
    assert dict(TpuDriver()._mesh.shape) == dict(drv._mesh.shape)


def test_build_mesh_off_capped_and_pinned(cpu8, monkeypatch):
    for cfg, want in (("off", None), ("2", {"data": 2, "model": 1}),
                      ("1", None), ("auto", {"data": 8, "model": 1})):
        monkeypatch.setenv("GATEKEEPER_TPU_MESH", cfg)
        got = TorchDriver(device="cpu")._mesh
        jgot = TpuDriver()._mesh
        assert (None if got is None else dict(got.shape)) == want
        assert (None if jgot is None else dict(jgot.shape)) == want
    # a driver pinned to one device has no mesh, even when one is given,
    # as TpuDriver(device=...) has none
    mesh = _tmesh(8)
    assert TorchDriver(device="cpu:0", mesh=mesh)._mesh is None
    assert TpuDriver(device=0)._mesh is None
    assert TorchDriver(device="cpu", mesh=mesh)._mesh is mesh
    # a mesh of another device type is refused: no silent fallback
    from gatekeeper_tpu_torch.client.drivers import DriverError

    other = tmesh.Mesh([[torch.device("meta")]])
    with pytest.raises(DriverError, match="not the driver's"):
        TorchDriver(device="cpu", mesh=other)


def test_shard_and_replicate_specs_on_host_mesh():
    """Placement specs equal the JAX package's PartitionSpecs: features
    split on "data" along the leading axis, params replicated by default
    (split over "model" when asked), scalars replicated; every mesh
    position holds a block."""
    feats = {"s": {"a": np.zeros((16, 5), np.int32),
                   "v": np.zeros(16, np.int32)}}
    params = {"s": {"p": np.zeros((8, 3), np.int32)}}
    mesh = _tmesh(4, 2)
    jm = jmesh.make_mesh(devices=jax.devices()[:8], data=4, model=2)
    sf, jsf = tmesh.shard_features(feats, mesh), \
        jmesh.shard_features(feats, jm)
    for nm in ("a", "v"):
        assert sf["s"][nm].spec == tuple(jsf["s"][nm].sharding.spec)
    assert sf["s"]["a"].spec == ("data", None)
    for shard_c in (False, True):
        sp = tmesh.shard_params(params, mesh, shard_c=shard_c)
        jsp = jmesh.shard_params(params, jm, shard_c=shard_c)
        assert sp["s"]["p"].spec == tuple(jsp["s"]["p"].sharding.spec)
    r = tmesh.replicate(np.float32(3.0), mesh)
    assert r.spec == tuple(jmesh.replicate(np.float32(3.0),
                                           jm).sharding.spec) == ()
    # every mesh position holds a block; blocks of a feature leaf are its
    # rows d*4:(d+1)*4 (views of the host array on the CPU)
    a = sf["s"]["a"]
    assert len(a.blocks) == len(jsf["s"]["a"].sharding.device_set) == 8
    assert a.block(1, 1).shape == (4, 5)
    assert np.shares_memory(a.block(2, 0).numpy(), feats["s"]["a"])


def test_dev_mesh_cache_lru_bounded(cpu8):
    """The placement cache is LRU-bounded at DEV_MESH_CACHE_MAX and a hit
    refreshes recency, as TpuDriver's is."""
    survivors = []
    for drv in (_mesh_driver(), _jax_mesh_driver()):
        drv.DEV_MESH_CACHE_MAX = 8
        keep = [np.full((16,), i, np.int32) for i in range(12)]
        first = keep[0]
        drv._dev_mesh({"s": {"a": first}}, data_leading=True)
        assert (id(first), True) in drv._dev_mesh_cache
        for a in keep[1:8]:
            drv._dev_mesh({"s": {"a": a}}, data_leading=True)
            drv._dev_mesh({"s": {"a": first}}, data_leading=True)
        assert len(drv._dev_mesh_cache) == 8
        for a in keep[8:]:
            drv._dev_mesh({"s": {"a": a}}, data_leading=True)
        assert len(drv._dev_mesh_cache) == drv.DEV_MESH_CACHE_MAX
        survivors.append([(id(a), True) in drv._dev_mesh_cache
                          for a in keep])
        assert survivors[-1][0] and not survivors[-1][1]
        again = drv._dev_mesh({"s": {"a": first}}, data_leading=True)
        got = again["s"]["a"]
        got = np.concatenate([got.block(d).numpy() for d in range(8)]) \
            if isinstance(got, tmesh.Sharded) else np.asarray(got)
        assert got.tolist() == first.tolist()
    assert survivors[0] == survivors[1]


# ---------------------------------------------------- K6 against JAX

@pytest.mark.parametrize("case", [
    # (objects, constraints, data, n_valid): a ragged C (not a multiple
    # of 32) and n_valid inside the last shard
    (60, 37, 8, 60), (64, 8, 8, 64), (100, 45, 4, 97), (29, 70, 2, 29),
])
def test_k6_plain_equals_jax_step_counts(case):
    """Each shard's K6 epilogue (the plain version) over the words of the
    port's template: its bool block equals the JAX step's fires there,
    and the shards' counts, added into one zeroed partial, equal the JAX
    step's counts."""
    n_obj, n_cons, data, n_valid = case
    _d, ct, f, p, t, d, _r, _c = build_eval_setup(
        n_objects=n_obj, n_constraints=n_cons, violate_frac=0.3,
        device="cpu")
    _jd, jct, jf, jp, jt, jdv, _jr, _jc = jsetup(
        n_objects=n_obj, n_constraints=n_cons, violate_frac=0.3)
    jfires, jcounts = _run_jax(jct, jf, jp, jt, jdv, data, 1, n_valid)
    fp, _n = tmesh.pad_batch(f, data)
    words = ct.words(*(tree_from_numpy(x, "cpu") for x in (fp, p, t, d)))
    n_loc = words.shape[0] // data
    assert n_valid > (data - 1) * n_loc, \
        "n_valid must fall inside the last shard"
    out = torch.zeros((n_cons,), dtype=torch.int32)
    fires = torch.empty((data * n_loc, n_cons), dtype=torch.bool)
    for k in range(data):
        rows = slice(k * n_loc, (k + 1) * n_loc)
        shard_counts_plain(words[rows], 0, n_valid - k * n_loc, n_cons,
                           fires[rows], out)
    assert out.numpy().tolist() == jcounts.tolist()
    assert fires[:n_valid].numpy().tolist() == jfires[:n_valid].tolist()
    assert not fires[n_valid:].any()
    assert jcounts.sum() > 0


# --------------------------------------------- the randomized mesh net

def _fuzz_client(pkg, driver):
    backend, target, pol = ((JBackend, JTarget, jpol) if pkg == "jax"
                            else (TBackend, TTarget, tpol))
    client = backend(driver).new_client([target()])
    for name in pol.names():
        client.add_template(pol.load(name))
    for kind, params in FUZZ_CONSTRAINTS:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": kind.lower()},
            "spec": ({"parameters": params} if params else {}),
        })
    return client


def _norm(results):
    return sorted(
        (r.msg, r.constraint["metadata"]["name"],
         (r.resource or {}).get("metadata", {}).get("name", ""))
        for r in results)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fuzz_mesh_audit_equals_single_and_jax(cpu8, seed):
    """The reference's adversarial fuzz objects (tests/
    test_differential_fuzz.py) over its templates: TorchDriver on the 8
    virtual shards (MESH_MIN_REVIEWS 0) equals TorchDriver on one device
    and TpuDriver on its 8-device mesh, in message, constraint and
    resource, every driver pinned to the device path."""
    rng = random.Random(seed)
    objs = [_rand_object(rng, i) for i in range(120)]
    mesh_drv = _mesh_driver(n_min=0)
    single = pin(TorchDriver(device="cpu"))
    single._mesh = None
    jdrv = _jax_mesh_driver(n_min=0)
    clients = [_fuzz_client("torch", mesh_drv),
               _fuzz_client("torch", single), _fuzz_client("jax", jdrv)]
    for c in clients:
        for o in objs:
            c.add_data(o)
    got = [_norm(c.audit().results()) for c in clients]
    assert mesh_drv.last_audit_path == "mesh(data=8)", \
        mesh_drv.last_audit_path
    assert single.last_audit_path == "single(cpu)"
    assert got[0] == got[1], f"mesh != single device (seed={seed})"
    assert got[0] == got[2], f"port mesh != TpuDriver mesh (seed={seed})"
    assert got[0], f"vacuous fuzz audit (seed={seed})"
    counts = mesh_drv.eval_counts()
    assert any(p == "device" for (_k, p) in counts), counts
