"""BENCH config 10's audit (bench_configs.py config10) and BENCH config 1
(config1) through the port against the JAX package, at a CPU size.

Config 10 is the flagship template with 100 synth_constraints(seed=1)
over synth_objects(N, violate_frac=0.002, seed=0); the card runs it at
1,000,000 objects (chip_smoke.py phase 21). Here N is 16,384 with the
sweep chunk cut so that the audit takes the same shapes of path as at
full size: on one device `_sweep_slab` gives 2 slabs (507,904 rows each
at full size, 8,192 here), and over 8 virtual shards the mesh's local
slab loop runs its default plan (8 slabs a shard: 16,384 rows at full
size, 256 here). TorchDriver(device="cpu") against TpuDriver, both
pinned to the device path (torch_fuzz_gen's pin), the mesh as
tests/test_torch_parallel.py builds it (the port's visible devices
substituted by 8 virtual CPU shards, the JAX package's 8 virtual CPU
devices from the conftest).

Tolerance: exact equality (result tuples in order, counts, capacities).
"""

from __future__ import annotations

import pytest

from gatekeeper_tpu import policies as jpol
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.client import RegoDriver as JRegoDriver
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.ir import evaljax
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies as tpol
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client import RegoDriver
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir import evaltorch
from gatekeeper_tpu_torch.parallel.workload import (
    REQUIRED_LABELS_TEMPLATE, synth_constraints, synth_objects)
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

from .test_torch_parallel import cpu8  # noqa: F401
from .torch_bench_configs import (
    C1_CONSTRAINT, C1_OBJECTS, C1_VIOLATE_FRAC, C10_CONSTRAINTS,
    C10_VIOLATE_FRAC, bench_constraint)
from .torch_fuzz_gen import pin

N = 16_384


@pytest.fixture(scope="module")
def objects():
    return synth_objects(N, violate_frac=C10_VIOLATE_FRAC, seed=0)


def _pinned(drv, chunk: int):
    """The device path forced (torch_fuzz_gen's pin) at a sweep chunk of
    `chunk` rows."""
    pin(drv).sweep_chunk = chunk
    return drv


def _config10(drv, objs):
    jax_side = isinstance(drv, TpuDriver)
    client = (JBackend(drv).new_client([JTarget()]) if jax_side else
              TBackend(drv).new_client([TTarget()]))
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    for c in synth_constraints(C10_CONSTRAINTS, seed=1):
        client.add_constraint(c)
    for o in objs:
        client.add_data(o)
    return client


def _ordered(results):
    return [(r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name", ""), r.msg)
            for r in results]


def _spy(drv, handles: list):
    orig = drv._dispatch_handle

    def spy(*a, **k):
        handles.append(orig(*a, **k))
        return handles[-1]

    drv._dispatch_handle = spy


def _first_and_warm(drv, client) -> list:
    """The first audit and a full warm sweep (the delta cache cleared, as
    bench_configs._mesh_audit_child measures it)."""
    first = _ordered(client.audit().results())
    drv._audit_results_cache.clear()
    warm = _ordered(client.audit().results())
    assert warm == first
    return first


def test_config10_two_slabs_equal_tpudriver(objects):
    """One device: 2 slabs of _sweep_slab rows in both packages, results
    equal per constraint and in order, the same final pair capacity."""
    tdrv = _pinned(TorchDriver(device="cpu"), 1024)
    tdrv._mesh = None
    jdrv = _pinned(TpuDriver(), 1024)
    jdrv._mesh = None
    th, jh = [], []
    _spy(tdrv, th)
    _spy(jdrv, jh)
    got = _first_and_warm(tdrv, _config10(tdrv, objects))
    want = _first_and_warm(jdrv, _config10(jdrv, objects))
    assert tdrv.last_audit_path == "single(cpu)"
    assert jdrv.last_audit_path == "single"
    assert tdrv._sweep_slab(N, 1024) == 8192
    assert [len(h._pend) for h in th
            if isinstance(h, evaltorch._SlabPairs)] == [2, 2]
    assert [len(h._pend) for h in jh
            if isinstance(h, evaljax._SlabPairs)] == [2, 2]
    assert got == want
    assert len({c for c, _o, _m in got}) > 1, "non-vacuous"
    assert tdrv.compiled_for("K8sRequiredLabels")._rows_cap == \
        jdrv.compiled_for("K8sRequiredLabels")._rows_cap


def test_config10_mesh8_slab_loop_equals_one_device(cpu8, objects):
    """Over 8 shards: both packages' default mesh takes mesh(data=8) and
    its local slab loop (8 slabs a shard), results equal in order to one
    device's, the same per-shard pair capacity."""
    chunk = 256
    tdrv = _pinned(TorchDriver(device="cpu"), chunk)
    jdrv = _pinned(TpuDriver(), chunk)
    single = _pinned(TorchDriver(device="cpu"), chunk)
    single._mesh = None
    assert tdrv._mesh.shape["data"] == jdrv._mesh.shape["data"] == 8
    th, jh = [], []
    _spy(tdrv, th)
    _spy(jdrv, jh)
    got = _first_and_warm(tdrv, _config10(tdrv, objects))
    jgot = _first_and_warm(jdrv, _config10(jdrv, objects))
    want = _first_and_warm(single, _config10(single, objects))
    assert tdrv.last_audit_path == jdrv.last_audit_path == "mesh(data=8)"
    assert single.last_audit_path == "single(cpu)"
    ct = tdrv.compiled_for("K8sRequiredLabels")
    assert ct._mesh_plan(N, 8, chunk, None) == (2048, chunk, 256)
    assert th and all(isinstance(h, evaltorch._MeshSlabPairs) for h in th)
    assert jh and all(isinstance(h, evaljax._MeshSlabPairs) for h in jh)
    assert got == want == jgot and len(got) > 0
    assert ct._rows_cap_mesh == \
        jdrv.compiled_for("K8sRequiredLabels")._rows_cap_mesh


@pytest.mark.parametrize("pinned", [False, True])
def test_config1_equals_tpudriver_and_rego(pinned):
    """BENCH config 1 (general/requiredlabels, one allowedRegex) as the
    drivers decide and pinned to the device path: the port equals
    TpuDriver, the port's RegoDriver and the JAX package's."""
    objs = synth_objects(C1_OBJECTS, violate_frac=C1_VIOLATE_FRAC, seed=7)

    def run(drv, backend, target, pol):
        if pinned and not isinstance(drv, (RegoDriver, JRegoDriver)):
            pin(drv)
        client = backend(drv).new_client([target()])
        client.add_template(pol.load("general/requiredlabels"))
        client.add_constraint(C1_CONSTRAINT)
        for o in objs:
            client.add_data(o)
        return _ordered(client.audit().results())

    tdrv = TorchDriver(device="cpu")
    got = run(tdrv, TBackend, TTarget, tpol)
    assert got == run(TpuDriver(), JBackend, JTarget, jpol)
    assert got == run(RegoDriver(), TBackend, TTarget, tpol)
    assert got == run(JRegoDriver(), JBackend, JTarget, jpol)
    assert len(got) == 1  # BENCH_r07 config 1's violations
    if pinned:
        assert tdrv.last_audit_path == "single(cpu)"


def test_config1_constraint_is_bench_configs():
    """The copy of config 1's constraint that phase 21 (d) and this file
    use is the one bench_configs.config1 audits with."""
    assert C1_CONSTRAINT == bench_constraint("config1")
