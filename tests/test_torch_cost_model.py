"""The port's cost model (TorchDriver._use_device_for_batch) against the
JAX package's TpuDriver.

The same sequence of latency samples, host-rate samples and masked-pair
counts goes to both drivers: every decision (probe, floor, the periodic
re-probe, the EMA crossing) and the state after it must be equal. Review
batches and audits with the gate forced each way, and left to decide,
must return TpuDriver's results. A latency sample that spans a kernel
compile (kernels/build.py's count moved) never enters the EMA, and an
audit's sample leaves out the later kinds' dispatches. Tolerance: exact
equality (decisions, results, and the EMAs computed from equal floats).
"""

import copy
import time

import numpy as np
import pytest

from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.kernels import build as kernel_build
from gatekeeper_tpu_torch.parallel.workload import (
    REQUIRED_LABELS_TEMPLATE,
    synth_constraints,
    synth_objects,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

from .test_torch_frontend import fixture_objects, library_drivers

STATE = ("_dev_batch_lat_s", "_host_pair_rate", "_dev_skips")


def key(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


def replay(drv, steps) -> list:
    """Feed `steps` to one driver: ("use", n) asks _use_device_for_batch,
    ("lat", s) and ("rate", r) feed _observe. Returns each decision with
    the state after it."""
    out = []
    for op, x in steps:
        if op == "use":
            out.append(("use", drv._use_device_for_batch(x),
                        tuple(getattr(drv, a) for a in STATE)))
        else:
            attr = "_dev_batch_lat_s" if op == "lat" else "_host_pair_rate"
            drv._observe(attr, x)
            out.append((op, tuple(getattr(drv, a) for a in STATE)))
    return out


def scripted_steps() -> list:
    """Below the probe floor (host), the first probe, the EMA set by a
    slow sample, 300 host decisions with the 256th a re-probe, a host
    rate that falls until the host estimate crosses the EMA, and fast
    samples that pull the EMA under a 600-pair batch's estimate (a
    50-pair batch stays under the probe floor)."""
    steps = [("use", 10), ("use", 4_999), ("use", 5_000), ("lat", 0.9)]
    steps += [("use", 20_000)] * 300
    steps += [("rate", 10_000.0)] * 10 + [("use", 20_000)] * 3
    steps += [("lat", 0.001)] * 12 + [("use", 600), ("use", 50)]
    return steps


def random_steps(seed: int) -> list:
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(800):
        r = rng.random()
        if r < 0.8:
            steps.append(("use", int(rng.integers(0, 200_000))))
        elif r < 0.9:
            steps.append(("lat", float(rng.lognormal(-3.0, 2.0))))
        else:
            steps.append(("rate", float(rng.uniform(5e3, 5e5))))
    return steps


@pytest.mark.parametrize("seq", ["scripted", 0, 1, 2])
def test_decisions_equal_tpu_driver(seq):
    steps = scripted_steps() if seq == "scripted" else random_steps(seq)
    jd, td = TpuDriver(), TorchDriver(device="cpu")
    assert TorchDriver.PROBE_FLOOR_S == TpuDriver.PROBE_FLOOR_S == 0.05
    assert tuple(getattr(td, a) for a in STATE) == \
        tuple(getattr(jd, a) for a in STATE) == (None, 100_000.0, 0)
    got, want = replay(td, steps), replay(jd, steps)
    assert got == want
    uses = [d[1] for d in want if d[0] == "use"]
    assert any(uses) and not all(uses)
    if seq == "scripted":
        # floor, floor, probe; then 255 skips and the re-probe
        assert uses[:3] == [False, False, True]
        tail = uses[3:303]
        assert tail.index(True) == 255 and tail.count(True) == 1
        # the host rate fell: 20,000 pairs now cost 1.6 s > the EMA
        assert uses[303:306] == [True] * 3
        assert uses[306:] == [True, False]


def _flagship(backend, target, drv, n=600, c=8):
    client = backend(drv).new_client([target()])
    client.add_template(copy.deepcopy(REQUIRED_LABELS_TEMPLATE))
    for con in synth_constraints(c, seed=1):
        client.add_constraint(con)
    for o in synth_objects(n, violate_frac=0.05, seed=0):
        client.add_data(o)
    return client


@pytest.mark.parametrize("gate", ["device", "host", "model"])
def test_library_results_equal_tpu_driver_either_way(gate):
    """The shipped library over the corpus: audit, steady audit and
    review batches equal TpuDriver's with both gates forced to the
    device, forced to the host, and left to the cost model; the host
    gate keeps every compiled kind compiled (no demotion)."""
    jd, td = library_drivers()
    jd.async_warm = False
    for drv in (jd, td):
        if gate != "model":
            drv._use_device_for_batch = (lambda n, g=gate: g == "device")
    objs = fixture_objects(160)
    clients = []
    for backend, target, drv in ((JBackend, JTarget, jd),
                                 (TBackend, TTarget, td)):
        client = backend(drv).new_client([target()])
        for o in objs:
            client.add_data(o)
        clients.append(client)
    jc, tc = clients
    want = key(jc.audit().results())
    assert want
    assert key(tc.audit().results()) == want
    assert key(tc.audit().results()) == key(jc.audit().results())
    for batch in (objs[:80], objs[:3]):
        assert [key(r.results()) for r in tc.review_batch(batch)] == \
            [key(r.results()) for r in jc.review_batch(batch)]
        if len(batch) >= td.MIN_DEVICE_BATCH:
            counts = td.eval_counts()  # a 3-review batch stays on the host
    compiled = td.compiled_kinds()
    assert len(compiled) == 23 and td.fallback_reasons() == {}
    dense = set(td._programs)  # the 21 kinds the gate decides
    assert len(dense) == 21
    dev = {k for k in dense if counts.get((k, "device"), 0)}
    host = {k for k in dense if counts.get((k, "interp"), 0)}
    if gate == "device":
        assert dev == dense and not host
    elif gate == "host":
        assert not dev and host == dense
        # the host rate was measured on a host-served audit
        assert td._host_pair_rate != 100_000.0
    assert all(td.compiled_for(k) is not None for k in dense)


def test_audit_host_gate_keeps_kind_compiled_then_device():
    """An audit the gate keeps on the host leaves the kind compiled: the
    next audit the gate sends to the device sweeps it there, and both
    equal TpuDriver's results."""
    jd, td = TpuDriver(), TorchDriver(device="cpu")
    jd.async_warm = False
    clients = [_flagship(JBackend, JTarget, jd),
               _flagship(TBackend, TTarget, td)]
    for allow in (False, True, False):
        for drv in (jd, td):
            drv._use_device_for_batch = lambda n, a=allow: a
        # a constraint edit invalidates the delta cache: a full sweep
        for client in clients:
            client.add_constraint(synth_constraints(9, seed=allow + 2)[-1])
        jr, tr = (key(c.audit().results()) for c in clients)
        assert tr == jr
        path = "device" if allow else "interp"
        assert td.eval_counts()[("K8sRequiredLabels", path)] >= 1
        assert td._compiled["K8sRequiredLabels"] is not None


def _bump_compiles(monkeypatch, obj, name):
    """Wrap obj.name so that each call counts as a kernel compile."""
    orig = getattr(obj, name)

    def wrapped(*a, **k):
        kernel_build.note_compiles(1)
        return orig(*a, **k)

    monkeypatch.setattr(obj, name, wrapped)


@pytest.mark.parametrize("compile_", [False, True])
def test_review_batch_sample_across_a_compile_is_dropped(monkeypatch,
                                                         compile_):
    """The dense branch's latency sample enters the EMA, unless a kernel
    compiled during it; then the EMA stays as it was."""
    td = TorchDriver(device="cpu")
    client = _flagship(TBackend, TTarget, td, n=50, c=2)
    td._use_device_for_batch = lambda n: True
    if compile_:
        _bump_compiles(monkeypatch, td, "_eval_compiled_gated")
    objs = synth_objects(40, violate_frac=0.2, seed=3)
    client.review_batch(objs)
    assert td.eval_counts()[("K8sRequiredLabels", "device")] == 1
    assert (td._dev_batch_lat_s is None) == compile_


@pytest.mark.parametrize("compile_", [False, True])
def test_sparse_batch_sample_across_a_compile_is_dropped(monkeypatch,
                                                         compile_):
    td = TorchDriver(device="cpu")
    td.SPARSE_BATCH_MIN = 8  # the sparse branch at a small batch
    client = _flagship(TBackend, TTarget, td, n=20, c=2)
    td._use_device_for_batch = lambda n: True
    if compile_:
        _bump_compiles(monkeypatch, td, "_dispatch_handle")
    client.review_batch(synth_objects(40, violate_frac=0.2, seed=3))
    assert (td._dev_batch_lat_s is None) == compile_


def _two_kind_client(drv):
    """requiredlabels plus one more compiled kind, so that the audit
    dispatches two kinds before it consumes the first."""
    from gatekeeper_tpu_torch import policies

    client = _flagship(TBackend, TTarget, drv, n=300, c=4)
    client.add_template(policies.load("general/containerlimits"))
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sContainerLimits", "metadata": {"name": "limits"},
        "spec": {"parameters": {"cpu": "2", "memory": "1Gi"}}})
    return client


@pytest.mark.parametrize("later", ["nothing", "compile", "slow"])
def test_audit_sample_first_kind_only(monkeypatch, later):
    """One latency sample per audit, from the first consumed kind: a
    compile while a later kind dispatches drops it, and a slow later
    dispatch (0.3 s of host work) stays out of it, though it is inside
    the JAX package's sample (dispatch to first result), which
    last_audit_lat_s reports beside it."""
    td = TorchDriver(device="cpu")
    client = _two_kind_client(td)
    td._use_device_for_batch = lambda n: True
    orig = td._dispatch_handle
    calls = []

    def dispatch(*a, **k):
        calls.append(1)
        if len(calls) == 2:  # the second kind's dispatch
            if later == "compile":
                kernel_build.note_compiles(1)
            elif later == "slow":
                time.sleep(0.3)
        return orig(*a, **k)

    monkeypatch.setattr(td, "_dispatch_handle", dispatch)
    samples = []
    real_observe = td._observe

    def observe(attr, value, alpha=0.3):
        if attr == "_dev_batch_lat_s":
            samples.append(value)
        real_observe(attr, value, alpha)

    monkeypatch.setattr(td, "_observe", observe)
    client.audit()
    assert len(calls) == 2  # both kinds dispatched before any consume
    taken, reference = td.last_audit_lat_s
    if later == "compile":
        assert samples == [] and td._dev_batch_lat_s is None
        assert taken is None
    else:
        assert len(samples) == 1 and td._dev_batch_lat_s == samples[0]
        assert samples[0] < 0.3 and taken == samples[0]
    assert reference >= (0.3 if later == "slow" else 0.0)
