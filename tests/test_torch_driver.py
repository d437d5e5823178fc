"""TorchDriver end to end against TpuDriver (and the interpreter).

`Client.audit` and `Client.review_batch` through the port's driver on the
CPU (the kernels' plain versions) must return exactly what the JAX
package's TpuDriver returns: messages, constraints, resources,
enforcement actions, in the same order. The JAX driver is pinned to its
device path (a measured device latency far below any host estimate).
"""

import pytest
import torch

from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.parallel.workload import (
    REQUIRED_LABELS_TEMPLATE,
    synth_constraints,
    synth_objects,
)
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch.client import Backend as TBackend
from gatekeeper_tpu_torch.client.drivers import DriverError
from gatekeeper_tpu_torch.client import RegoDriver as TRegoDriver
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.kernels.clause import clause_words
from gatekeeper_tpu_torch.kernels.pair_compact import pair_compact
from gatekeeper_tpu_torch.target import K8sValidationTarget as TTarget

from .test_torch_frontend import fixture_objects, library_drivers

FLAGSHIP = "K8sRequiredLabels"


def jax_driver():
    drv = TpuDriver()
    drv._dev_batch_lat_s = 1e-4  # pin the device path (cost model off)
    return drv


def key(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


def batch_key(responses):
    return [key(resp.results()) for resp in responses]


def flagship_client(backend, target, drv, n, c, violate_frac=0.01):
    client = backend(drv).new_client([target()])
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    for con in synth_constraints(c, seed=1):
        client.add_constraint(con)
    objs = synth_objects(n, violate_frac=violate_frac, seed=0)
    for o in objs:
        client.add_data(o)
    return client, objs


def test_flagship_audit_and_review_batch_equal_tpu_driver():
    """2,000 objects x 40 constraints with the sweep chunk shrunk so the
    audit runs two slabs and the pair capacity (256) overflows and
    retries."""
    jd = jax_driver()
    jd.sweep_chunk = 256
    td = TorchDriver(device="cpu")
    td.sweep_chunk = 256
    jc, objs = flagship_client(JBackend, JTarget, jd, 2000, 40, 0.1)
    tc, _ = flagship_client(TBackend, TTarget, td, 2000, 40, 0.1)
    slab = td._sweep_slab(2000, 256)
    assert slab == 1024 and 2000 > slab  # the slab path
    launches = clause_words.launches, pair_compact.launches
    want = key(jc.audit().results())
    got = key(tc.audit().results())
    assert len(want) > 2 * 256  # more pairs per slab than the capacity
    assert got == want
    assert td.eval_counts()[(FLAGSHIP, "device")] == 1
    assert td._compiled[FLAGSHIP]._rows_cap > 256
    # CPU tensors take the plain versions: no kernel launched
    assert (clause_words.launches, pair_compact.launches) == launches
    # steady state: the cached features serve the second audit
    assert key(tc.audit().results()) == want
    batch = objs[:600]
    assert batch_key(tc.review_batch(batch)) == \
        batch_key(jc.review_batch(batch))


def test_flagship_audit_equals_interpreter():
    td = TorchDriver(device="cpu")
    tc, _ = flagship_client(TBackend, TTarget, td, 300, 12)
    rc, _ = flagship_client(TBackend, TTarget, TRegoDriver(), 300, 12)
    assert key(tc.audit().results()) == key(rc.audit().results())


def test_library_audit_and_review_batch_equal_tpu_driver():
    jd, td = library_drivers()
    jd._dev_batch_lat_s = 1e-4
    objs = fixture_objects(240)
    clients = []
    for backend, target, drv in ((JBackend, JTarget, jd),
                                 (TBackend, TTarget, td)):
        client = backend(drv).new_client([target()])
        for o in objs:
            client.add_data(o)
        clients.append(client)
    jc, tc = clients
    want = key(jc.audit().results())
    assert want  # the corpus violates something
    assert key(tc.audit().results()) == want
    assert batch_key(tc.review_batch(objs)) == batch_key(jc.review_batch(objs))
    counts = td.eval_counts()
    compiled = set(td.compiled_kinds())
    assert len(compiled) == 21
    assert all(counts.get((k, "device"), 0) >= 1 for k in compiled
               if counts.get((k, "interp"), 0) == 0)
    reasons = td.fallback_reasons()
    assert {k: v["reason"] for k, v in reasons.items()} == {
        "K8sUniqueIngressHost": "join-not-ported",
        "K8sUniqueServiceSelector": "join-not-ported"}


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert TorchDriver().device.type == "cuda"
        return
    with pytest.raises(DriverError, match="no CUDA card"):
        TorchDriver()
