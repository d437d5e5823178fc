"""Card-only tests: each hand-written kernel against its plain version.

Marked `gpu`; they decide inside the `cuda` fixture whether a card is
there and skip without one. This file imports neither jax nor the JAX
package, so on the card (where jax is not installed) it runs without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerance: exact equality (verdict bits and pair indices).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch import policies
from gatekeeper_tpu_torch.client import Backend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.kernels.clause import (
    clause_words,
    clause_words_plain,
    param_c,
)
from gatekeeper_tpu_torch.kernels.pair_compact import (
    pair_compact,
    pair_compact_plain,
)
from gatekeeper_tpu_torch.parallel.workload import (
    GENERAL_CONSTRAINTS,
    PSP_CONSTRAINTS,
    REQUIRED_LABELS_TEMPLATE,
    synth_constraints,
    synth_objects,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget

TARGET = "admission.k8s.gatekeeper.sh"
FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "fleet_scan"
JOIN_TEMPLATES = ("general/uniqueingresshost", "general/uniqueserviceselector")
COMPILED = [n for n in policies.names() if n not in JOIN_TEMPLATES]

# (rows, density, r_begin, r_end, row0, c, pcap)
K1_CASES = [
    (64, 0.1, 0, 64, 0, 32, 4096),
    (64, 0.1, 5, 60, 1000, 20, 4096),
    (300, 0.05, 17, 290, 4096, 19, 64),     # count > pcap
    (128, 0.0, 0, 128, 0, 32, 256),
    (200, 0.5, 0, 150, 77, 31, 8),          # count >> pcap
]


def random_words(seed: int, r: int, w: int, density: float) -> np.ndarray:
    """uint32 verdict words [r, w] with each bit set at `density`."""
    rng = np.random.default_rng(seed)
    bits = rng.random((r, w * 32)) < density
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    return (bits.reshape(r, w, 32).astype(np.uint64) * weights).sum(
        -1).astype(np.uint32)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 16])
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_kernel_equals_plain(cuda, w, case):
    r, dens, rb, re_, row0, c, pcap = case
    c = c if w == 1 else c * 16 - 3
    words = torch.from_numpy(
        random_words(r * w + 1, r, w, dens).view(np.int32)).to(cuda)
    launches = pair_compact.launches
    got = pair_compact(words, rb, re_, row0, c, pcap)
    ref = pair_compact_plain(words, rb, re_, row0, c, pcap)
    torch.cuda.synchronize()
    assert pair_compact.launches == launches + 1
    assert torch.equal(got, ref)


@pytest.fixture(scope="module")
def library_inputs():
    """Per compiled kind: (CompiledTemplate, CPU inputs) over 160 objects
    of the fleet-scan corpus, from the port's own driver."""
    drv = TorchDriver(device="cpu")
    client = Backend(drv).new_client([K8sValidationTarget()])
    for name in COMPILED:
        client.add_template(policies.load(name))
    for kind, cname, params in GENERAL_CONSTRAINTS + PSP_CONSTRAINTS:
        if kind in ("K8sUniqueIngressHost", "K8sUniqueServiceSelector"):
            continue
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {})})
    objs = []
    with open(FIXTURE / "inventory.jsonl") as f:
        for line in f:
            objs.append(json.loads(line))
            if len(objs) == 160:
                break
    target = K8sValidationTarget()
    reviews = [target.handle_review(o)[1] for o in objs]
    cons = drv._constraints(TARGET)
    out = {}
    for kind in drv.compiled_kinds():
        ct = drv.compiled_for(kind)
        kc = [c for c in cons if c["kind"] == kind]
        out[kind] = (ct, drv._prepare_eval(ct, kind, reviews, kc, None))
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", COMPILED)
def test_k2_kernel_equals_plain(cuda, library_inputs, name):
    ct, cpu_in = library_inputs[policies.kind_of(name)]
    dev_in = [_to(x, cuda) for x in cpu_in]
    launches = clause_words.launches
    got = clause_words(ct.plans, *dev_in, cache={})
    ref = clause_words_plain(ct.plans, *dev_in, chunk=64)
    torch.cuda.synchronize()
    assert clause_words.launches == launches + 1
    assert got.shape == (ref.shape[0],
                         max(1, (param_c(dev_in[1]) + 31) // 32))
    assert torch.equal(got, ref)
    # and the card's plain version equals the CPU's
    assert torch.equal(ref.cpu(), clause_words_plain(ct.plans, *cpu_in))


def _flagship(drv, n, c):
    client = Backend(drv).new_client([K8sValidationTarget()])
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    for con in synth_constraints(c, seed=1):
        client.add_constraint(con)
    objs = synth_objects(n, violate_frac=0.1, seed=0)
    for o in objs:
        client.add_data(o)
    return client, objs


def _key(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


@pytest.mark.gpu
def test_card_audit_and_review_batch_equal_cpu(cuda):
    gd = TorchDriver()
    cd = TorchDriver(device="cpu")
    gd.sweep_chunk = cd.sweep_chunk = 256  # two slabs + capacity retry
    gc, objs = _flagship(gd, 2000, 40)
    cc, _ = _flagship(cd, 2000, 40)
    before = clause_words.launches, pair_compact.launches
    want = _key(cc.audit().results())
    assert len(want) > 512
    assert _key(gc.audit().results()) == want
    assert clause_words.launches > before[0]
    assert pair_compact.launches > before[1]
    assert [_key(r.results()) for r in gc.review_batch(objs[:64])] == \
        [_key(r.results()) for r in cc.review_batch(objs[:64])]
