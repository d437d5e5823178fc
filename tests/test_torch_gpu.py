"""Card-only tests: each hand-written kernel against its plain version.

Marked `gpu`; they decide inside the `cuda` fixture whether a card is
there and skip without one. This file imports neither jax nor the JAX
package, so on the card (where jax is not installed) it runs without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerance: exact equality (verdict bits, pair indices, regex and join
booleans, K5's patched leaves byte for byte).
"""

import copy
import json
import pathlib
import random
import zlib

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
from gatekeeper_tpu_torch.ir import join as tjoin
from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
from gatekeeper_tpu_torch.kernels.join_member import (
    join_member,
    join_member_plain,
)
from gatekeeper_tpu_torch.kernels.pair_compact import (
    pair_compact,
    pair_compact_plain,
)
from gatekeeper_tpu_torch.kernels.regex_scan import (
    regex_scan,
    regex_scan_plain,
)
from gatekeeper_tpu_torch.kernels.rows_update import (
    rows_update,
    rows_update_plain,
)
from gatekeeper_tpu_torch.ops import regex_nfa
from gatekeeper_tpu_torch.ops.strtab import MatchTables, StringTable
from gatekeeper_tpu_torch.parallel.workload import (
    GENERAL_CONSTRAINTS,
    PSP_CONSTRAINTS,
    REQUIRED_LABELS_TEMPLATE,
    churn_pods,
    synth_constraints,
    synth_objects,
    synth_pods_psp,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget

from .torch_kernel_cases import (
    HARD_PATTERNS,
    K1_TILE_CASES,
    K5_DTYPES,
    K5_MS,
    K5_SHAPES,
    hard_vocab,
    k4_synthetic,
    k5_case,
)

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


@pytest.mark.gpu
@pytest.mark.parametrize("case", K1_TILE_CASES)
def test_k1_tiles_equal_plain(cuda, case):
    """K1 across several tiles (and two passes a thread) against the
    plain version: row ranges, slab offsets, c not a multiple of 32,
    counts of 0 and above pcap."""
    r, w, dens, rb, re_, row0, c, pcap = case
    words = torch.from_numpy(
        random_words(r + w, r, w, dens).view(np.int32)).to(cuda)
    got = pair_compact(words, rb, re_, row0, c, pcap)
    ref = pair_compact_plain(words, rb, re_, row0, c, pcap)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert (int(ref[0, 0]) == 0) == (dens == 0.0)


@pytest.mark.gpu
def test_k1_repeats_identical(cuda):
    """20 launches on the same words give the same block, byte for byte:
    the offsets are prefix sums, not an order of arrival."""
    r, w, dens, rb, re_, row0, c, pcap = K1_TILE_CASES[1]
    words = torch.from_numpy(
        random_words(7, 20_000, w, 0.01).view(np.int32)).to(cuda)
    blocks = [pair_compact(words, rb, 20_000, row0, c, 1 << 15)
              for _ in range(20)]
    torch.cuda.synchronize()
    assert int(blocks[0][0, 0]) > 1000
    assert all(torch.equal(b, blocks[0]) for b in blocks[1:])
    assert torch.equal(blocks[0], pair_compact_plain(
        words, rb, 20_000, row0, c, 1 << 15))


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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 300, 1001])
def test_k3_kernel_equals_plain(cuda, n):
    dfas = [regex_nfa.compile_dfa(regex_nfa.compile_pattern(p))
            for p in HARD_PATTERNS]
    bmat = regex_nfa.trim_bytes(regex_nfa.bytes_matrix(hard_vocab(n, n)))
    args = tree_from_numpy(regex_nfa.stack_dfas(dfas) + (bmat,), cuda)
    launches = regex_scan.launches
    got = regex_scan(*args)
    ref = regex_scan_plain(*args)
    torch.cuda.synchronize()
    assert regex_scan.launches == launches + 1
    assert torch.equal(got, ref)
    assert torch.equal(ref.cpu(), regex_scan_plain(*tree_from_numpy(
        regex_nfa.stack_dfas(dfas) + (bmat,), "cpu")))


@pytest.mark.gpu
def test_match_tables_rows_on_card_equal_cpu(cuda, monkeypatch):
    monkeypatch.setattr(regex_nfa, "DEVICE_CROSSOVER", 1)
    rows = []
    for device in ("cuda", "cpu"):
        st = StringTable()
        mt = MatchTables(st, device)
        for s in hard_vocab(5, 500) + ["a\nb", "x\x00y"]:
            st.intern(s or "x")
        for p in HARD_PATTERNS:
            mt.row("re_match", p)
        mt.row("glob", "ab*")
        launches = regex_scan.launches
        rows.append(mt.materialize())
        assert regex_scan.launches == launches + (device == "cuda")
    assert np.array_equal(rows[0], rows[1])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(0, 13, 1, 37, 1), (1, 8, 2, 301, 3),
                                  (2, 16667, 1, 16667, 1),
                                  (3, 1000, 2, 2049, 2)])
def test_k4_kernel_equals_plain(cuda, case):
    args = tree_from_numpy(k4_synthetic(*case), cuda)
    launches = join_member.launches
    got = join_member(*args, tjoin.KEY_PAD)
    ref = join_member_plain(*args, tjoin.KEY_PAD)
    torch.cuda.synchronize()
    assert join_member.launches == launches + 1
    assert torch.equal(got, ref)
    assert ref.any()


@pytest.mark.gpu
def test_card_join_audit_equals_interpreter(cuda, monkeypatch):
    """The join kinds through K4 on the card equal the interpreter."""
    from gatekeeper_tpu_torch.client import RegoDriver

    monkeypatch.setattr(tjoin.JoinCompiled, "MIN_DEVICE_REVIEWS", 1)
    objs = []
    with open(FIXTURE / "inventory.jsonl") as f:
        for line in f:
            objs.append(json.loads(line))
    objs += [{**o, "metadata": {**o["metadata"], "name": f"dup-{i}",
                                "namespace": "dup"}}
             for i, o in enumerate(objs[::7])
             if o["kind"] in ("Ingress", "Service")]
    keys = []
    for drv in (TorchDriver(), RegoDriver()):
        client = Backend(drv).new_client([K8sValidationTarget()])
        for name in JOIN_TEMPLATES:
            client.add_template(policies.load(name))
        for kind, cname in (("K8sUniqueIngressHost", "hosts"),
                            ("K8sUniqueServiceSelector", "selectors")):
            client.add_constraint({
                "apiVersion": "constraints.gatekeeper.sh/v1beta1",
                "kind": kind, "metadata": {"name": cname}, "spec": {}})
        for o in objs:
            client.add_data(o)
        launches = join_member.launches
        keys.append(_key(client.audit().results()))
        if isinstance(drv, TorchDriver):
            assert join_member.launches >= launches + 2
    # the device driver groups results by kind (as the JAX package's
    # TpuDriver does), the interpreter by object: equal per constraint
    assert sorted(keys[0]) == sorted(keys[1]) and keys[0]
    for cname in ("hosts", "selectors"):
        assert [k for k in keys[0] if k[1] == cname] == \
            [k for k in keys[1] if k[1] == cname]


def _bytes(t: torch.Tensor) -> bytes:
    return t.cpu().numpy().tobytes()


@pytest.mark.gpu
@pytest.mark.parametrize("m", K5_MS)
@pytest.mark.parametrize("shape", K5_SHAPES)
@pytest.mark.parametrize("dtype", K5_DTYPES)
def test_k5_kernel_equals_plain(cuda, dtype, shape, m):
    dst, pos, new = k5_case(dtype, shape, m,
                            zlib.crc32(repr((dtype, shape, m)).encode()))
    got = tree_from_numpy(dst, cuda)
    ref = tree_from_numpy(dst, cuda)
    launches = rows_update.launches
    rows_update([got], pos, [new])
    rows_update_plain([ref], torch.from_numpy(pos).to(cuda),
                      [tree_from_numpy(new, cuda)])
    torch.cuda.synchronize()
    assert rows_update.launches == launches + 1
    assert _bytes(got) == _bytes(ref)
    cpu = tree_from_numpy(dst, "cpu")
    rows_update([cpu], pos, [new])
    assert _bytes(got) == _bytes(cpu)


def _psp_client(drv, pods):
    client = Backend(drv).new_client([K8sValidationTarget()])
    for name in policies.names():
        if name.startswith("pod-security-policy/"):
            client.add_template(policies.load(name))
    for kind, cname, params in PSP_CONSTRAINTS:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {})})
    for o in pods:
        client.add_data(copy.deepcopy(o))
    return client


@pytest.mark.gpu
def test_card_churn_edit_patches_resident_leaves(cuda):
    """A churn round plus a constraint edit: the card's sweep patches the
    resident feature leaves with one K5 launch per kind; afterwards every
    resident leaf equals a fresh upload of its host array, and every
    audit equals the CPU driver's."""
    pods = synth_pods_psp(600)
    gd, cd = TorchDriver(), TorchDriver(device="cpu")
    clients = [_psp_client(gd, pods), _psp_client(cd, pods)]

    def audit():
        keys = [_key(c.audit().results()) for c in clients]
        assert keys[0] == keys[1]
        return gd.last_audit_path

    assert audit() == "single(cuda)"
    assert audit() == "delta(16/16)"
    rng = random.Random(6)
    churned = churn_pods(pods, rng, 0, 6)
    churned[0]["spec"]["containers"][0]["securityContext"]["privileged"] = \
        True
    for c in clients:
        for pod in churned:
            c.add_data(copy.deepcopy(pod))
        c.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sPSPHostNetworkingPorts",
            "metadata": {"name": "host-ports"},
            "spec": {"parameters": {"hostNetwork": False, "min": 8000,
                                    "max": 8100}}})
    launches = rows_update.launches
    assert audit() == "single(cuda)"
    kinds = sorted(gd._feat_cache)
    assert len(kinds) == 16
    assert rows_update.launches == launches + len(kinds)
    for kind in kinds:
        feats = gd._feat_cache[kind]["__meta__"]["feats"]
        for arrs in feats.values():
            for a in arrs.values():
                ent = gd._dev_cache[id(a)]
                assert ent[0]() is a
                assert _bytes(ent[1]) == _bytes(tree_from_numpy(a, cuda))
