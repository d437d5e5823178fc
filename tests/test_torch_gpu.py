"""Card-only tests: each hand-written kernel against its plain version.

Marked `gpu`; they decide inside the `cuda` fixture whether a card is
there and skip without one. This file imports neither jax nor the JAX
package, so on the card (where jax is not installed) it runs without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

Tolerance: exact equality (verdict bits, pair indices, regex and join
booleans, K5's patched leaves byte for byte).

Drivers compile in the foreground here (`async_warm = False`, as the
suite's conftest sets GATEKEEPER_TPU_ASYNC_COMPILE=0, which this file
does not see): their launch counts and paths are then deterministic.
They come from card_driver(), which records their quarantines: no test
but the K1 quarantine test injects a fault, so that a quarantine
elsewhere means a kernel failed and the interpreter served its kind,
and the test fails (the `cuda` fixture checks). The
compile-lifecycle and warm-boot tests at the end set what they test.
"""

import copy
import json
import pathlib
import random
import threading
import time
import weakref
import zlib

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch import policies
from gatekeeper_tpu_torch.client import Backend, RegoDriver
from gatekeeper_tpu_torch.control.audit import AuditManager
from gatekeeper_tpu_torch.control.kube import FakeKube
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
    sm_count,
)
from gatekeeper_tpu_torch.kernels.rows_update import (
    MAX_LEAVES,
    rows_update,
    rows_update_plain,
)
from gatekeeper_tpu_torch.kernels.shard_counts import (
    shard_counts,
    shard_counts_plain,
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
    K3_BIG_PATTERNS,
    K5_DTYPES,
    K5_MS,
    K5_SHAPES,
    big_vocab,
    hard_vocab,
    k4_synthetic,
    k5_case,
    k5_random,
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


# the quarantines card_driver()'s drivers reported: (kind, reason)
_QUARANTINED: list = []
_DRIVERS = weakref.WeakSet()


def card_driver(device="cuda", async_warm=False, mesh=None):
    """A TorchDriver (foreground compiles unless asked) whose quarantines
    are recorded and fail the test."""
    drv = TorchDriver(device=device, mesh=mesh)
    drv.async_warm = async_warm
    drv.on_quarantine = lambda kind, reason: _QUARANTINED.append(
        (kind, reason))
    _DRIVERS.add(drv)
    return drv


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import time. After
    the test, no card_driver() may have quarantined a kind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    _QUARANTINED.clear()
    yield torch.device("cuda")
    for t in threading.enumerate():
        if t.name.startswith("quarantine-note-"):
            t.join(10)  # on_quarantine runs off the serving thread
    benched = {k: v["reason"] for drv in list(_DRIVERS)
               for k, v in drv.quarantine_status().items()}
    assert not _QUARANTINED and not benched, (_QUARANTINED, benched)


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
    drv = card_driver(device="cpu")
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


@pytest.mark.gpu
def test_card_launched_k2_variant_skips_the_compile_lock(cuda,
                                                        library_inputs):
    """A K2 launch of a variant its kernel has launched before runs while
    another thread holds the kernel's lock (as the warm thread does
    through a compile of another variant): it does not wait, and its
    words equal the plain version's."""
    ct, cpu_in = library_inputs[policies.kind_of(COMPILED[0])]
    dev_in = [_to(x, cuda) for x in cpu_in]
    cache: dict = {}
    clause_words(ct.plans, *dev_in, cache=cache)
    torch.cuda.synchronize()
    (ent,) = cache.values()
    out: dict = {}
    launches = clause_words.launches
    with ent.lock:  # another variant's compile
        t = threading.Thread(target=lambda: out.setdefault(
            "words", clause_words(ct.plans, *dev_in, cache=cache)))
        t.start()
        t.join(30)
        assert not t.is_alive(), "the launch waited for the kernel's lock"
    torch.cuda.synchronize()
    assert clause_words.launches == launches + 1
    assert torch.equal(out["words"],
                       clause_words_plain(ct.plans, *dev_in, chunk=64))


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
    gd = card_driver()
    cd = card_driver(device="cpu")
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


def _status_of(kube):
    out = {}
    for o in kube.list(("constraints.gatekeeper.sh", "v1beta1",
                        "K8sRequiredLabels")):
        st = dict(o.get("status") or {})
        st.pop("auditTimestamp", None)
        out[o["metadata"]["name"]] = st
    return out


@pytest.mark.gpu
def test_card_audit_manager_statuses_equal_interpreter(cuda):
    """The audit manager's discovery sweep (review_batch) and its
    from-cache and incremental sweeps on a card driver (the device path
    pinned) launch K2 and write the constraint statuses a RegoDriver
    manager writes over the same FakeKube objects (the violations cap at
    its default 20; 40 constraints over 300 Namespaces)."""
    objs = synth_objects(300, violate_frac=0.1, seed=0)
    cons = synth_constraints(40, seed=1)
    got = {}
    for name, drv in (("card", card_driver()), ("rego", RegoDriver())):
        if name == "card":
            drv._use_device_for_batch = lambda n: True
        client = Backend(drv).new_client([K8sValidationTarget()])
        client.add_template(REQUIRED_LABELS_TEMPLATE)
        kube = FakeKube()
        kube.register_kind(("", "v1", "Namespace"), namespaced=False)
        for con in cons:
            client.add_constraint(con)
            kube.apply(copy.deepcopy(con))
        for o in objs:
            kube.create(copy.deepcopy(o))
            client.add_data(copy.deepcopy(o))
        launches = clause_words.launches
        sweeps = []
        for kw in ({}, {"audit_from_cache": True}, {"incremental": True}):
            mgr = AuditManager(kube, client, gc_stale_statuses=False, **kw)
            res = mgr.audit_once()
            mgr.stop()
            sweeps.append([sorted(_key(res)), _status_of(kube)])
        got[name] = sweeps
        if name == "card":
            assert clause_words.launches > launches
    assert got["card"][0][1] and got["card"] == got["rego"]
    total = sum(st["totalViolations"] for st in got["card"][0][1].values())
    assert total == len(got["card"][0][0]) > 0


@pytest.mark.gpu
def test_card_sample_across_a_triton_compile_is_dropped(cuda):
    """A review batch whose K2 launch compiles leaves the device-latency
    EMA as it was: Triton's in-memory cache of the kind's kernels is
    emptied, so the launch compiles again (Triton's cache grows, and
    kernels/build.py counts it). The same batch once more compiles
    nothing and its sample enters the EMA."""
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    gd = card_driver()
    client, objs = _flagship(gd, 200, 8)
    batch = objs[:40]  # the dense branch
    gd._use_device_for_batch = lambda n: True
    client.review_batch(batch)
    assert gd.eval_counts()[("K8sRequiredLabels", "device")] == 1
    kernels = gd.compiled_for("K8sRequiredLabels")._kernels
    assert kernels
    for ent in kernels.values():
        for entry in ent.kernel.device_caches.values():
            entry[0].clear()
    gd._dev_batch_lat_s = 0.25
    compiles = kernel_build.compiles
    client.review_batch(batch)
    assert kernel_build.compiles > compiles
    assert gd._dev_batch_lat_s == 0.25
    compiles = kernel_build.compiles
    client.review_batch(batch)
    assert kernel_build.compiles == compiles
    assert gd._dev_batch_lat_s != 0.25
    assert gd.eval_counts()[("K8sRequiredLabels", "device")] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 300, 1001])
@pytest.mark.parametrize("pats", ["hard", "big"])
def test_k3_kernel_equals_plain(cuda, n, pats):
    """K3 on the packed strings and compressed tables equals its plain
    version: the hard set (groups staged in shared memory) and the big
    patterns (a group read from global memory, groups split by size)."""
    patterns = HARD_PATTERNS if pats == "hard" else \
        K3_BIG_PATTERNS + HARD_PATTERNS[:5]
    strings = hard_vocab(n, n) if pats == "hard" else big_vocab(n, n)
    dfas = [regex_nfa.compile_dfa(regex_nfa.compile_pattern(p))
            for p in patterns]
    buf, offsets, _special = regex_nfa.scan_prep(strings)
    *tabs, smem = regex_nfa.scan_tables(dfas, len(strings),
                                        sm_count(cuda))
    host = (buf, offsets, *tabs)
    args = tree_from_numpy(host, cuda)
    launches = regex_scan.launches
    got = regex_scan(*args, smem)
    ref = regex_scan_plain(*args, smem)
    torch.cuda.synchronize()
    assert regex_scan.launches == launches + 1
    assert torch.equal(got, ref)
    assert torch.equal(ref.cpu(), regex_scan_plain(
        *tree_from_numpy(host, "cpu"), smem))


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
    gd = card_driver()
    for drv in (gd, RegoDriver()):
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
    gd, cd = card_driver(), card_driver(device="cpu")
    for drv in (gd, cd):  # 600 pods: pin the device path (cost model off)
        drv._use_device_for_batch = lambda n: True
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


# (seed, len(u), G, N, hmax) at Kb 1, 2, 32, 64, 32,768 and 262,144 (past
# LINE x MAX_FENCES keys: segments of 64 halved to a line); N is never a
# multiple of the block
K4_FENCE_CASES = [(5, 1, 1, 1001, 1), (6, 2, 2, 777, 2), (7, 20, 2, 999, 3),
                  (8, 50, 1, 3001, 2), (9, 20_000, 2, 100_003, 1),
                  (10, 200_000, 1, 50_001, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", K4_FENCE_CASES)
def test_k4_fenced_kernel_equals_plain(cuda, case):
    from gatekeeper_tpu_torch.kernels.join_member import join_fences

    arrs = k4_synthetic(*case)
    args = tree_from_numpy(arrs, cuda)
    kb = arrs[0].shape[0]
    assert kb & (kb - 1) == 0 and case[3] % 256
    fences = join_fences(args[0])
    launches = join_member.launches
    got = join_member(*args, tjoin.KEY_PAD, fences)
    alike = join_member(*args, tjoin.KEY_PAD)  # fences built in the call
    ref = join_member_plain(*args, tjoin.KEY_PAD)
    torch.cuda.synchronize()
    assert join_member.launches == launches + 2
    assert torch.equal(got, ref) and torch.equal(alike, ref)
    assert ref.any() and not ref.all()


@pytest.mark.gpu
@pytest.mark.parametrize("line", [4, 8, 16, 32])
def test_k4_every_line_length_equals_plain(cuda, monkeypatch, line):
    """Each kernel the launcher can pick (the line a search ends in),
    at Kb 4,096 and 262,144 (segments halved down to 32 keys)."""
    from gatekeeper_tpu_torch.kernels import join_member as k4

    monkeypatch.setattr(k4, "LINE", line)
    for case in ((11, 3000, 2, 20_001, 2), (12, 200_000, 1, 30_001, 1)):
        args = tree_from_numpy(k4_synthetic(*case), cuda)
        got = join_member(*args, tjoin.KEY_PAD, k4.join_fences(args[0]))
        ref = join_member_plain(*args, tjoin.KEY_PAD)
        torch.cuda.synchronize()
        assert torch.equal(got, ref) and ref.any()


def _mixed_leaves(rng, n_leaves: int, rows: int) -> list:
    """Host leaves of mixed dtypes and row sizes (1..64 bytes, odd ones,
    empty rows), as the kinds' feature leaves come."""
    kinds = [("int8", (1,)), ("int32", (1, 1)), ("float32", (2,)),
             ("int8", (3,)), ("int32", (0,)), ("int32", (4,)),
             ("int8", (2,)), ("float32", (5,)), ("int32", (16,)),
             ("uint32", (2,))]
    return [k5_random(rng, (rows,) + s, d) for d, s in
            (kinds[int(x)] for x in rng.integers(0, len(kinds), n_leaves))]


@pytest.mark.gpu
@pytest.mark.parametrize("n_leaves", [300, MAX_LEAVES])
def test_k5_many_leaves_equal_plain(cuda, n_leaves):
    """One launch into a few hundred leaves of mixed widths, and into
    MAX_LEAVES leaves, one of them only 4-byte aligned on the card; a
    position repeats with identical rows."""
    rng = np.random.default_rng(n_leaves)
    host = _mixed_leaves(rng, n_leaves - 1, 301)
    got = [tree_from_numpy(a, cuda) for a in host]
    whole = tree_from_numpy(k5_random(rng, (301 * 4 + 1,), "int32"), cuda)
    got.append(whole[1:].view(301, 4))  # base 4 bytes past a 16-byte one
    host.append(got[-1].cpu().numpy())
    ref = [t.clone() for t in got]
    others = rng.permutation(np.delete(np.arange(301), 7))[:39]
    pos = np.concatenate([[7], others, [7]]).astype(np.int32)
    rows = []
    for a in host:
        r = k5_random(rng, (41,) + a.shape[1:], str(a.dtype))
        r[-1] = r[0]
        rows.append(r)
    launches = rows_update.launches
    rows_update(got, pos, rows)
    rows_update_plain(ref, torch.from_numpy(pos).to(cuda),
                      [tree_from_numpy(r, cuda).view(t.dtype)
                       for r, t in zip(rows, ref)])
    torch.cuda.synchronize()
    assert rows_update.launches == launches + 1
    for g, r in zip(got, ref):
        assert _bytes(g) == _bytes(r)
    assert any(_bytes(g) != a.tobytes() for g, a in zip(got, host))
    if n_leaves == MAX_LEAVES:
        with pytest.raises(ValueError, match="MAX_LEAVES"):
            rows_update(got + got[:1], pos, rows + rows[:1])


@pytest.mark.gpu
def test_k4_and_k5_repeats_identical(cuda):
    """20 launches of each on the same inputs: byte-identical outputs."""
    from gatekeeper_tpu_torch.kernels.join_member import join_fences

    args = tree_from_numpy(k4_synthetic(9, 20_000, 2, 100_003, 1), cuda)
    fences = join_fences(args[0])
    k4 = {_bytes(join_member(*args, tjoin.KEY_PAD, fences))
          for _ in range(20)}
    assert len(k4) == 1
    rng = np.random.default_rng(20)
    host = _mixed_leaves(rng, 84, 1000)
    pos = rng.permutation(1000)[:500].astype(np.int32)
    rows = [k5_random(rng, (500,) + a.shape[1:], str(a.dtype))
            for a in host]
    k5 = set()
    for _ in range(20):
        leaves = [tree_from_numpy(a, cuda) for a in host]
        rows_update(leaves, pos, rows)
        k5.add(b"".join(_bytes(t) for t in leaves))
    assert len(k5) == 1


def _fresh_k2_modules() -> None:
    """Forget the generated K2 modules this process imported, so that the
    next K2 launch loads a fresh JIT function with an empty in-memory
    cache: its first launch then compiles (or loads Triton's disk
    cache), which kernels/build.py counts."""
    import sys

    for name in [m for m in sys.modules if "._build_k2_" in m]:
        del sys.modules[name]


@pytest.mark.gpu
def test_card_background_warm_compiles_k2_off_the_serving_thread(cuda):
    """Async warm on the card: the first audit at a cold sweep shape
    serves from the host while a background thread compiles K2; after
    the warm drains, the same audit dispatches on the card with no
    compile on the serving thread (nor anywhere), and its latency sample
    enters the EMA. Both audits equal the CPU driver's."""
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    gd, cd = card_driver(async_warm=True), card_driver(device="cpu")
    gc, _objs = _flagship(gd, 2000, 40)
    cc, _ = _flagship(cd, 2000, 40)
    want = _key(cc.audit().results())
    gd._dev_batch_lat_s = 1e-4  # the cost model picks the device
    _fresh_k2_modules()
    total, mine = kernel_build.compiles, kernel_build.thread_compiles()
    assert _key(gc.audit().results()) == want
    assert gd.eval_counts() == {("K8sRequiredLabels", "interp"): 1}
    for _ in range(6000):
        if not gd.warm_status()["compiling"]:
            break
        time.sleep(0.05)
    st = gd.warm_status()
    assert (st["warm"], st["compiling"]) == (1, 0)
    assert kernel_build.compiles > total  # the warm thread compiled K2
    assert kernel_build.thread_compiles() == mine
    gd._audit_results_cache.clear()
    total = kernel_build.compiles
    launches = clause_words.launches, pair_compact.launches
    assert _key(gc.audit().results()) == want
    assert kernel_build.compiles == total
    assert kernel_build.thread_compiles() == mine
    assert clause_words.launches > launches[0]
    assert pair_compact.launches > launches[1]
    assert gd.eval_counts()[("K8sRequiredLabels", "device")] == 1
    assert gd.last_audit_lat_s[0] is not None
    assert gd._dev_batch_lat_s != 1e-4


@pytest.mark.gpu
def test_card_k1_failure_at_consume_quarantines(cuda, monkeypatch):
    """A K1 failure that surfaces at the sync (the pair block's fetch in
    handle.pairs(), where an asynchronous CUDA error shows) quarantines
    the kind; the interpreter's results follow, and once the fault is
    gone the half-open probe restores the card."""
    from gatekeeper_tpu_torch.ir import evaltorch

    gd, cd = TorchDriver(), TorchDriver(device="cpu")
    gd.async_warm = cd.async_warm = False
    gd.quarantine_base_s = 0.2
    gd._use_device_for_batch = lambda n: True
    gc, _objs = _flagship(gd, 2000, 40)
    cc, _ = _flagship(cd, 2000, 40)
    want = _key(cc.audit().results())
    armed = [True]
    fetch = evaltorch._fetch

    def failing(block):
        if armed[0]:
            torch.cuda.synchronize()
            raise RuntimeError("CUDA error: unspecified launch failure "
                               "(injected at the K1 block's sync)")
        return fetch(block)

    monkeypatch.setattr(evaltorch, "_fetch", failing)
    launches = pair_compact.launches
    assert _key(gc.audit().results()) == want
    assert pair_compact.launches > launches  # K1 ran; its sync failed
    q = gd.quarantine_status()
    assert list(q) == ["K8sRequiredLabels"] and q["K8sRequiredLabels"][
        "fails"] == 1 and q["K8sRequiredLabels"]["reason"].startswith(
        "audit-eval: RuntimeError")
    assert gd.eval_counts() == {("K8sRequiredLabels", "device"): 1,
                                ("K8sRequiredLabels", "interp"): 1}
    armed[0] = False
    time.sleep(0.25)
    assert _key(gc.audit().results()) == want
    assert gd.quarantine_status() == {}
    assert gd.eval_counts()[("K8sRequiredLabels", "device")] == 2


LABEL_KEYS = ["owner", "team", "env", "cost", "tier",
              "zone", "org", "app", "rel", "stage"]


# K6: (rows, W, density, r_begin, r_end, c, C): an audit shard's shape,
# a ragged c with a row range inside, C < c, and W past one block's 32
# words
K6_CASES = [
    (32768, 16, 0.01, 0, 32768, 500, 500),
    (1000, 2, 0.1, 7, 993, 45, 64),
    (257, 3, 0.5, 3, 250, 96, 80),
    (3001, 40, 0.02, 0, 2999, 1270, 1280),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", K6_CASES)
def test_k6_kernel_equals_plain(cuda, case):
    rows, w, dens, rb, re_, c, C = case
    words = torch.from_numpy(
        random_words(rows + w, rows, w, dens).view(np.int32)).to(cuda)
    for acc in (False, True):
        init = torch.arange(C, dtype=torch.int32, device=cuda) * 3 - 5
        before = shard_counts.launches
        got = shard_counts(words, rb, re_, c, init.clone(), acc)
        want = shard_counts_plain(words, rb, re_, c, init.clone(), acc)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (case, acc)
        assert shard_counts.launches == before + 1
    assert int(want.sum()) != int(init.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("slab", [None, 256])
def test_card_mesh_audit_equals_single_device(cuda, slab):
    """The driver's audit over 4 virtual shards of the card equals the
    single-device driver's in order, on one dispatch a shard and on the
    slab loop, and after replacements patched into the shards (K5) the
    re-swept results still do, each shard's resident rows equal to the
    host's."""
    from gatekeeper_tpu_torch.ir import evaltorch
    from gatekeeper_tpu_torch.ir.carry import to_tensor
    from gatekeeper_tpu_torch.parallel.mesh import make_mesh

    gm = card_driver(mesh=make_mesh([torch.device("cuda", 0)] * 4))
    gs = card_driver()
    gm.MESH_MIN_REVIEWS = 64
    gm.sweep_chunk = gs.sweep_chunk = 256
    gm.mesh_slab_local = slab  # n_loc 512: 2 slabs of 256
    cm, objs = _flagship(gm, 2000, 40)
    cs, _ = _flagship(gs, 2000, 40)
    before = clause_words.launches, pair_compact.launches
    handles = []
    orig = gm._dispatch_handle
    gm._dispatch_handle = lambda *a, **k: handles.append(orig(*a, **k)) \
        or handles[-1]
    got = _key(cm.audit().results())
    gm._dispatch_handle = orig
    assert gm.last_audit_path == "mesh(data=4)"
    assert [isinstance(h, evaltorch._MeshSlabPairs) for h in handles] == \
        [slab is not None]
    assert got == _key(cs.audit().results()) and len(got) > 512
    assert clause_words.launches >= before[0] + 4
    assert pair_compact.launches >= before[1] + 4
    k5 = rows_update.launches
    for client in (cm, cs):
        for o in objs[1:2000:7]:
            o = copy.deepcopy(o)
            o["metadata"]["labels"] = {}
            client.add_data(o)
        client.driver._audit_results_cache.clear()
    got = _key(cm.audit().results())
    assert gm.last_audit_path == "mesh(data=4)"
    assert got == _key(cs.audit().results())
    assert rows_update.launches - k5 == 1 + 4  # single, then a shard each
    feats = gm._feat_cache["K8sRequiredLabels"]["__meta__"]["feats"]
    for arrs in feats.values():
        for a in arrs.values():
            sh = gm._dev_mesh_cache[(id(a), True)][1]
            n_loc = a.shape[0] // 4
            for d in range(4):
                assert torch.equal(
                    sh.block(d).view(torch.uint8),
                    to_tensor(a[d * n_loc:(d + 1) * n_loc],
                              cuda).view(torch.uint8))


def _labels_client(drv, n: int, n_cons: int):
    """tests/test_coldstart.py's _labels_client: requiredlabels, n_cons
    constraints, n Namespaces with two of every three labels."""
    client = Backend(drv).new_client([K8sValidationTarget()])
    client.add_template(policies.load("general/requiredlabels"))
    for k in range(n_cons):
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sRequiredLabels",
            "metadata": {"name": f"need-{LABEL_KEYS[k]}"},
            "spec": {"parameters": {"labels": [{"key": LABEL_KEYS[k]}]}}})
    for i in range(n):
        labels = {LABEL_KEYS[j]: "x" for j in range(len(LABEL_KEYS))
                  if (i + j) % 3}
        client.add_data({"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": f"ns{i:05d}",
                                      "labels": labels}})
    return client


def warm_boot_child(aot_dir: str) -> dict:
    """The second process of test_card_warm_boot_loads_stored_k2: boots
    on the program store with async warm on (the package default), waits
    for the prewarm to adopt the stored sweep signatures, then audits."""
    from gatekeeper_tpu_torch.ir import aot
    from gatekeeper_tpu_torch.kernels import build as kernel_build

    drv = TorchDriver(aot_dir=aot_dir)
    drv._dev_batch_lat_s = 1e-4  # the cost model picks the device
    client = _labels_client(drv, 2048, 5)
    fp = drv.compiled_for("K8sRequiredLabels").fingerprint
    n_sigs = len(drv.aot.sigs_for(fp))
    deadline = time.monotonic() + 120
    while drv.warm_status()["warm"] < n_sigs and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    warm = drv.warm_status()["warm"]
    mine = kernel_build.thread_compiles()
    results = _key(client.audit().results())
    return {"enabled": drv.aot.enabled, "async": drv.async_warm,
            "sigs": n_sigs, "warm": warm, "results": results,
            "evals": sorted([k, p, n] for (k, p), n
                            in drv.eval_counts().items()),
            "counts": dict(aot.COMPILE_COUNTS),
            "serving_compiles": kernel_build.thread_compiles() - mine,
            "quarantined": sorted(drv.quarantine_status())}


@pytest.mark.gpu
def test_card_warm_boot_loads_stored_k2(cuda, tmp_path, monkeypatch):
    """The program store across processes, at tests/test_coldstart.py's
    size (2,048 objects x 5 constraints): this process's first audit
    compiles K2 fresh (a Triton cache of its own) and stores the variant
    and its sweep signature; a child process with an empty Triton cache
    and async warm on adopts the signature before any sweep, and its first
    audit runs on the card with the stored variant: no fresh or cache
    compile, no compile on its serving thread, equal results."""
    import os
    import subprocess
    import sys

    from gatekeeper_tpu_torch.ir import aot

    monkeypatch.setenv("TRITON_CACHE_DIR", str(tmp_path / "triton-1"))
    _fresh_k2_modules()
    aot_dir = str(tmp_path / "aot")
    gd = card_driver()
    gd.aot.set_dir(aot_dir)
    gd._dev_batch_lat_s = 1e-4
    before = dict(aot.COMPILE_COUNTS)
    want = _key(_labels_client(gd, 2048, 5).audit().results())
    assert gd.eval_counts() == {("K8sRequiredLabels", "device"): 1}
    assert aot.COMPILE_COUNTS["fresh"] > before["fresh"]
    assert gd.aot.programs_count() >= 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root,
               TRITON_CACHE_DIR=str(tmp_path / "triton-2"),
               GATEKEEPER_TPU_ASYNC_COMPILE="1")
    code = ("import json, sys; from tests.test_torch_gpu import "
            "warm_boot_child; print(json.dumps(warm_boot_child(sys.argv[1])))")
    proc = subprocess.run([sys.executable, "-c", code, aot_dir], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["enabled"] and got["async"] and got["sigs"] >= 1
    assert got["warm"] >= got["sigs"], "adopted before the first sweep"
    assert got["results"] == [list(r) for r in want]
    assert got["evals"] == [["K8sRequiredLabels", "device", 1]]
    c = got["counts"]
    assert c["fresh"] == 0 and c["cache"] == 0 and c["error"] == 0 \
        and c["aot"] >= 1, c
    assert got["serving_compiles"] == 0
    assert got["quarantined"] == []


@pytest.mark.gpu
def test_card_profiler_renders_ptx_and_traces_k2(cuda, tmp_path):
    """utils/profiling.py on the card: compiled_hlo's "optimized" stage
    returns the PTX Triton compiled for the template's sweep inputs (its
    "hlo" stage the generated source it came from), and a device_trace
    around an audit on the card writes a Chrome trace naming K2's kernel
    (clause_kernel), as the profiler's device-time sums do."""
    import os

    from gatekeeper_tpu_torch.utils import profiling

    gd = card_driver()
    gd._use_device_for_batch = lambda n: True
    client = _labels_client(gd, 2048, 5)
    with profiling.device_trace(str(tmp_path)) as prof:
        res = client.audit().results()
        torch.cuda.synchronize()
    assert gd.eval_counts() == {("K8sRequiredLabels", "device"): 1}
    (trace,) = [f for f in os.listdir(tmp_path)
                if f.endswith(".pt.trace.json")]
    with open(tmp_path / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" and "clause_kernel" in e["name"]
               for e in events)
    assert any("clause_kernel" in a.key for a in prof.key_averages())
    kind = "K8sRequiredLabels"
    ct = gd.compiled_for(kind)
    cons = gd._constraints(TARGET)
    feats, enc, table, derived = gd._prepare_eval(
        ct, kind, gd._inventory_reviews(TARGET), cons, None)
    src = profiling.compiled_hlo(ct, feats, enc, table, derived)
    ptx = profiling.compiled_hlo(ct, feats, enc, table, derived,
                                 stage="optimized")
    assert "def clause_kernel(" in src
    assert ".entry clause_kernel" in ptx and ".target sm_90" in ptx
    assert len(res) > 0
