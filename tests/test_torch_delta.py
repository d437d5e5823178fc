"""The port's churn audit against the JAX package, on the CPU.

TorchDriver(device="cpu") against the JAX package's TpuDriver (CPU, its
device path forced as its own warm-restart tests force it) and its
RegoDriver, over requiredlabels (600 Namespaces, 12 constraints, the
mutations of tests/test_incremental.py) and a small pod-security-policy
setup (BENCH config 6's templates and constraints over synth_pods_psp):
the delta audit, feature patching from the patch journal, its rebuild
cases and invalidations, and the warm-restart rows. Results must be
equal in order (per constraint against RegoDriver, which groups by
object where the device drivers group by kind); patched feature arrays
must be bit-equal to the JAX driver's and to a fresh extraction.
"""

import copy

import pytest

from gatekeeper_tpu import policies as jpolicies
from gatekeeper_tpu.client import Backend as JBackend
from gatekeeper_tpu.client import RegoDriver as JRegoDriver
from gatekeeper_tpu.ir import TpuDriver
from gatekeeper_tpu.target import K8sValidationTarget as JTarget
from gatekeeper_tpu_torch import policies
from gatekeeper_tpu_torch.client import Backend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.ir import driver as tdriver
from gatekeeper_tpu_torch.ir.features import Extractor
from gatekeeper_tpu_torch.parallel.workload import (
    GENERAL_CONSTRAINTS,
    PSP_CONSTRAINTS,
    REQUIRED_LABELS_TEMPLATE,
    synth_constraints,
    synth_mixed_objects,
    synth_objects,
    synth_pods_psp,
)
from gatekeeper_tpu_torch.target import K8sValidationTarget

TARGET = "admission.k8s.gatekeeper.sh"
N_REQ, C_REQ = 600, 12
N_PSP = 160


def _ns(i: int, labels: dict) -> dict:
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": f"ns-{i}", "labels": labels}}


# tests/test_incremental.py's MUTATIONS
REQ_MUTATIONS = [
    _ns(7, {}),
    _ns(123, {"owner": "alpha.corp.example", "team": "payments",
              "env": "prod", "tier": "frontend", "region": "us-east1",
              "app": "shop", "cost-center": "cc-100", "compliance": "pci",
              "zone": "a", "dept": "eng"}),
    _ns(300, {"owner": "###BAD###", "team": "x"}),
]


def _psp_mutation(pods: list, i: int, round_: int) -> dict:
    """config 6's churn: a deep copy with a churned label, and every
    tenth one made privileged so that the results move too."""
    pod = copy.deepcopy(pods[i])
    pod["metadata"].setdefault("labels", {})["churn"] = f"r{round_}-{i}"
    if i % 10 == 0:
        pod["spec"]["containers"][0]["securityContext"]["privileged"] = True
    return pod


def _constraint(kind, name, params):
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": name},
            "spec": ({"parameters": params} if params else {})}


class Setup:
    """One workload loaded into the port's driver, the JAX package's
    TpuDriver and its RegoDriver, each with its own copy of the data."""

    def __init__(self, name: str):
        self.name = name
        self.td = TorchDriver(device="cpu")
        self.td._use_device_for_batch = lambda n: True  # as the JAX side
        self.jd = TpuDriver()
        self.jd.async_warm = False
        self.jd._use_device_for_batch = lambda n: True  # force the device
        self.clients = [
            Backend(self.td).new_client([K8sValidationTarget()]),
            JBackend(self.jd).new_client([JTarget()]),
            JBackend(JRegoDriver()).new_client([JTarget()]),
        ]
        if name == "requiredlabels":
            self.kind = "K8sRequiredLabels"
            self.templates = [(REQUIRED_LABELS_TEMPLATE,) * 3]
            self.constraints = synth_constraints(C_REQ, seed=1)
            self.objects = synth_objects(N_REQ, violate_frac=0.05, seed=0)
        elif name == "psp":
            self.kind = "K8sPSPPrivilegedContainer"
            self.templates = [
                (policies.load(n), policies.load(n), jpolicies.load(n))
                for n in policies.names()
                if n.startswith("pod-security-policy/")]
            self.constraints = [_constraint(*c) for c in PSP_CONSTRAINTS]
            self.objects = synth_pods_psp(N_PSP)
        else:  # the general library, joins included
            self.kind = "K8sRequiredLabels"
            self.templates = [
                (policies.load(n), policies.load(n), jpolicies.load(n))
                for n in policies.names() if n.startswith("general/")]
            self.constraints = [_constraint(*c) for c in GENERAL_CONSTRAINTS]
            objs = synth_mixed_objects(300)
            # colliding copies, so that the joins fire
            self.objects = objs + [
                {**o, "metadata": {**o["metadata"], "name": f"dup-{i}",
                                   "namespace": "dup"}}
                for i, o in enumerate(objs)
                if o["kind"] in ("Ingress", "Service") and i % 50 < 6]
        for k, client in enumerate(self.clients):
            for t in self.templates:
                client.add_template(copy.deepcopy(t[k]))
            for c in self.constraints:
                client.add_constraint(copy.deepcopy(c))
            for o in self.objects:
                client.add_data(copy.deepcopy(o))

    def add_data(self, obj):
        for client in self.clients:
            client.add_data(copy.deepcopy(obj))

    def remove_data(self, obj):
        for client in self.clients:
            client.remove_data(copy.deepcopy(obj))

    def add_constraint(self, c):
        for client in self.clients:
            client.add_constraint(copy.deepcopy(c))

    def mutations(self, round_: int) -> list:
        if self.name == "requiredlabels":
            return REQ_MUTATIONS
        return [_psp_mutation(self.objects, i, round_)
                for i in (3, 40, 41, 100 + round_)]

    def edited_constraint(self) -> dict:
        """A parameter edit that leaves `match` alone (so the candidate
        set, and with it the feature cache, survives)."""
        if self.name == "requiredlabels":
            c = copy.deepcopy(self.constraints[0])
            c["spec"]["parameters"]["labels"] = [{"key": "owner"},
                                                 {"key": "dept"}]
            return c
        return _constraint("K8sPSPHostNetworkingPorts", "host-ports",
                           {"hostNetwork": False, "min": 8000,
                            "max": 8050})

    def audit(self) -> list:
        """Each driver's audit, checked equal; returns the port's keys."""
        keys = [_key(c.audit().results()) for c in self.clients]
        assert keys[0] == keys[1], "port != JAX TpuDriver"
        names = sorted({k[1] for k in keys[2]})
        assert sorted(keys[0]) == sorted(keys[2])
        for n in names:
            assert [k for k in keys[0] if k[1] == n] == \
                [k for k in keys[2] if k[1] == n], f"{n} != RegoDriver"
        return keys[0]


def _key(results):
    return [(r.msg, r.constraint["metadata"]["name"],
             (r.resource or {}).get("metadata", {}).get("name"),
             r.enforcement_action) for r in results]


@pytest.fixture
def extracts(monkeypatch):
    """Counts the port driver's calls of extract_batch."""
    calls = {"n": 0}
    orig = tdriver.extract_batch

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tdriver, "extract_batch", counting)
    return calls


def _leaves(feats) -> dict:
    return {(s, n): a for s, arrs in feats.items() for n, a in arrs.items()}


def _assert_bit_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("name", ["requiredlabels", "psp"])
def test_churn_is_delta_served(name, extracts):
    """(a) churn only: every review-pure kind is delta-served, nothing is
    extracted, and results equal both JAX drivers round after round."""
    s = Setup(name)
    s.audit()
    s.audit()
    assert s.td.last_audit_path.startswith("delta(")
    extracts["n"] = 0
    for round_ in range(2):
        for m in s.mutations(round_):
            s.add_data(m)
        s.audit()
        kinds = len({c["kind"] for c in s.constraints})
        assert s.td.last_audit_path == f"delta({kinds}/{kinds})"
        assert s.jd.last_audit_path == s.td.last_audit_path
    assert extracts["n"] == 0
    assert s.td.eval_counts()[(s.kind, "delta")] == 3


@pytest.mark.parametrize("name", ["requiredlabels", "psp"])
def test_churn_plus_edit_patches_features(name, extracts, monkeypatch):
    """(b) churn plus a constraint-parameter edit: a full sweep over
    features patched from the journal, bit-equal to the JAX driver's
    patched arrays and to a fresh extraction at the same buckets."""
    s = Setup(name)
    s.audit()
    s.audit()
    meta = s.td._feat_cache[s.kind]["__meta__"]
    leaf_ids = {id(a) for a in _leaves(meta["feats"]).values()}
    patched = []
    orig = tdriver.TorchDriver._patch_feats

    def spy(self, *a, **k):
        out = orig(self, *a, **k)
        patched.append(out is not None)
        return out

    monkeypatch.setattr(tdriver.TorchDriver, "_patch_feats", spy)
    extracts["n"] = 0
    for m in s.mutations(7):
        s.add_data(m)
    s.add_constraint(s.edited_constraint())
    s.audit()
    assert s.td.last_audit_path == "single(cpu)"
    assert extracts["n"] == 0 and patched and all(patched)
    meta = s.td._feat_cache[s.kind]["__meta__"]
    assert meta["rev"] == s.td._data_rev
    got = _leaves(meta["feats"])
    assert {id(a) for a in got.values()} == leaf_ids  # patched in place
    _assert_bit_equal(got, _leaves(
        s.jd._feat_cache[s.kind]["__meta__"]["feats"]))
    reviews = s.td._inventory_reviews(TARGET)
    cand = [reviews[int(i)] for i in meta["cand"]]
    fresh = Extractor(s.td.compiled_for(s.kind).program, s.td.strtab
                      ).extract(cand, meta["n_pad"], meta["buckets"])
    _assert_bit_equal(got, _leaves(fresh))
    # and the next churn round is delta-served again
    for m in s.mutations(8):
        s.add_data(m)
    s.audit()
    assert s.td.last_audit_path.startswith("delta(")


def test_bucket_overflow_rebuilds(extracts):
    """(c) a pod that outgrows its container bucket is never patched
    (extraction truncates silently): the features are rebuilt."""
    s = Setup("psp")
    s.audit()
    s.audit()
    buckets = s.td._feat_cache[s.kind]["__meta__"]["buckets"]
    big = copy.deepcopy(s.objects[5])
    c0 = big["spec"]["containers"][0]
    big["spec"]["containers"] = [
        {**copy.deepcopy(c0), "name": f"c{k}"}
        for k in range(2 * max(buckets.values()) + 1)]
    s.add_data(big)
    s.add_constraint(s.edited_constraint())
    extracts["n"] = 0
    s.audit()
    assert s.td.last_audit_path == "single(cpu)"
    assert extracts["n"] > 0
    assert s.td._feat_cache[s.kind]["__meta__"]["buckets"] != buckets


@pytest.mark.parametrize("op", ["insert", "delete"])
def test_insert_and_delete_break_the_journal(op, extracts):
    """(d) an insert or a delete shifts review indices: the journal
    breaks and the next audit is a full sweep with fresh features."""
    s = Setup("requiredlabels")
    s.audit()
    s.audit()
    extracts["n"] = 0
    if op == "insert":
        s.add_data(_ns(99999, {}))
    else:
        s.remove_data(s.objects[10])
    s.audit()
    assert s.td.last_audit_path == "single(cpu)"
    assert extracts["n"] == 1
    s.audit()
    assert s.td.last_audit_path == "delta(1/1)"


@pytest.mark.parametrize("how", ["drop_inventory_caches", "template_reput"])
def test_invalidation_forces_a_full_sweep(how):
    """(e) drop_inventory_caches clears the delta cache; (f) a template
    re-put drops that kind's delta entry."""
    s = Setup("requiredlabels")
    want = s.audit()
    s.audit()
    assert (TARGET, s.kind) in s.td._audit_results_cache
    if how == "drop_inventory_caches":
        for d in (s.td, s.jd):
            d.drop_inventory_caches()
        assert s.td._audit_results_cache == {}
    else:
        # a new rego text (a comment): the client re-puts the modules
        t = copy.deepcopy(REQUIRED_LABELS_TEMPLATE)
        t["spec"]["targets"][0]["rego"] += "\n# re-put\n"
        s.clients[0].add_template(copy.deepcopy(t))
        s.clients[1].add_template(copy.deepcopy(t))
        assert (TARGET, s.kind) not in s.td._audit_results_cache
    assert s.audit() == want
    assert s.td.last_audit_path == "single(cpu)"
    assert s.audit() == want
    assert s.td.last_audit_path == "delta(1/1)"


def test_capped_sweep_not_served_uncapped():
    """(g) results cached by a capped sweep carry count-only messages:
    they serve a capped caller, never an uncapped one."""
    s = Setup("psp")  # SELinux and sysctls messages are vectorized
    for d in (s.td, s.jd):
        d.audit_violations_cap = 1
    capped = s.clients[0].audit().results()
    assert s.td.last_audit_path == "single(cpu)"
    assert sum(1 for r in capped if r.msg == "") > 0
    assert _key(s.clients[1].audit().results()) == _key(capped)
    for m in s.mutations(0):
        s.add_data(m)
    again = s.clients[0].audit().results()
    assert s.td.last_audit_path == "delta(16/16)"  # capped serves capped
    assert _key(s.clients[1].audit().results()) == _key(again)
    for d in (s.td, s.jd):
        d.audit_violations_cap = None
    got = s.audit()
    assert s.td.last_audit_path == "single(cpu)"
    assert all(k[0] for k in got) and len(got) == len(again)


def test_join_kinds_never_delta_served():
    """(h) the join kinds read `data`: every audit re-evaluates them."""
    s = Setup("general")
    first = s.audit()
    assert any(k[1].startswith("unique-") for k in first)
    assert s.audit() == first
    assert s.td.last_audit_path == "delta(5/7)"
    s.add_data({**s.objects[1], "metadata": {
        **s.objects[1]["metadata"], "labels": {"owner": "x"}}})
    s.audit()
    assert s.td.last_audit_path == "delta(5/7)"
    counts = s.td.eval_counts()
    for kind in ("K8sUniqueIngressHost", "K8sUniqueServiceSelector"):
        assert s.td._template_reads_data(kind)
        assert counts[(kind, "join")] == 3
        assert (kind, "delta") not in counts


def test_warm_restart_rows_adopted(extracts):
    """(i) snapshot the encoded rows and the vocabulary, restore them
    into a fresh driver: its first audit adopts them, extracting
    nothing, and equals the original."""
    s = Setup("requiredlabels")
    want = s.audit()
    rows = s.td.encoded_rows_snapshot()
    assert rows and s.kind in rows
    td2 = TorchDriver(device="cpu")
    td2._use_device_for_batch = lambda n: True  # as Setup's drivers
    td2.vocab_restore(s.td.vocab_snapshot())
    client = Backend(td2).new_client([K8sValidationTarget()])
    client.add_template(copy.deepcopy(REQUIRED_LABELS_TEMPLATE))
    for c in s.constraints:
        client.add_constraint(copy.deepcopy(c))
    td2.inventory_restore(s.td.inventory_snapshot())
    td2.encoded_rows_restore(rows)
    extracts["n"] = 0
    assert _key(client.audit().results()) == want
    assert td2.restored_rows_adopted == 1
    assert extracts["n"] == 0
    # a write after the restore voids the stash: a cold extraction
    td3 = TorchDriver(device="cpu")
    td3._use_device_for_batch = lambda n: True
    td3.vocab_restore(s.td.vocab_snapshot())
    client = Backend(td3).new_client([K8sValidationTarget()])
    client.add_template(copy.deepcopy(REQUIRED_LABELS_TEMPLATE))
    for c in s.constraints:
        client.add_constraint(copy.deepcopy(c))
    td3.inventory_restore(s.td.inventory_snapshot())
    td3.encoded_rows_restore(rows)
    client.add_data(_ns(99999, {}))
    client.audit()
    assert td3.restored_rows_adopted == 0
    assert extracts["n"] == 1
