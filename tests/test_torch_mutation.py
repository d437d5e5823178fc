"""The port's mutation system against the JAX package's.

The cases of tests/test_mutation.py (the location-path parser, apply
semantics, schema-conflict quarantine, convergence, JSONPatch emission,
batched applicability, the /v1/mutate handler), each run through both
packages' `mutation` and `control.webhook.MutationHandler` on the same
inputs: every case returns a transcript of what it observed, and the
transcripts must be equal (exact). The reference's own expectations are
asserted inside each case as well.
"""

from __future__ import annotations

import base64
import copy
import json
import random
import threading
import time
import types

import pytest

from gatekeeper_tpu import mutation as jmutation
from gatekeeper_tpu.control import metrics as jmetrics
from gatekeeper_tpu.control import webhook as jwebhook
from gatekeeper_tpu.mutation import path as jpath
from gatekeeper_tpu.target import matcher as jmatcher
from gatekeeper_tpu_torch import mutation as tmutation
from gatekeeper_tpu_torch.control import metrics as tmetrics
from gatekeeper_tpu_torch.control import webhook as twebhook
from gatekeeper_tpu_torch.mutation import path as tpath
from gatekeeper_tpu_torch.target import matcher as tmatcher

JAX = types.SimpleNamespace(m=jmutation, path=jpath, webhook=jwebhook,
                            metrics=jmetrics, matcher=jmatcher)
TORCH = types.SimpleNamespace(m=tmutation, path=tpath, webhook=twebhook,
                              metrics=tmetrics, matcher=tmatcher)


def assign(name, location, value, apply_to=None, match=None):
    spec = {
        "applyTo": apply_to if apply_to is not None else [
            {"groups": [""], "versions": ["v1"], "kinds": ["Pod"]}],
        "location": location,
        "parameters": {"assign": {"value": value}},
    }
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
            "kind": "Assign", "metadata": {"name": name}, "spec": spec}


def assign_meta(name, location, value, match=None):
    spec = {"location": location,
            "parameters": {"assign": {"value": value}}}
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
            "kind": "AssignMetadata", "metadata": {"name": name},
            "spec": spec}


def modify_set(name, location, values, operation="merge", match=None):
    spec = {
        "applyTo": [{"groups": [""], "versions": ["v1"], "kinds": ["Pod"]}],
        "location": location,
        "parameters": {"operation": operation,
                       "values": {"fromList": values}},
    }
    if match is not None:
        spec["match"] = match
    return {"apiVersion": "mutations.gatekeeper.sh/v1alpha1",
            "kind": "ModifySet", "metadata": {"name": name}, "spec": spec}


def pod_review(name="p", ns="default", labels=None, containers=None):
    obj = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": ns},
           "spec": {"containers": containers if containers is not None
                    else [{"name": "main", "image": "x"}]}}
    if labels is not None:
        obj["metadata"]["labels"] = labels
    return {"kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": name, "namespace": ns, "operation": "CREATE",
            "object": obj}


def raised(fn) -> str:
    """The exception `fn` raises, as 'TypeName: message' (the two
    packages' exception classes are distinct objects)."""
    try:
        fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    raise AssertionError("no exception")


# ---------------------------------------------------------------- parser

PATH_CASES = [
    "spec.replicas",
    "spec.containers[name: *].imagePullPolicy",
    "spec.containers[name: sidecar].resources.limits",
    'metadata.labels."corp.example/team"',
    'spec."weird.field"[key: "v.1"].x',
    "spec.template.spec.tolerations",
]

MALFORMED = [
    "", "   ", "spec.", ".spec", "spec..x", "spec.containers[name]",
    "spec.containers[name: ]", "spec.containers[name: *",
    "spec.x[*: y]", 'spec."unterminated', "spec.a b",
]


def case_path_round_trip(P):
    out = []
    for path in PATH_CASES:
        nodes = P.m.parse(path)
        assert P.m.parse(P.m.render(nodes)) == nodes
        assert P.m.render(P.m.parse(P.m.render(nodes))) == \
            P.m.render(nodes)
        out.append((repr(nodes), P.m.render(nodes)))
    return out


def case_path_nodes_shape(P):
    nodes = P.m.parse("spec.containers[name: *].imagePullPolicy")
    assert nodes == [P.path.ObjectNode("spec"),
                     P.path.ListNode("containers", "name", None, glob=True),
                     P.path.ObjectNode("imagePullPolicy")]
    keyed = P.m.parse("spec.containers[name: sidecar]")
    assert keyed[-1] == P.path.ListNode("containers", "name", "sidecar")
    return [repr(nodes), repr(keyed)]


def case_path_integer_list_keys(P):
    nodes = P.m.parse("spec.ports[containerPort: 8080].protocol")
    assert nodes[1] == P.path.ListNode("ports", "containerPort", 8080)
    quoted = P.m.parse('spec.ports[containerPort: "8080"].protocol')
    assert quoted[1] == P.path.ListNode("ports", "containerPort", "8080")
    assert P.m.parse(P.m.render(quoted)) == quoted and nodes != quoted
    m = P.m.load_mutator(assign(
        "proto", "spec.ports[containerPort: 8080].protocol", "TCP"))
    obj = {"spec": {"ports": [{"containerPort": 8080}]}}
    changed = m.apply(obj)
    assert changed is True
    assert obj["spec"]["ports"] == [{"containerPort": 8080,
                                     "protocol": "TCP"}]
    return [repr(nodes), repr(quoted), changed, obj]


def case_path_rejects_malformed(P):
    out = []
    for bad in MALFORMED:
        with pytest.raises(P.m.PathError):
            P.m.parse(bad)
        out.append(raised(lambda: P.m.parse(bad)))
    return out


def case_assign_rejections(P):
    """A glob terminal, a metadata location for Assign, and the
    constrained AssignMetadata locations are rejected at ingestion."""
    bad = [assign("a", "spec.containers[name: *]", {"image": "x"}),
           assign("a", "metadata.labels.x", "y"),
           assign_meta("a", "spec.labels.x", "y"),
           assign_meta("a", "metadata.name", "y"),
           assign_meta("a", "metadata.labels.x", {"not": "str"})]
    out = []
    for cr in bad:
        with pytest.raises(P.m.MutationError):
            P.m.load_mutator(cr)
        out.append(raised(lambda: P.m.load_mutator(cr)))
    assert "glob" in out[0]
    return out


# ----------------------------------------------------------------- apply


def case_assign_creates_intermediates_and_keyed_elements(P):
    m = P.m.load_mutator(assign(
        "a", "spec.template.metadata.annotations.x", "y"))
    obj = {"spec": {}}
    steps = [m.apply(obj), m.apply(obj), copy.deepcopy(obj)]
    assert steps[:2] == [True, False]
    keyed = P.m.load_mutator(assign(
        "b", "spec.containers[name: sidecar].image", "img:v1"))
    obj = {"spec": {"containers": [{"name": "main", "image": "x"}]}}
    steps += [keyed.apply(obj), obj]
    assert obj["spec"]["containers"][1] == {"name": "sidecar",
                                            "image": "img:v1"}
    return steps


def case_assign_glob_never_creates(P):
    m = P.m.load_mutator(assign(
        "a", "spec.containers[name: *].imagePullPolicy", "Always"))
    obj = {"spec": {}}
    steps = [m.apply(obj), copy.deepcopy(obj)]
    assert steps == [False, {"spec": {}}]
    obj = {"spec": {"containers": [{"name": "a"}, {"name": "b"}]}}
    steps += [m.apply(obj), obj]
    assert [c["imagePullPolicy"] for c in obj["spec"]["containers"]] == \
        ["Always", "Always"]
    return steps


def case_assign_metadata_only_sets_when_absent(P):
    m = P.m.load_mutator(assign_meta("a", "metadata.labels.team",
                                     "platform"))
    obj = {"metadata": {"labels": {"team": "existing"}}}
    steps = [m.apply(obj), copy.deepcopy(obj)]
    assert steps[0] is False
    obj = {"metadata": {}}
    steps += [m.apply(obj), obj]
    assert obj["metadata"]["labels"]["team"] == "platform"
    return steps


def case_modify_set_merge_and_prune(P):
    merge = P.m.load_mutator(modify_set(
        "m", "spec.tolerations", [{"key": "gpu", "operator": "Exists"}]))
    obj = {"spec": {}}
    steps = [merge.apply(obj), copy.deepcopy(obj), merge.apply(obj)]
    assert steps[0] is True and steps[2] is False
    prune = P.m.load_mutator(modify_set(
        "p", "spec.tolerations", [{"key": "gpu", "operator": "Exists"}],
        operation="prune"))
    steps += [prune.apply(obj), copy.deepcopy(obj)]
    assert obj["spec"]["tolerations"] == []
    fresh = {"spec": {}}
    steps += [prune.apply(fresh), fresh]
    assert fresh == {"spec": {}}
    return steps


# ------------------------------------------------------------- conflicts


def case_conflict_detector_quarantines_disagreeing_pair(P):
    system = P.m.MutationSystem()
    _, ch1 = system.upsert(assign(
        "as-list", "spec.containers[name: *].imagePullPolicy", "Always"))
    assert ch1 == set() and system.conflicts() == {}
    _, ch2 = system.upsert(assign("as-object", "spec.containers.image",
                                  "img"))
    conflicts = system.conflicts()
    assert set(conflicts) == {("Assign", "as-list"),
                              ("Assign", "as-object")}
    assert ch2 == set(conflicts)
    quarantined = system.mutate(pod_review())
    assert quarantined is None
    ch3 = system.remove(("Assign", "as-object"))
    out = system.mutate(pod_review())
    assert out["spec"]["containers"][0]["imagePullPolicy"] == "Always"
    return [sorted(ch2), dict(sorted(conflicts.items())), quarantined,
            sorted(ch3), system.conflicts(), out, system.counts()]


def case_conflict_scoped_by_apply_to(P):
    system = P.m.MutationSystem()
    system.upsert(assign(
        "pod-list", "spec.containers[name: *].imagePullPolicy", "Always",
        apply_to=[{"groups": [""], "versions": ["v1"], "kinds": ["Pod"]}]))
    system.upsert(assign(
        "crd-object", "spec.containers.image", "img",
        apply_to=[{"groups": ["widgets.example"], "versions": ["v1"],
                   "kinds": ["Widget"]}]))
    first = system.conflicts()
    assert first == {}
    system.upsert(assign(
        "star-object", "spec.containers.image", "img",
        apply_to=[{"groups": ["*"], "versions": ["*"], "kinds": ["*"]}]))
    second = system.conflicts()
    assert {("Assign", "pod-list"), ("Assign", "star-object")} <= \
        set(second)
    return [first, dict(sorted(second.items()))]


def case_conflict_reason_refreshes_when_third_mutator_joins(P):
    system = P.m.MutationSystem()
    system.upsert(assign("a-list", "spec.containers[name: *].x", "v"))
    system.upsert(assign("b-object", "spec.containers.y", "v"))
    _, ch = system.upsert(assign("c-object", "spec.containers.z", "v"))
    assert {("Assign", "a-list"), ("Assign", "c-object")} <= ch
    mid = dict(sorted(system.conflicts().items()))
    assert "c-object" in mid[("Assign", "a-list")]
    ch2 = system.remove(("Assign", "c-object"))
    assert {("Assign", "a-list"), ("Assign", "c-object")} <= ch2
    end = dict(sorted(system.conflicts().items()))
    assert "c-object" not in end[("Assign", "a-list")]
    return [sorted(ch), mid, sorted(ch2), end]


def case_modifyset_terminal_implies_list_conflict(P):
    system = P.m.MutationSystem()
    system.upsert(modify_set("ms", "spec.tolerations", [{"key": "a"}]))
    system.upsert(assign("as", "spec.tolerations.effect", "NoSchedule"))
    conflicts = dict(sorted(system.conflicts().items()))
    assert set(conflicts) == {("ModifySet", "ms"), ("Assign", "as")}
    return conflicts


# ----------------------------------------------------- convergence + patch


def case_convergence_cap_errors_on_ping_pong_pair(P):
    system = P.m.MutationSystem(max_iterations=5)
    system.upsert(assign("ping", "spec.priorityClassName", "low"))
    system.upsert(assign("pong", "spec.priorityClassName", "high"))
    with pytest.raises(P.m.MutationError, match="did not converge"):
        system.mutate(pod_review())
    outs = system.mutate_batch([pod_review()])
    assert isinstance(outs[0], P.m.MutationError)
    return [raised(lambda: system.mutate(pod_review())), str(outs[0])]


def case_second_pass_idempotence_yields_empty_patch(P):
    system = P.m.MutationSystem()
    system.upsert(assign(
        "pull", "spec.containers[name: *].imagePullPolicy", "Always"))
    system.upsert(assign_meta("team", "metadata.labels.team", "plat"))
    system.upsert(modify_set("tol", "spec.tolerations", [{"key": "gpu"}]))
    review = pod_review()
    mutated = system.mutate(review)
    patch = P.m.json_patch(review["object"], mutated)
    assert patch
    remutated = system.mutate(dict(review, object=mutated))
    assert P.m.json_patch(mutated, remutated) == []
    return [mutated, patch]


def case_json_patch_round_trip_and_escaping(P):
    before = {"metadata": {"labels": {"a/b": "x", "t~e": "y"}},
              "spec": {"items": [1, 2, 3], "drop": True}}
    after = {"metadata": {"labels": {"a/b": "z", "new": "n"}},
             "spec": {"items": [1, 9], "add": {"k": "v"}}}
    ops = P.m.json_patch(before, after)
    assert P.m.apply_patch(before, ops) == after
    paths = [op["path"] for op in ops]
    assert "/metadata/labels/a~1b" in paths
    assert any(p.startswith("/metadata/labels/t~0e") for p in paths)
    assert P.m.json_patch(after, after) == []
    return ops


# --------------------------------------------- batched applicability (diff)


def _random_match(rng):
    match = {}
    if rng.random() < 0.5:
        match["kinds"] = [{
            "apiGroups": rng.choice(([""], ["*"], ["apps"])),
            "kinds": rng.choice((["Pod"], ["*"], ["Deployment"],
                                 ["Pod", "Service"])),
        }]
    if rng.random() < 0.35:
        match["namespaces"] = rng.sample(
            ["prod", "dev", "staging", "default"], rng.randrange(1, 3))
    if rng.random() < 0.25:
        match["excludedNamespaces"] = [rng.choice(["prod", "dev"])]
    if rng.random() < 0.4:
        match["labelSelector"] = rng.choice((
            {"matchLabels": {"app": "web"}},
            {"matchExpressions": [{"key": "tier", "operator": "Exists"}]},
            {"matchExpressions": [{"key": "app", "operator": "In",
                                   "values": ["web", "api"]}]},
        ))
    if rng.random() < 0.3:
        match["namespaceSelector"] = {"matchLabels": {"env": "prod"}}
    return match


def _random_review(rng, i):
    kind = rng.choice((("", "v1", "Pod"), ("", "v1", "Service"),
                       ("apps", "v1", "Deployment"),
                       ("", "v1", "Namespace")))
    labels = rng.choice((None, {"app": "web"}, {"app": "api", "tier": "be"},
                         {"tier": "fe"}))
    obj = {"apiVersion": "v1", "kind": kind[2],
           "metadata": {"name": f"o{i}"}}
    if labels is not None:
        obj["metadata"]["labels"] = labels
    review = {"kind": {"group": kind[0], "version": kind[1],
                       "kind": kind[2]},
              "name": f"o{i}", "object": obj}
    if kind[2] != "Namespace" and rng.random() < 0.8:
        ns = rng.choice(["prod", "dev", "staging", "default", "unknown"])
        review["namespace"] = ns
        obj["metadata"]["namespace"] = ns
    return review


def case_batched_applicability_matches_per_object_predicate(P):
    """The micro-batch mask agrees with the per-object predicate and the
    applyTo gate on every (review, mutator) pair, and the mutated
    batch is returned."""
    rng = random.Random(42)
    ns_cache = {
        "prod": {"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": "prod", "labels": {"env": "prod"}}},
        "dev": {"apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": "dev", "labels": {"env": "dev"}}},
        "default": {"apiVersion": "v1", "kind": "Namespace",
                    "metadata": {"name": "default", "labels": {}}},
    }
    lookup = ns_cache.get
    system = P.m.MutationSystem()
    mutators = []
    for i in range(24):
        shape = i % 3
        match = _random_match(rng)
        if shape == 0:
            cr = assign(f"a{i}", "spec.one", "v", match=match,
                        apply_to=[{
                            "groups": rng.choice(([""], ["*"], ["apps"])),
                            "versions": ["*"],
                            "kinds": rng.choice((["Pod"], ["*"],
                                                 ["Deployment"]))}])
        elif shape == 1:
            cr = assign_meta(f"m{i}", f"metadata.labels.x{i}", "v",
                             match=match)
        else:
            cr = modify_set(f"s{i}", "spec.two", ["v"], match=match)
        mut, _ = system.upsert(cr)
        mutators.append(mut)
    reviews = [_random_review(rng, i) for i in range(240)]
    mask = system.match_mask(mutators, reviews, lookup)
    assert mask.shape == (240, 24)
    for r, review in enumerate(reviews):
        kind = review["kind"]
        for c, mut in enumerate(mutators):
            want = P.matcher.constraint_matches(
                {"spec": {"match": mut.match}}, review, lookup) and \
                mut.applies_to_gvk(kind["group"], kind["version"],
                                   kind["kind"])
            assert mask[r, c] == want, (r, c)
    batch = system.mutate_batch(copy.deepcopy(reviews), lookup)
    return [mask.tolist(), batch]


# -------------------------------------------------------- webhook handler


def case_mutation_handler_patches_and_envelope(P):
    system = P.m.MutationSystem()
    system.upsert(assign(
        "pull", "spec.containers[name: *].imagePullPolicy", "Always"))
    handler = P.webhook.MutationHandler(system)
    try:
        review = pod_review()
        out = handler.handle({
            "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": dict(review, uid="u-1",
                            userInfo={"username": "alice"})})
        assert out["apiVersion"] == "admission.k8s.io/v1"
        assert out["kind"] == "AdmissionReview"
        resp = out["response"]
        assert resp["uid"] == "u-1" and resp["allowed"] is True
        assert resp["patchType"] == "JSONPatch"
        ops = json.loads(base64.b64decode(resp["patch"]))
        patched = P.m.apply_patch(review["object"], ops)
        assert patched["spec"]["containers"][0]["imagePullPolicy"] == \
            "Always"
        again = handler.handle({
            "apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": dict(review, object=patched, uid="u-2",
                            userInfo={"username": "alice"})})
        assert "patch" not in again["response"]
        assert again["response"]["allowed"] is True
        return [P.webhook.encode_envelope(out),
                P.webhook.encode_envelope(again)]
    finally:
        handler.batcher.stop()


def case_mutation_handler_failure_policy(P):
    system = P.m.MutationSystem(max_iterations=2)
    system.upsert(assign("ping", "spec.x", "a"))
    system.upsert(assign("pong", "spec.x", "b"))
    review = {"apiVersion": "admission.k8s.io/v1",
              "kind": "AdmissionReview",
              "request": dict(pod_review(), uid="u",
                              userInfo={"username": "alice"})}
    open_h = P.webhook.MutationHandler(system)
    closed_h = P.webhook.MutationHandler(system, fail_closed=True)
    try:
        allowed = open_h.handle(copy.deepcopy(review))["response"]
        denied = closed_h.handle(copy.deepcopy(review))["response"]
    finally:
        open_h.batcher.stop()
        closed_h.batcher.stop()
    assert allowed["allowed"] is True and allowed["status"]["code"] == 500
    assert denied["allowed"] is False and denied["status"]["code"] == 500
    assert 'mutation_request_count{admission_status="error"}' in \
        P.metrics.REGISTRY.render()
    return [allowed, denied]


def case_mutation_handler_skips_gatekeeper_resources_and_deletes(P):
    system = P.m.MutationSystem()
    system.upsert(assign_meta("lbl", "metadata.labels.x", "y"))
    handler = P.webhook.MutationHandler(system)
    try:
        delete = handler.handle({"request": {
            "uid": "d", "kind": {"group": "", "version": "v1",
                                 "kind": "Pod"},
            "operation": "DELETE", "object": None,
            "userInfo": {"username": "alice"}}})
        own = handler.handle({"request": {
            "uid": "o",
            "kind": {"group": "mutations.gatekeeper.sh",
                     "version": "v1alpha1", "kind": "Assign"},
            "object": assign("x", "spec.a", "b"),
            "userInfo": {"username": "alice"}}})
        assert "patch" not in delete["response"]
        assert "patch" not in own["response"]
        return [delete, own]
    finally:
        handler.batcher.stop()


def case_microbatcher_timeout_drops_queued_entry(P):
    """A submit() whose deadline expires before its batch can flush
    raises, removes its queued entry, counts a timeout, and the batcher
    keeps serving."""
    release = threading.Event()

    def evaluate(reviews):
        if any("hang" in r for r in reviews):
            release.wait(10)
        return [[] for _ in reviews]

    b = P.webhook.MicroBatcher(None, max_wait=0.001, max_batch=1,
                               evaluate=evaluate)
    try:
        hang = threading.Thread(
            target=lambda: b.submit({"hang": 1}, timeout=10.0),
            daemon=True)
        hang.start()
        deadline = time.time() + 5
        while time.time() < deadline:  # the hung batch holds the flusher
            with b._scv:
                if b._flushing:
                    break
            time.sleep(0.005)
        before = b.timeouts
        with pytest.raises(TimeoutError):
            b.submit({"probe": 1}, timeout=0.05)
        timeouts = b.timeouts - before
        with b._cv:
            queued = list(b._queue)
        assert "admission_batch_timeouts" in P.metrics.REGISTRY.render()
        release.set()
        hang.join(5)
        assert not hang.is_alive()
        later = b.submit({"probe": 2}, timeout=5.0)
        return [timeouts, queued, later]
    finally:
        release.set()
        b.stop()


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_mutation_case_equal(case):
    assert case(TORCH) == case(JAX)


@pytest.mark.parametrize("n_mutators", [30, 150, 600])
def test_bench_config7_mutation_batch_equal(n_mutators):
    """BENCH config 7's mutation batch (bench_configs.config7): 512
    mixed reviews through one mutate_batch over a synthetic library of
    30, 150 and 600 mutators; every review's mutated object (or error)
    equal in both packages (None where none applies)."""
    import bench_configs

    reviews = bench_configs._mixed_reviews(512, seed=11)
    library = bench_configs._synth_mutators(n_mutators)
    outs = []
    for P in (TORCH, JAX):
        system = P.m.MutationSystem()
        for m in copy.deepcopy(library):
            system.upsert(m)
        assert not system.conflicts(), "synthetic library must be clean"
        outs.append([(type(o).__name__, str(o))
                     if isinstance(o, Exception) else o
                     for o in system.mutate_batch(copy.deepcopy(reviews))])
    assert len(outs[0]) == len(reviews)
    assert outs[0] == outs[1]
    assert sum(isinstance(o, dict) for o in outs[0]) > 0
