"""Inputs of the JAX package's device-compiler suites, for the port.

Copies of what tests/test_compile_coverage.py, tests/test_ir_regressions.py,
tests/test_ir_compile.py and tests/test_ir_join.py feed their drivers
(objects, reviews, templates, constraints, the churn), with their result
key and the helpers the port's counterparts share. The CPU counterparts
(tests/test_torch_compile_coverage.py, test_torch_ir_regressions.py,
test_torch_ir_compile.py, test_torch_ir_join.py) hold each copy to the
reference module's own; tests/test_torch_gpu.py runs the same inputs on
the card. Imports neither jax nor the JAX package. Not a test module
(pytest does not collect it).
"""

from __future__ import annotations

import copy

TARGET = "admission.k8s.gatekeeper.sh"
PATHS_DEVICE = ("device", "join")


def result_key(r):
    """test_compile_coverage.result_key: message, constraint name and
    kind, resource name, enforcement action."""
    return (r.msg, r.constraint["metadata"]["name"],
            r.constraint["kind"],
            (r.resource or {}).get("metadata", {}).get("name"),
            r.enforcement_action)


def keys(results) -> list:
    return sorted(result_key(r) for r in results)


def names(results) -> list:
    """test_ir_regressions.names."""
    return sorted(r.resource["metadata"]["name"] for r in results)


def eval_paths(drv) -> dict:
    """kind -> the eval paths a driver served it on (either package's
    driver: TpuDriver keeps TorchDriver.eval_counts() in _eval_counts)."""
    counts = drv.eval_counts() if hasattr(drv, "eval_counts") else \
        dict(drv._eval_counts)
    out: dict = {}
    for (kind, path), n in counts.items():
        if n:
            out.setdefault(kind, set()).add(path)
    return out


def assert_served(drv, kinds, paths=PATHS_DEVICE) -> None:
    """Every kind in `kinds` was evaluated, and only on `paths` (by
    default the device or the join path: never the interpreter)."""
    got = eval_paths(drv)
    for kind in kinds:
        assert got.get(kind) and got[kind] <= set(paths), \
            (kind, got.get(kind), paths)


def mk(template_rego: str, kind: str = "K8sTest", name=None) -> dict:
    """test_ir_regressions.mk."""
    return {
        "apiVersion": "templates.gatekeeper.sh/v1beta1",
        "kind": "ConstraintTemplate",
        "metadata": {"name": name or kind.lower()},
        "spec": {
            "crd": {"spec": {"names": {"kind": kind}}},
            "targets": [{"target": TARGET, "rego": template_rego}],
        },
    }


def constraint(kind: str, name: str, params=None) -> dict:
    """test_ir_regressions.constraint."""
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind, "metadata": {"name": name},
        "spec": {"parameters": params or {}},
    }


def bare_constraint(kind: str, name: str, params=None) -> dict:
    """The coverage suite's constraint: spec.parameters only when given."""
    return {
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": kind, "metadata": {"name": name},
        "spec": ({"parameters": params} if params else {})}


def loaded_client(backend, target, drv, templates, constraints, objects):
    """A client on `drv` with the templates, constraints and a deep copy
    of each object."""
    client = backend(drv).new_client([target()])
    for t in templates:
        client.add_template(t)
    for c in constraints:
        client.add_constraint(c)
    for o in objects:
        client.add_data(copy.deepcopy(o))
    return client


def library_templates(policies, lib: str) -> list:
    """A shipped library's templates, in policies.names() order."""
    return [policies.load(n) for n in policies.names()
            if n.startswith(lib + "/")]


def library_constraints(constraints) -> list:
    """test_compile_coverage.load_library's constraints."""
    return [bare_constraint(kind, cname, params)
            for kind, cname, params in constraints]


def lib_objects(workload, lib: str, n: int) -> list:
    """test_compile_coverage.lib_objects, from a package's generators."""
    if lib == "general":
        return workload.synth_mixed_objects(n, seed=7)
    return workload.synth_pods_psp(n, seed=7)


def churn(objs, rng):
    """test_compile_coverage.churn: about 3% replacements (field flips)
    and two removals, applied identically to every driver."""
    replaced = []
    for i in rng.sample(range(len(objs)), max(2, len(objs) // 33)):
        o = copy.deepcopy(objs[i])
        o["metadata"].setdefault("labels", {})["churned"] = "yes"
        spec = o.get("spec", {})
        for c in spec.get("containers", []) or []:
            c["image"] = "docker.io/churned:latest"
        replaced.append(o)
    removed = [objs[i] for i in rng.sample(range(len(objs)), 2)]
    return replaced, removed


LIB_SWEEPS = [("general", 360), ("pod-security-policy", 240)]
LIB_KINDS = {"general": 7, "pod-security-policy": 16}

# ------------------------------------------------ test_compile_coverage

XOBJS = [
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": f"p{i}", "namespace": f"ns{i % 5}",
                  "labels": ({"owner": "a", "app": "b", "team": "c"}
                             if i % 4 else {"owner": "a"})},
     "spec": {"containers": [
         {"name": "main",
          "image": ("docker.io/evil7:latest" if i % 11 == 0 else
                    "Docker.IO/app:v1" if i % 7 == 0 else
                    "gcr.io/corp/app:v1"),
          **({} if i % 3 == 0 else
             {"securityContext": {"runAsNonRoot": i % 2 == 0}})}]}}
    for i in range(80)
] + [
    {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
     "metadata": {"name": f"ing{i}", "namespace": f"ns{i % 3}",
                  "uid": f"uid-ing{i}"},
     "spec": {"rules": [{"host": f"h{i % 6}.example.com"}]}}
    for i in range(16)
] + [
    {"apiVersion": "v1", "kind": "Service",
     "metadata": {"name": f"svc{i}", "namespace": f"ns{i % 3}"},
     "spec": {"selector": {"app": f"app{i % 5}"}}}
    for i in range(12)
]

XREVIEWS = [
    {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
     "metadata": {"name": "new", "namespace": "ns9"},
     "spec": {"rules": [{"host": "h0.example.com"}]}},
    {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
     "metadata": {"name": "ing1", "namespace": "ns1", "uid": "uid-ing1"},
     "spec": {"rules": [{"host": "h-solo.example.com"}]}},
    {"apiVersion": "v1", "kind": "Service",
     "metadata": {"name": "svc1", "namespace": "ns1"},
     "spec": {"selector": {"app": "app1"}}},
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": "naked", "namespace": "ns0",
                  "labels": {"owner": "a"}},
     "spec": {"containers": [{"name": "m",
                              "image": "docker.io/evil7:latest"}]}},
]

MULTICLAUSE_KIND = "XUniqueHostMulti"
MULTICLAUSE_REGO = """
package xuniquehostmulti

identical(obj, review) {
  obj.metadata.namespace == review.object.metadata.namespace
  obj.metadata.name == review.object.metadata.name
}

identical(obj, review) {
  obj.metadata.uid == review.uid
}

violation[{"msg": msg}] {
  input.review.kind.kind == "Ingress"
  host := input.review.object.spec.rules[_].host
  other := data.inventory.namespace[ns][apiv]["Ingress"][name]
  other.spec.rules[_].host == host
  not identical(other, input.review)
  msg := sprintf("host conflict <%v>", [host])
}
"""
# own copy via ns/name; own copy via uid only (renamed); true conflict
MULTICLAUSE_REVIEWS = [
    {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
     "metadata": {"name": "ing2", "namespace": "ns2",
                  "uid": "uid-ing2"},
     "spec": {"rules": [{"host": "solo-h.example.com"}]}},
    {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
     "metadata": {"name": "renamed", "namespace": "nsX",
                  "uid": "uid-ing3"},
     "spec": {"rules": [{"host": "h3.example.com"}]}},
    {"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
     "metadata": {"name": "clash", "namespace": "nsY",
                  "uid": "uid-clash"},
     "spec": {"rules": [{"host": "h0.example.com"}]}},
]

TAXONOMY_REGO = {
    "XUnsupportedCall": """
package xunsupportedcall

violation[{"msg": msg}] {
  x := object.get(input.review.object, "spec", {})
  x.hostNetwork
  msg := "no host network"
}
""",
    "XNegatedGenerator": """
package xnegatedgenerator

violation[{"msg": msg}] {
  not data.inventory.cluster["v1"]["Namespace"][input.review.object.metadata.namespace]
  msg := "namespace not synced"
}
""",
    "XParamJoin": """
package xparamjoin

violation[{"msg": msg}] {
  input.parameters.enabled == true
  other := data.inventory.namespace[ns][apiv]["Ingress"][name]
  other.spec.rules[_].host == input.review.object.spec.rules[_].host
  msg := "conflict"
}
""",
    "XNonEmptyCount": """
package xnonemptycount

violation[{"msg": msg}] {
  provided := {k | input.review.object.metadata.labels[k]}
  count(provided) > 1
  msg := "too many labels"
}
""",
}

XFLIPS_BAD = """
package xflips

violation[{"msg": msg}] {
  x := object.get(input.review.object, "spec", {})
  x.bad
  msg := "bad"
}
"""
XFLIPS_GOOD = """
package xflips

violation[{"msg": msg}] {
  input.review.object.spec.bad == true
  msg := "bad"
}
"""

# ---------------------------------------------------- test_ir_regressions
# name -> (rego, constraints as (name, params), objects, expected names)

_NS = "Namespace"


def _obj(kind, name, ns=None, **fields):
    meta = {"name": name}
    if ns is not None:
        meta["namespace"] = ns
    return {"apiVersion": "v1", "kind": kind, "metadata": meta, **fields}


REGRESSIONS = {
    "dup_sensitive_count": ("""
package k8stest
violation[{"msg": "exactly one missing"}] {
  required := {l | l := input.parameters.labels[_]}
  provided := {l | input.review.object.metadata.labels[l]}
  missing := required - provided
  count(missing) == 1
}
""", [("c", {"labels": ["a", "a"]})], [_obj(_NS, "n0")], ["n0"]),
    "count_of_set_comprehension": ("""
package k8stest
violation[{"msg": "no labels"}] {
  provided := {l | input.review.object.metadata.labels[l]}
  count(provided) == 0
}
""", [("c", None)], [
        _obj(_NS, "bare"),
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": "labeled", "labels": {"x": "y"}}},
    ], ["bare"]),
    "bare_scalar_guard": ("""
package k8stest
violation[{"msg": "hit"}] {
  true
  input.review.object.metadata.name == "target"
}
""", [("c", None)], [_obj("Pod", "target", "d"), _obj("Pod", "other", "d")],
        ["target"]),
    "large_integer_equality": ("""
package k8stest
violation[{"msg": "uid mismatch"}] {
  input.review.object.spec.uid != input.parameters.uid
}
""", [("c", {"uid": 16777217})], [
        _obj("Pod", "big", "d", spec={"uid": 16777216}),
        _obj("Pod", "same", "d", spec={"uid": 16777217}),
    ], ["big"]),
    "trim_empty_cutset": ("""
package k8stest
violation[{"msg": "prefix"}] {
  startswith(input.review.object.metadata.name, trim(input.parameters.p, ""))
}
""", [("c", {"p": " pad"})], [_obj("Pod", " padded", "d"),
                               _obj("Pod", "padded", "d")], [" padded"]),
    "trim_cutset_at_sign": ("""
package k8stest
violation[{"msg": "prefix"}] {
  startswith(input.review.object.metadata.name, trim(input.parameters.p, "@"))
}
""", [("c", {"p": "@core@"})], [_obj("Pod", "core-x", "d"),
                                 _obj("Pod", "other", "d")], ["core-x"]),
    "computed_key_bracket": ("""
package k8stest
violation[{"msg": "bad value"}] {
  spec := input.parameters.entries[_]
  val := input.review.object.metadata.labels[spec.key]
  val != spec.want
}
""", [("c", {"entries": [{"key": "env", "want": "prod"}]})], [
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": "ok", "labels": {"env": "prod", "x": "y"}}},
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": "wrong", "labels": {"env": "dev"}}},
        {"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": "absent", "labels": {"x": "y"}}},
    ], ["wrong"]),
    "parameterless_every_constraint": ("""
package k8stest
violation[{"msg": "no owner"}] {
  not input.review.object.metadata.labels.owner
}
""", [("c1", None), ("c2", None)],
        [_obj("Pod", f"p{i}", "d") for i in range(40)], None),
}

AUTOREJECT_REGO = """
package k8stest
violation[{"msg": "always"}] { input.review.object.metadata.name }
"""
AUTOREJECT_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sTest", "metadata": {"name": "c"},
    "spec": {"match": {"namespaceSelector": {
        "matchLabels": {"team": "a"}}}},
}
AUTOREJECT_NS = {"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": "n", "labels": {"team": "a"}}}

PARAM_CACHE_REGO_A = """
package k8stest
violation[{"msg": "a"}] {
  c := input.review.object.spec.containers[_]
  startswith(c.image, input.parameters.prefix)
}
"""
PARAM_CACHE_REGO_B = """
package k8stest
violation[{"msg": "b"}] {
  input.review.object.metadata.name == input.parameters.name
}
"""
PARAM_CACHE_OBJS = [
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": "p1", "namespace": "d"},
     "spec": {"containers": [{"image": "evil/x"}]}},
    {"apiVersion": "v1", "kind": "Pod",
     "metadata": {"name": "p2", "namespace": "d"},
     "spec": {"containers": [{"image": "good/x"}]}},
]

DEMOTION_REGO = """
package k8stest
violation[{"msg": "m"}] {
  input.review.object.metadata.name == input.parameters.name
}
"""


def containerlimits_pods(n: int = 30) -> list:
    """test_vocab_stabilizes_across_audits' pods."""
    return [{"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"p{i}", "namespace": "d"},
             "spec": {"containers": [{
                 "name": "m", "image": "img",
                 "resources": {"limits": {
                     "cpu": f"{100 + i}m",
                     "memory": f"{i + 1}Gi"}}}]}}
            for i in range(n)]


def warm_namespaces(n: int = 600) -> list:
    """test_async_warm_serves_host_then_hot_swaps' Namespaces."""
    out = []
    for i in range(n):
        o = {"apiVersion": "v1", "kind": "Namespace",
             "metadata": {"name": f"ns{i:04d}"}}
        if i % 2 == 0:
            o["metadata"]["labels"] = {"owner": "me"}
        out.append(o)
    return out


# --------------------------------------------------------- test_ir_compile

WEIRD_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8sweird"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "K8sWeird"}}},
        "targets": [{"target": TARGET, "rego": """
package k8sweird
violation[{"msg": "weird"}] {
  c := count(deny) with input as {"x": 1}
  c >= 0
  input.review.object.metadata.name == "target-me"
}
deny[m] { input.x > 0; m := "d" }
"""}],
    },
}


def _bignum(kind: str, name: str, body: str) -> dict:
    return {"apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate", "metadata": {"name": name},
            "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                     "targets": [{"target": TARGET, "rego": body}]}}


BIGNUM_TEMPLATE = _bignum("BigNum", "bignum", """
package bignum
violation[{"msg": msg}] {
  provided := input.review.object.spec.replicas
  maximum := input.parameters.max
  provided > maximum
  msg := "too many replicas"
}
""")
NEGATED_BIGNUM_TEMPLATE = _bignum("BigNumNeg", "bignumneg", """
package bignumneg
violation[{"msg": msg}] {
  provided := input.review.object.spec.replicas
  maximum := input.parameters.max
  not provided < maximum
  msg := "not under the limit"
}
""")


def _deploy(name: str, replicas: int) -> dict:
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": replicas}}


# name -> (template, constraint max, objects): the three float32 ties
F32_TIES = {
    "tie_does_not_underfire": (BIGNUM_TEMPLATE, 16777216, [
        _deploy("over", 16777217), _deploy("at-limit", 16777216),
        _deploy("under", 3)]),
    "tie_under_negation": (NEGATED_BIGNUM_TEMPLATE, 16777217, [
        _deploy("tie-under", 16777216), _deploy("over", 16777218),
        _deploy("under", 3)]),
    "tie_negated_exact_violation": (NEGATED_BIGNUM_TEMPLATE, 16777216, [
        _deploy("at-tie", 16777217)]),
}


def f32_constraint(template: dict, mx: int) -> dict:
    kind = template["spec"]["crd"]["spec"]["names"]["kind"]
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": "c1"},
            "spec": {"parameters": {"max": mx}}}


# ------------------------------------------------------------ test_ir_join

def ingress(name, ns, hosts, group="networking.k8s.io"):
    return {"apiVersion": f"{group}/v1", "kind": "Ingress",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"rules": [{"host": h} for h in hosts]}}


def service(name, ns, sel):
    return {"apiVersion": "v1", "kind": "Service",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"selector": sel}}


JOIN_OBJS = [
    ingress("a", "ns1", ["x.com", "y.com"]),
    ingress("b", "ns2", ["x.com"]),           # conflicts with a
    ingress("c", "ns3", ["unique.com"]),      # no conflict
    ingress("d", "ns3", ["y.com", "z.com"]),  # conflicts with a on y.com
    service("s1", "ns1", {"app": "web", "tier": "fe"}),
    service("s2", "ns2", {"tier": "fe", "app": "web"}),  # same flattened
    service("s3", "ns2", {"app": "db"}),
    service("s4", "ns1", {}),
]

JOIN_REVIEWS = [
    ingress("new", "ns9", ["x.com"]),          # CREATE conflicting
    ingress("c", "ns3", ["unique.com"]),       # UPDATE: own copy only
    ingress("c", "ns3", ["x.com"]),            # UPDATE into a conflict
    service("snew", "ns5", {"tier": "fe", "app": "web"}),
    service("s3", "ns2", {"app": "db"}),       # own copy only
]

JOIN_KINDS = (("general/uniqueingresshost", "K8sUniqueIngressHost",
               "unique-hosts"),
              ("general/uniqueserviceselector", "K8sUniqueServiceSelector",
               "unique-selectors"))


def join_device_objects() -> list:
    """test_join_device_path_matches_host_path's 64 Ingresses."""
    return [ingress(f"i{i}", f"ns{i % 8}", [f"h{i % 24}.com", f"only{i}.com"])
            for i in range(64)]
