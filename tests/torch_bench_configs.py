"""BENCH configs 10, 1 and 12 (bench_configs.py config10, config1 and
config12), for chip_smoke.py's phases 21 and 22, tests/test_torch_scale.py,
tests/test_torch_compile_coverage.py and tests/torch_reference_counts.py.

Config 10 is the flagship template with C10_CONSTRAINTS
synth_constraints(seed=1) over synth_objects(C10_OBJECTS,
C10_VIOLATE_FRAC, seed=0), on one device and over the default mesh.
Config 1 is general/requiredlabels with one allowedRegex constraint
(C1_CONSTRAINT, a copy of the one in bench_configs.config1, which
`bench_constraint` reads from that file's text) over
synth_objects(C1_OBJECTS, C1_VIOLATE_FRAC, seed=7). Config 12 is the
extended-form corpus (EXTENDED_FORM_TEMPLATES), each kind alone over
c12_dense_objects or c12_join_objects. Beside them: an audit's count
per constraint and a digest of its results. Imports
neither jax nor the JAX package, so that the card's smoke can use it.
Not a test module (pytest does not collect it).
"""

from __future__ import annotations

import ast
import hashlib
import os

C10_OBJECTS = 1_000_000
C10_CONSTRAINTS = 100
C10_VIOLATE_FRAC = 0.002
C1_OBJECTS = 1000
C1_VIOLATE_FRAC = 0.02
C1_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels", "metadata": {"name": "must-own"},
    "spec": {"parameters": {"labels": [
        {"key": "owner", "allowedRegex": "^[a-z]+.corp.example$"}]}},
}

BENCH_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_configs.py")


def bench_constraint(config: str) -> dict:
    """The literal dict that bench_configs.py's function `config` assigns
    to `constraint`, read from the file's text (nothing is imported)."""
    with open(BENCH_CONFIGS) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == config)
    return next(ast.literal_eval(n.value) for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and
                [t.id for t in n.targets if isinstance(t, ast.Name)] ==
                ["constraint"])


def per_constraint_counts(results, constraints) -> list[int]:
    """Each constraint's result count, in the order of `constraints`
    (one template's: matched by name)."""
    at = {c["metadata"]["name"]: k for k, c in enumerate(constraints)}
    out = [0] * len(constraints)
    for r in results:
        out[at[r.constraint["metadata"]["name"]]] += 1
    return out


def result_digest(results) -> str:
    """sha256 over an audit's (constraint kind and name, object name,
    message) triples, sorted: equal for equal result sets whatever the
    order a driver emits them in."""
    rows = sorted(
        (r.constraint["kind"], r.constraint["metadata"]["name"],
         ((r.resource or {}).get("metadata") or {}).get("name", ""),
         r.msg)
        for r in results)
    h = hashlib.sha256()
    for row in rows:
        h.update(("\t".join(row) + "\n").encode())
    return h.hexdigest()


# ------------------------------------------------------------ config 12
# BENCH config 12 (bench_configs.py config12): the extended-form corpus,
# each kind audited on its own at C12_DENSE objects (the dense kinds, over
# synth_mixed_objects(seed=12) with every object's team label set but
# each 50th's) or C12_JOIN (the join kinds, over c12_join_objects), a
# warm-up audit then the best of two full sweeps. test_torch_compile_
# coverage.py holds this copy to bench_configs.EXTENDED_FORM_TEMPLATES.

C12_DENSE = 50_000
C12_JOIN = 4_000
C12_SEED = 12
TARGET = "admission.k8s.gatekeeper.sh"


def xtemplate(kind: str, rego: str) -> dict:
    """bench_configs._xtemplate: a ConstraintTemplate of `kind` whose
    one target runs `rego`."""
    return {"apiVersion": "templates.gatekeeper.sh/v1beta1",
            "kind": "ConstraintTemplate",
            "metadata": {"name": kind.lower()},
            "spec": {"crd": {"spec": {"names": {"kind": kind}}},
                     "targets": [{"target": TARGET, "rego": rego}]}}


# (kind, template, constraint parameters or None)
EXTENDED_FORM_TEMPLATES = [
    ("XRequiredLabelKeys", xtemplate("XRequiredLabelKeys", """
package xrequiredlabelkeys

violation[{"msg": msg}] {
  provided := {k | input.review.object.metadata.labels[k]}
  required := {k | input.parameters.labels[k]}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("missing required label keys: %v", [missing])
}
"""), {"labels": {"owner": "", "app": "", "team": ""}}),
    ("XBannedImages", xtemplate("XBannedImages", """
package xbannedimages

violation[{"msg": msg}] {
  images := {c.image | c := input.review.object.spec.containers[_]}
  images[input.parameters.banned]
  msg := sprintf("banned image <%v> in use", [input.parameters.banned])
}
"""), {"banned": "docker.io/evil7:latest"}),
    ("XRootfulPrefixed", xtemplate("XRootfulPrefixed", """
package xrootfulprefixed

violation[{"msg": msg}] {
  bad := {c.name | c := input.review.object.spec.containers[_]; startswith(lower(c.image), input.parameters.prefix); not c.securityContext.runAsNonRoot}
  count(bad) > 0
  msg := sprintf("containers from <%v> must set runAsNonRoot: %v", [input.parameters.prefix, bad])
}
"""), {"prefix": "docker.io/"}),
    ("XUniqueIngressHostCanon", xtemplate("XUniqueIngressHostCanon", """
package xuniqueingresshostcanon

identical(obj, review) {
  obj.metadata.namespace == review.object.metadata.namespace
  obj.metadata.name == review.object.metadata.name
}

violation[{"msg": msg}] {
  input.review.kind.kind == "Ingress"
  re_match("^(extensions|networking.k8s.io)$", input.review.kind.group)
  some ns, apiv, name
  host := input.review.object.spec.rules[_].host
  other := data.inventory.namespace[ns][apiv]["Ingress"][name]
  re_match("^(extensions|networking.k8s.io)/.+$", apiv)
  other.spec.rules[_].host == host
  not identical(other, input.review)
  msg := sprintf("ingress host conflicts with an existing ingress <%v>", [host])
}
"""), None),
    ("XUniqueSelectorInline", xtemplate("XUniqueSelectorInline", """
package xuniqueselectorinline

violation[{"msg": msg}] {
  input.review.kind.kind == "Service"
  sel := input.review.object.spec.selector
  data.inventory.namespace[ns][_]["Service"][name].spec.selector == sel
  name != input.review.object.metadata.name
  msg := sprintf("same selector as service <%v>", [name])
}
"""), None),
]


def c12_is_join(kind: str) -> bool:
    """config12's split: the XUnique* kinds read the inventory."""
    return kind.startswith("XUnique")


def c12_constraint(kind: str, params) -> dict:
    """config12's one constraint of `kind`."""
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": kind.lower()},
            "spec": ({"parameters": params} if params else {})}


def c12_dense_objects(n: int = C12_DENSE, synth_mixed_objects=None) -> list:
    """config12's dense inventory: synth_mixed_objects(n, seed=12), every
    object but each 50th labelled team=core. `synth_mixed_objects` is
    either package's generator (default: the port's)."""
    if synth_mixed_objects is None:
        from gatekeeper_tpu_torch.parallel.workload import \
            synth_mixed_objects
    objs = synth_mixed_objects(n, seed=C12_SEED)
    for i, o in enumerate(objs):
        if i % 50:
            o["metadata"]["labels"]["team"] = "core"
    return objs


def c12_join_objects(n: int = C12_JOIN) -> list:
    """config12's join inventory: Ingresses (odd i) with unique hosts but
    a colliding dup{i % 10} tail, and Services (even i) with unique
    selectors but a colliding dupapp{i % 10} tail, over 9 namespaces."""
    out = []
    for i in range(n):
        if i % 2:
            host = (f"dup{i % 10}.corp.example" if i % 50 == 1
                    else f"h{i}.corp.example")
            out.append({
                "apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
                "metadata": {"name": f"ing-{i}", "namespace": f"ns{i % 9}"},
                "spec": {"rules": [{"host": host}]}})
        else:
            sel = ({"app": f"dupapp{i % 10}"} if i % 50 == 0
                   else {"app": f"app{i}"})
            out.append({
                "apiVersion": "v1", "kind": "Service",
                "metadata": {"name": f"svc-{i}", "namespace": f"ns{i % 9}"},
                "spec": {"selector": sel}})
    return out
