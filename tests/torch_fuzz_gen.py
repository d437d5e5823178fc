"""The reference's randomized generators, for the port's fuzz tests.

Copies of the generators of tests/test_differential_fuzz.py (`CONSTRAINTS`,
`_rand_value`, `_container`, `_rand_object`: structured-random Kubernetes
objects with missing, empty, wrong-typed, unicode and huge fields) and of
tests/test_codegen_fuzz.py (`FIELDS`, `Gen`, `DevGen`, `rand_value`,
`rand_input`: random Rego modules and their inputs), draw for draw the
same, so that a seed gives the same objects and module sources here as
there. Both reference files import the JAX package at module level; this
one imports neither jax nor the JAX package, so that the card's tests
(where jax is not installed) can draw the same cases.
tests/test_torch_fuzz.py holds this copy to the reference's generators.

Beside the copies: `fuzz_client` (the reference's `_client` over a
package's Backend, target and policies), `norm` (its `_norm`), `mutate`
(one step of its churn loop), `template_case` and `template_audit` (one
case of its random-template loop), and `pin` and `device_kinds` (a
compiled driver pinned to its device path, and the kinds it served
there). Not a test module (pytest does not collect it).
"""

from __future__ import annotations

import random

# ------------------------------------ tests/test_differential_fuzz.py

CONSTRAINTS = [
    ("K8sAllowedRepos", {"repos": ["good.example/", "ok.example/"]}),
    ("K8sContainerLimits", {"cpu": "500m", "memory": "1Gi"}),
    ("K8sContainerRatios", {"ratio": "2"}),
    ("K8sHttpsOnly", None),
    ("K8sRequiredLabels", {"labels": [
        {"key": "owner", "allowedRegex": "^[a-z]+$"}, {"key": "team"}]}),
    ("K8sUniqueIngressHost", None),
    ("K8sUniqueServiceSelector", None),
    ("K8sPSPAllowPrivilegeEscalationContainer", None),
    ("K8sPSPAppArmor", {"allowedProfiles": ["runtime/default"]}),
    ("K8sPSPCapabilities", {"allowedCapabilities": ["NET_BIND_SERVICE"],
                            "requiredDropCapabilities": ["ALL"]}),
    ("K8sPSPForbiddenSysctls", {"forbiddenSysctls": ["kernel.*"]}),
    ("K8sPSPHostFilesystem", {"allowedHostPaths": [
        {"pathPrefix": "/var/log", "readOnly": True}]}),
    ("K8sPSPHostNamespace", None),
    ("K8sPSPHostNetworkingPorts", {"hostNetwork": False,
                                   "min": 8000, "max": 9000}),
    ("K8sPSPPrivilegedContainer", None),
    ("K8sPSPReadOnlyRootFilesystem", None),
    ("K8sPSPSeccomp", {"allowedProfiles": ["runtime/default"]}),
    ("K8sPSPAllowedUsers", {"runAsUser": {"rule": "MustRunAsNonRoot"}}),
    ("K8sPSPVolumeTypes", {"volumes": ["configMap", "secret"]}),
]

_STRS = ["", "a", "owner", "good.example/app:v1", "bad.example/app",
         "runtime/default", "unconfined", "Ü-nicode-✓", "x" * 300,
         "NET_BIND_SERVICE", "SYS_ADMIN", "kernel.msgmax", "net.core.x",
         "/var/log/app", "/etc/shadow", "500m", "2Gi", "4", "0", "-1",
         "host.example", "ALL"]


def _rand_value(rng: random.Random, depth: int = 0):
    roll = rng.random()
    if depth > 2 or roll < 0.45:
        return rng.choice(_STRS + [0, 1, 1000, True, False, None,
                                   0.5, 4096])
    if roll < 0.65:
        return [_rand_value(rng, depth + 1)
                for _ in range(rng.randrange(3))]
    return {rng.choice(_STRS[:8] or ["k"]) or "k":
            _rand_value(rng, depth + 1) for _ in range(rng.randrange(3))}


def _container(rng: random.Random) -> dict:
    c = {"name": rng.choice(["main", "side", "opa"]),
         "image": rng.choice(_STRS[3:6] + ["good.example/x:1"])}
    if rng.random() < 0.7:
        c["resources"] = {k: {"cpu": rng.choice(["100m", "1", "abc", 2]),
                              "memory": rng.choice(["1Gi", "10Mi", ""])}
                          for k in rng.sample(["limits", "requests"],
                                              rng.randrange(1, 3))}
    if rng.random() < 0.7:
        sc = {}
        for key, vals in (("privileged", [True, False, "yes"]),
                          ("allowPrivilegeEscalation", [True, False]),
                          ("readOnlyRootFilesystem", [True, False, None]),
                          ("runAsUser", [0, 1000, -5, "root"])):
            if rng.random() < 0.5:
                sc[key] = rng.choice(vals)
        if rng.random() < 0.5:
            sc["capabilities"] = {
                k: rng.sample(["ALL", "SYS_ADMIN", "NET_BIND_SERVICE"],
                              rng.randrange(3))
                for k in rng.sample(["add", "drop"], rng.randrange(1, 3))}
        c["securityContext"] = sc
    if rng.random() < 0.3:
        c["ports"] = [{"hostPort": rng.choice([80, 8080, 8500, 9999])}]
    if rng.random() < 0.15:
        c[rng.choice(_STRS[:8]) or "extra"] = _rand_value(rng)
    return c


def _rand_object(rng: random.Random, i: int) -> dict:
    kind = rng.choice(["Pod", "Namespace", "Service", "Ingress"])
    meta = {"name": f"obj-{i}"}
    if kind != "Namespace":
        meta["namespace"] = rng.choice(["default", "prod", "kube-system"])
    if rng.random() < 0.8:
        meta["labels"] = {k: rng.choice(_STRS)
                          for k in rng.sample(["owner", "team", "app",
                                               "env"], rng.randrange(4))}
    if rng.random() < 0.5:
        meta["annotations"] = {
            rng.choice([
                "container.apparmor.security.beta.kubernetes.io/main",
                "seccomp.security.alpha.kubernetes.io/pod",
                "kubernetes.io/ingress.allow-http", "x"]):
            rng.choice(["runtime/default", "unconfined", "false", "true"])}
    obj = {"apiVersion": {"Pod": "v1", "Namespace": "v1", "Service": "v1",
                          "Ingress": "networking.k8s.io/v1"}[kind],
           "kind": kind, "metadata": meta}
    if kind == "Pod":
        spec = {"containers": [_container(rng)
                               for _ in range(rng.randrange(1, 3))]}
        if rng.random() < 0.4:
            spec["securityContext"] = {
                "sysctls": [{"name": rng.choice(["kernel.msgmax",
                                                 "net.core.x"]),
                             "value": "1"}]}
        if rng.random() < 0.3:
            spec["hostNetwork"] = rng.choice([True, False])
        if rng.random() < 0.3:
            spec["volumes"] = [
                {"name": "v",
                 **rng.choice([{"configMap": {"name": "c"}},
                               {"hostPath": {"path": "/var/log/x"}},
                               {"hostPath": {"path": "/etc"}},
                               {"emptyDir": {}}])}]
        obj["spec"] = spec
    elif kind == "Service":
        obj["spec"] = {"selector": {k: rng.choice(_STRS[:6])
                                    for k in rng.sample(["app", "tier"],
                                                        rng.randrange(3))},
                       "ports": [{"port": 80}]}
    elif kind == "Ingress":
        obj["spec"] = {"rules": [{"host": rng.choice(
            ["a.example", "b.example", "a.example"])}
            for _ in range(rng.randrange(1, 3))]}
        if rng.random() < 0.4:
            obj["spec"]["tls"] = [{"hosts": ["a.example"]}]
    elif rng.random() < 0.1:
        obj["spec"] = _rand_value(rng)
    return obj


def pin(drv):
    """The device path forced in a compiled driver (either package's):
    the cost model and the async warm can neither route a sweep to the
    host."""
    drv._dev_batch_lat_s = 1e-4
    drv._use_device_for_batch = lambda n: True
    drv.async_warm = False
    return drv


def device_kinds(drv) -> set:
    """Kinds a compiled driver served on its device path (TpuDriver keeps
    the counts that TorchDriver.eval_counts() returns in _eval_counts)."""
    counts = drv.eval_counts() if hasattr(drv, "eval_counts") else \
        dict(drv._eval_counts)
    return {k for (k, path), n in counts.items() if path == "device" and n}


def fuzz_client(backend, target, policies, driver):
    """The reference's `_client`: every shipped template and the
    CONSTRAINTS over them, on `driver`, through a package's Backend,
    target class and policies module."""
    client = backend(driver).new_client([target()])
    for name in policies.names():
        client.add_template(policies.load(name))
    for kind, params in CONSTRAINTS:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": kind.lower()},
            "spec": ({"parameters": params} if params else {}),
        })
    return client


def norm(results):
    """The reference's `_norm` over a response's results: sorted
    (message, constraint name, resource name)."""
    return sorted(
        (r.msg, r.constraint["metadata"]["name"],
         (r.resource or {}).get("metadata", {}).get("name", ""))
        for r in results)


def mutate(rng: random.Random, live: list, step: int) -> tuple:
    """One step of the reference's churn loop (test_fuzz_mutation_parity)
    on `live`, drawn as it draws: ("add", obj) for a replacement under
    the same coordinates or an insert, ("remove", obj) for a delete."""
    roll = rng.random()
    if roll < 0.6 and live:
        victim = rng.choice(live)
        mutant = _rand_object(rng, 0)
        mutant["apiVersion"] = victim["apiVersion"]
        mutant["kind"] = victim["kind"]
        mutant["metadata"]["name"] = victim["metadata"]["name"]
        if "namespace" in victim["metadata"]:
            mutant["metadata"]["namespace"] = \
                victim["metadata"]["namespace"]
        else:
            mutant["metadata"].pop("namespace", None)
        live[live.index(victim)] = mutant
        return "add", mutant
    if roll < 0.8:
        new = _rand_object(rng, 1000 + step)
        live.append(new)
        return "add", new
    if live:
        return "remove", live.pop(rng.randrange(len(live)))
    return None, None


# ------------------------------------------ tests/test_codegen_fuzz.py

FIELDS = ["a", "b", "c", "key", "name", "labels", "items"]
STRS = ['"x"', '"y"', '"zz"', '""']
NUMS = ["0", "1", "2", "10"]


class Gen:
    def __init__(self, rng):
        self.r = rng
        self.n = 0

    def var(self):
        self.n += 1
        return f"v{self.n}"

    def path(self, root):
        segs = ".".join(self.r.choices(FIELDS,
                                       k=self.r.randint(1, 3)))
        return f"{root}.{segs}"

    def scalar(self):
        return self.r.choice(STRS + NUMS)

    def body(self, depth=0):
        lits = []
        bound = []
        root1 = self.r.choice(["input.review", "input.parameters"])
        # a generator over a dict/array with a key var
        k, v = self.var(), self.var()
        lits.append(f"{v} := {self.path(root1)}[{k}]")
        bound += [k, v]
        if self.r.random() < 0.7:
            # second generator over the OTHER section (join shape)
            root2 = ("input.parameters" if root1 == "input.review"
                     else "input.review")
            e = self.var()
            lits.append(f"{e} := {self.path(root2)}[_]")
            bound.append(e)
            if self.r.random() < 0.8:
                # pinning equality: the join-reorder trigger
                lits.append(f"{e}.{self.r.choice(FIELDS)} == {k}")
        if self.r.random() < 0.5:
            lits.append(f"{v} != {self.scalar()}")
        if self.r.random() < 0.4:
            lits.append(
                f"not {self.r.choice(bound)} == {self.scalar()}")
        if self.r.random() < 0.5:
            c = self.var()
            src = self.r.choice(["input.review", "input.parameters"])
            lits.append(f"{c} := {{ x | x := {self.path(src)}[_] }}")
            lits.append(f"count({c}) >= {self.r.choice(NUMS)}")
            bound.append(c)
        if self.r.random() < 0.4:
            lits.append(f"startswith({v}, {self.r.choice(STRS)})")
        if self.r.random() < 0.35:
            # builtins over arbitrary-typed bound values: most raise on
            # non-string/number inputs, and the literal going undefined
            # identically in the interpreter and the codegen is the
            # contract worth fuzzing
            lits.append(self.r.choice([
                f'glob.quote_meta({v}) != ""',
                f"time.parse_duration_ns({v}) >= 0",
                f'net.cidr_contains("10.0.0.0/8", {v})',
                f'regex.globs_match({v}, "a*")',
                f'regex.template_match("u:{{.*}}", {v}, "{{", "}}")',
                f"lt({v}, 5)",
                f"rem(to_number({v}), 3) == 0",
                f"not gte({v}, 100)",
            ]))
        m = self.var()
        w = self.r.sample(bound, min(len(bound), 2))
        fmt = "%v-" * len(w)
        lits.append(f'{m} := sprintf("{fmt}", [{", ".join(w)}])')
        return lits, m

    def module(self):
        rules = []
        for i in range(self.r.randint(1, 3)):
            lits, m = self.body()
            body = "\n  ".join(lits)
            rules.append(
                f'violation[{{"msg": {m}, "n": {i}}}] {{\n  {body}\n}}')
        return "package fz\n\n" + "\n\n".join(rules)


def rand_value(rng, depth=0):
    roll = rng.random()
    if depth >= 2 or roll < 0.4:
        return rng.choice(["x", "y", "zz", "", 0, 1, 2, 10, True, None])
    if roll < 0.65:
        return [rand_value(rng, depth + 1) for _ in range(rng.randint(0, 3))]
    return {rng.choice(FIELDS): rand_value(rng, depth + 1)
            for _ in range(rng.randint(0, 3))}


def rand_input(rng):
    return {
        "review": {rng.choice(FIELDS): rand_value(rng)
                   for _ in range(rng.randint(0, 4))},
        "parameters": {rng.choice(FIELDS): rand_value(rng)
                       for _ in range(rng.randint(0, 4))},
    }


class DevGen(Gen):
    """Variant biased toward the device compiler's subset: review paths
    rooted at object.*, parameter lists, string predicates."""

    def path(self, root):
        if root == "input.review":
            root = "input.review.object"
        segs = ".".join(self.r.choices(FIELDS, k=self.r.randint(1, 2)))
        return f"{root}.{segs}"


def template_case(rng: random.Random) -> tuple:
    """One case of the reference's random-template loop
    (test_device_compiler_parity_on_random_templates), drawn as it
    draws: (rego source, the ConstraintTemplate TFz, the constraint's
    parameters, 25 Pods)."""
    body = DevGen(rng).module().replace("package fz", "package tfz")
    tpl = {"apiVersion": "templates.gatekeeper.sh/v1beta1",
           "kind": "ConstraintTemplate",
           "metadata": {"name": "tfz"},
           "spec": {"crd": {"spec": {"names": {"kind": "TFz"}}},
                    "targets": [{
                        "target": "admission.k8s.gatekeeper.sh",
                        "rego": body}]}}
    params = {rng.choice(FIELDS): rand_value(rng)
              for _ in range(rng.randint(0, 3))}
    objs = []
    for i in range(25):
        o = {"apiVersion": "v1", "kind": "Pod",
             "metadata": {"name": f"o{i}", "namespace": "d"}}
        for f in rng.sample(FIELDS, rng.randint(0, 4)):
            o[f] = rand_value(rng)
        objs.append(o)
    return body, tpl, params, objs


def template_audit(backend, target, driver, tpl, params, objs):
    """The case's audit on `driver`: sorted (message, resource name), or
    None when the template does not ingest (the reference skips such a
    case)."""
    c = backend(driver).new_client([target()])
    try:
        c.add_template(tpl)
    except Exception:
        return None
    c.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "TFz", "metadata": {"name": "t"},
        "spec": {"parameters": params}})
    for o in objs:
        c.add_data(o)
    return sorted(
        (r.msg, (r.resource or {}).get("metadata", {}).get("name", ""))
        for r in c.audit().results())
