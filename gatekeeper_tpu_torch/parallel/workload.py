"""Synthetic audit workloads for benchmarks and multi-chip dry-runs.

Builds the flagship evaluation setup — the K8sRequiredLabels program (the
reference's canonical template, library/general/requiredlabels) compiled to
the tensor IR, with N synthetic namespace objects and C constraints — and
returns everything needed to run the device sweep directly. Mirrors
BASELINE.md configs #1 (1k objects) and #4 (500 × 100k cross-product).
"""

from __future__ import annotations

import random

REQUIRED_LABELS_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "k8srequiredlabels"},
    "spec": {
        "crd": {"spec": {
            "names": {"kind": "K8sRequiredLabels"},
            "validation": {"openAPIV3Schema": {"properties": {
                "message": {"type": "string"},
                "labels": {"type": "array", "items": {
                    "type": "object", "properties": {
                        "key": {"type": "string"},
                        "allowedRegex": {"type": "string"}}}},
            }}},
        }},
        "targets": [{
            "target": "admission.k8s.gatekeeper.sh",
            # independently authored; behaviorally equivalent to the
            # reference template (library/general/requiredlabels/src.rego)
            "rego": """
package k8srequiredlabels

violation[{"msg": msg, "details": {"missing_labels": missing}}] {
  provided := {label | input.review.object.metadata.labels[label]}
  required := {label | label := input.parameters.labels[_].key}
  missing := required - provided
  count(missing) > 0
  msg := sprintf("you must provide labels: %v", [missing])
}

violation[{"msg": msg}] {
  value := input.review.object.metadata.labels[key]
  expected := input.parameters.labels[_]
  expected.key == key
  expected.allowedRegex != ""
  not re_match(expected.allowedRegex, value)
  msg := sprintf("label <%v: %v> does not match the allowed regex %v", [key, value, expected.allowedRegex])
}
""",
        }],
    },
}

# per-key value pools, consistent with the regexes constraints use — a
# healthy cluster where violations are the exception (audit's normal case)
LABEL_POOL = {
    "owner": (["alpha.corp.example", "beta.corp.example"],
              "^[a-z]+.corp.example$"),
    "team": (["payments", "identity", "infra"], "^[a-z]+$"),
    "env": (["prod", "dev"], "^prod$|^dev$"),
    "tier": (["frontend", "backend"], "^[a-z]+$"),
    "region": (["us-east1", "us-west1"], "^us-"),
    "app": (["shop", "ledger"], "^[a-z0-9-]+$"),
    "cost-center": (["cc-100", "cc-200"], "^cc-[0-9]+$"),
    "compliance": (["pci", "sox"], "^[a-z]+$"),
    "zone": (["a", "b"], "^[ab]$"),
    "dept": (["eng", "ops"], "^[a-z]+$"),
}
LABEL_KEYS = list(LABEL_POOL)


def synth_objects(n: int, violate_frac: float = 0.01, seed: int = 0):
    """N namespace objects carrying the full label pool; ~violate_frac of
    them break one label (missing or regex-violating)."""
    rng = random.Random(seed)
    objs = []
    for i in range(n):
        labels = {k: rng.choice(vals) for k, (vals, _) in LABEL_POOL.items()}
        if rng.random() < violate_frac:
            k = rng.choice(LABEL_KEYS)
            if rng.random() < 0.5:
                labels.pop(k)
            else:
                labels[k] = "###BAD###"
        objs.append({
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": f"ns-{i}", "labels": labels},
        })
    return objs


def synth_constraints(c: int, seed: int = 1):
    """C requiredlabels constraints drawing keys+regexes from the pool."""
    rng = random.Random(seed)
    out = []
    for i in range(c):
        labels = []
        for k in rng.sample(LABEL_KEYS, rng.randint(1, 3)):
            entry = {"key": k}
            if rng.random() < 0.6:
                entry["allowedRegex"] = LABEL_POOL[k][1]
            labels.append(entry)
        out.append({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sRequiredLabels",
            "metadata": {"name": f"req-{i}"},
            "spec": {"parameters": {"labels": labels}},
        })
    return out


def build_eval_setup(n_objects: int, n_constraints: int, seed: int = 0,
                     n_bucket: int | None = None,
                     violate_frac: float = 0.01, device: str = "cuda"):
    """-> (driver, compiled_template, feats, params, match_table, derived,
    reviews, constraints). Host numpy arrays; the driver evaluates on
    `device`."""
    from ..client import Backend
    from ..ir import TorchDriver
    from ..ir.features import extract_batch
    from ..ir.params import encode_params
    from ..target import K8sValidationTarget

    driver = TorchDriver(device=device)
    client = Backend(driver).new_client([K8sValidationTarget()])
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    constraints = synth_constraints(n_constraints, seed + 1)
    for c in constraints:
        client.add_constraint(c)
    ct = driver.compiled_for("K8sRequiredLabels")
    assert ct is not None, "flagship template must compile"
    objects = synth_objects(n_objects, violate_frac=violate_frac, seed=seed)
    reviews = [{"kind": {"group": "", "version": "v1", "kind": "Namespace"},
                "name": o["metadata"]["name"], "object": o}
               for o in objects]
    feats, _, _ = extract_batch(ct.program, driver.strtab, reviews,
                                n_bucket=n_bucket)
    cons = driver._constraints("admission.k8s.gatekeeper.sh")
    pd = [(x.get("spec") or {}).get("parameters") or {} for x in cons]
    params = encode_params(ct.program, pd, driver.strtab, driver.match_tables)
    # derived columns + match table materialize AFTER extraction/encoding
    # interned this batch's strings (driver._derived_arrays ordering
    # contract)
    derived = driver._derived_arrays("K8sRequiredLabels", ct)
    table = driver.match_tables.materialize_packed()
    return driver, ct, feats, params, table, derived, reviews, cons


# mixed general-library workload (BASELINE.md config #2) and the shipped
# libraries' constraint sets, as the repo's bench_configs.py defines them


def synth_mixed_objects(n: int, seed: int = 0) -> list[dict]:
    """Pods/Deployments/Ingresses/Services with fields the general
    library examines (images, limits/requests, labels, tls/hosts,
    selectors). ~2% violate something."""
    rng = random.Random(seed)
    repos = ["registry.corp.example/", "gcr.io/corp/"]
    out = []
    for i in range(n):
        kind = ("Pod", "Pod", "Pod", "Deployment", "Ingress",
                "Service")[i % 6]
        name = f"{kind.lower()}-{i}"
        labels = {"owner": "team.corp.example", "app": f"app{i % 50}"}
        bad = rng.random() < 0.02
        if kind == "Pod":
            image = (rng.choice(repos) + f"svc{i % 20}:v1"
                     if not bad else f"docker.io/evil{i}:latest")
            cpu = "900m" if not bad else "4"
            out.append({
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": name, "namespace": f"ns{i % 20}",
                             "labels": labels},
                "spec": {"containers": [{
                    "name": "main", "image": image,
                    "resources": {
                        "limits": {"cpu": cpu, "memory": "512Mi"},
                        "requests": {"cpu": "250m", "memory": "256Mi"}},
                }]},
            })
        elif kind == "Deployment":
            out.append({
                "apiVersion": "apps/v1", "kind": "Deployment",
                "metadata": {"name": name, "namespace": f"ns{i % 20}",
                             "labels": labels},
                "spec": {"replicas": 2,
                         "selector": {"matchLabels": {"app": f"app{i}"}}},
            })
        elif kind == "Ingress":
            spec = {"rules": [{"host": f"h{i}.corp.example"}]}
            meta = {"name": name, "namespace": f"ns{i % 20}",
                    "labels": labels}
            if not bad:
                spec["tls"] = [{"hosts": [f"h{i}.corp.example"]}]
                meta["annotations"] = {
                    "kubernetes.io/ingress.allow-http": "false"}
            out.append({"apiVersion": "networking.k8s.io/v1beta1",
                        "kind": "Ingress", "metadata": meta, "spec": spec})
        else:
            out.append({
                "apiVersion": "v1", "kind": "Service",
                "metadata": {"name": name, "namespace": f"ns{i % 20}",
                             "labels": labels},
                "spec": {"selector": {"app": f"app{i}"},
                         "ports": [{"port": 80}]},
            })
    return out


def synth_pods_psp(n: int, seed: int = 0) -> list[dict]:
    """Pod specs exercising the PSP library's fields; ~3% violate."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        bad = rng.random() < 0.03
        ctx = {"allowPrivilegeEscalation": False,
               "readOnlyRootFilesystem": True,
               "runAsUser": 1000 + (i % 1000),
               "capabilities": {"drop": ["ALL"]}}
        if bad:
            kind_of_bad = rng.randrange(5)
            if kind_of_bad == 0:
                ctx["privileged"] = True
            elif kind_of_bad == 1:
                ctx["runAsUser"] = 0
            elif kind_of_bad == 2:
                ctx["capabilities"] = {"add": ["SYS_ADMIN"], "drop": []}
            elif kind_of_bad == 3:
                ctx.pop("readOnlyRootFilesystem")
            else:
                ctx["allowPrivilegeEscalation"] = True
        pod = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {
                "name": f"pod-{i}", "namespace": f"ns{i % 40}",
                "annotations": {
                    "seccomp.security.alpha.kubernetes.io/pod":
                        "runtime/default",
                    "container.apparmor.security.beta.kubernetes.io/main":
                        "runtime/default",
                },
            },
            "spec": {
                "securityContext": {"fsGroup": 2000,
                                    "sysctls": ([{"name": "net.ipv4.ip_local_port_range", "value": "1024 65535"}]
                                                if i % 7 else [{"name": "kernel.msgmax", "value": "1"}])},
                "containers": [{
                    "name": "main",
                    "image": f"registry.corp.example/app{i % 100}:v1",
                    "securityContext": ctx,
                    "ports": ([{"hostPort": 8080 + (i % 100)}]
                              if i % 11 == 0 else []),
                }],
                "volumes": [{"name": "cfg", "configMap": {"name": "c"}}] +
                           ([{"name": "h", "hostPath":
                              {"path": f"/var/log/app{i}"}}]
                            if i % 13 == 0 else []),
            },
        }
        out.append(pod)
    return out


def churn_pods(pods: list[dict], rng: random.Random, round_: int,
               count: int) -> list[dict]:
    """One churn round of BENCH config 6 (bench_configs.py config6's
    `mutate`): `count` pods drawn by `rng`, each a deep copy with a
    churned label value (a string the vocabulary has not seen) and its
    structure unchanged, ready to be re-added in place."""
    import copy

    out = []
    for i in rng.sample(range(len(pods)), count):
        pod = copy.deepcopy(pods[i])
        pod["metadata"].setdefault("labels", {})["churn"] = \
            f"r{round_}-{i}"
        out.append(pod)
    return out


# BENCH config 6's audits as the port's churn checks run them: (step,
# churn round or None, edit), the edit being host-ports' new max or
# "drop" for a full re-encode (drop_inventory_caches). Each edit round
# follows its last full sweep by one churn round: the patch journal keeps
# at most 1,024 notes (client/drivers.py _note_inventory_write), so an
# edit more than 1,024 writes after the last full sweep re-extracts
# instead of patching; the three churn rounds come last, delta-served.
CHURN_STEPS = (("first", None, None), ("steady", None, None),
               ("E1", 0, 8100), ("re-encode", None, "drop"),
               ("E2", 1, 9000), ("churn 2", 2, None), ("churn 3", 3, None),
               ("churn 4", 4, None))

def churn_step(client, driver, pods: list[dict], rng: random.Random,
               count: int, round_, edit) -> None:
    """Apply one CHURN_STEPS entry's writes through `client`: a churn
    round of `count` pods, then the host-ports edit or the re-encode."""
    if round_ is not None:
        for pod in churn_pods(pods, rng, round_, count):
            client.add_data(pod)
    if edit == "drop":
        driver.drop_inventory_caches()
    elif edit is not None:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sPSPHostNetworkingPorts",
            "metadata": {"name": "host-ports"},
            "spec": {"parameters": {"hostNetwork": False, "min": 8000,
                                    "max": edit}}})

# BENCH config 11's streaming churn (bench_configs.py config11, part 1):
# STREAM_ROUNDS rounds of 1% of the pods in all, STREAM_ROUND_GAP_S
# apart (past the stream's 25 ms debounce window)
STREAM_ROUNDS = 40
STREAM_ROUND_GAP_S = 0.15


def stream_churn_pods(pods: list[dict], rng: random.Random, round_: int,
                      count: int) -> list[dict]:
    """One streaming churn round of BENCH config 11 (config11's `churn`):
    `count` pods drawn by `rng`, each a deep copy of the original pod;
    every second one toggles its first container's `privileged` (a
    verdict that moves), the others gain a churned label (a verdict the
    flush confirms). Written to the kube with `kube.apply`."""
    import copy

    out = []
    for j, i in enumerate(rng.sample(range(len(pods)), count)):
        pod = copy.deepcopy(pods[i])
        if j % 2:
            ctx = pod["spec"]["containers"][0]["securityContext"]
            ctx["privileged"] = not ctx.get("privileged", False)
        else:
            pod["metadata"].setdefault("labels", {})["churn"] = \
                f"r{round_}-{i}"
        out.append(pod)
    return out


GENERAL_CONSTRAINTS = [
    ("K8sAllowedRepos", "repos-allowed",
     {"repos": ["registry.corp.example/", "gcr.io/corp/"]}),
    ("K8sContainerLimits", "limits-capped", {"cpu": "2", "memory": "1Gi"}),
    ("K8sContainerRatios", "ratio-capped", {"ratio": "4"}),
    ("K8sHttpsOnly", "https-only", None),
    ("K8sRequiredLabels", "must-own",
     {"labels": [{"key": "owner",
                  "allowedRegex": "^[a-z]+.corp.example$"}]}),
    ("K8sUniqueIngressHost", "unique-hosts", None),
    ("K8sUniqueServiceSelector", "unique-selectors", None),
]


PSP_CONSTRAINTS = [
    ("K8sPSPAllowPrivilegeEscalationContainer", "no-escalation", None),
    ("K8sPSPAppArmor", "apparmor-default",
     {"allowedProfiles": ["runtime/default"]}),
    ("K8sPSPCapabilities", "caps",
     {"allowedCapabilities": ["NET_BIND_SERVICE"],
      "requiredDropCapabilities": ["ALL"]}),
    ("K8sPSPFlexVolumes", "flex", {"allowedFlexVolumes": []}),
    ("K8sPSPForbiddenSysctls", "sysctls",
     {"forbiddenSysctls": ["kernel.*", "vm.swappiness"]}),
    ("K8sPSPFSGroup", "fsgroup",
     {"rule": "MustRunAs", "ranges": [{"min": 1000, "max": 65535}]}),
    ("K8sPSPHostFilesystem", "hostfs",
     {"allowedHostPaths": [{"pathPrefix": "/var/log", "readOnly": True}]}),
    ("K8sPSPHostNamespace", "no-host-ns", None),
    ("K8sPSPHostNetworkingPorts", "host-ports",
     {"hostNetwork": False, "min": 8000, "max": 9000}),
    ("K8sPSPPrivilegedContainer", "no-privileged", None),
    ("K8sPSPProcMount", "procmount", {"procMount": "Default"}),
    ("K8sPSPReadOnlyRootFilesystem", "ro-root", None),
    ("K8sPSPSeccomp", "seccomp",
     {"allowedProfiles": ["runtime/default", "docker/default"]}),
    ("K8sPSPSELinux", "selinux",
     {"allowedSELinuxOptions": {"level": "s0:c123,c456"}}),
    ("K8sPSPAllowedUsers", "users",
     {"runAsUser": {"rule": "MustRunAsNonRoot"}}),
    ("K8sPSPVolumeTypes", "volumes",
     {"volumes": ["configMap", "secret", "emptyDir", "hostPath"]}),
]
