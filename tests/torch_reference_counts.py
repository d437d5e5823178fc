"""Reference result counts for the port's general-library audit.

Runs BENCH config 2's workload (bench_configs.py: the 7 general-library
templates and GENERAL_CONSTRAINTS over synth_mixed_objects) through the
JAX package's TpuDriver on the CPU and prints the audit's result count per
object count, and the count after a policy edit (GENERAL_EDIT: one
constraint's parameters, its match unchanged), with the wall clock of the
first audit and the vocabulary size. chip_smoke.py holds the port's
general-library audits to these counts. Not a test (pytest does not
collect it); run from the repo root:

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py 10000 50000

With `--churn N` it runs BENCH config 6's churn audit instead
(bench_configs.py config6: the 16 pod-security-policy templates and
PSP_CONSTRAINTS over synth_pods_psp(N), churn rounds of N / 100 pods from
random.Random(6)) in chip_smoke.py's order (the port's CHURN_STEPS: first,
steady, the policy-edit round E1 = a churn round then host-ports' max
9000 -> 8100, the full re-encode, E2 = a churn round with the max back to
9000, and three churn rounds), and prints every audit's count and path,
and the calls of extract_batch and of _patch_feats that patched:

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py --churn 50000

(chip_smoke.py's phase 8b; its phases 15 (a) and 16 take the first
audit's count of `--churn 25000`)

With `--stream N` it runs BENCH config 11's streaming audit scenario
(chip_smoke.py's phase 9d (b); bench_configs.py config11, part 1)
through the JAX package's AuditManager on a FakeKube: synth_pods_psp(N)
with a uid per pod, the 16 PSP templates and constraints, an incremental
manager; the first sweep's count and its statuses' totalViolations sum,
a second (delta) sweep, then the STREAM_ROUNDS churn rounds of N / 100 /
STREAM_ROUNDS pods from random.Random(11) written to the kube (no
stream thread: the final inventory is the same whatever the flush
timing), an incremental sweep, and a full-resync sweep:

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py --stream 50000

With `--batch-derived N` it counts instead the derived-column rows both
packages' drivers evaluate in a review batch of N corpus manifests with
the corpus as inventory (PERF.md, section 5):

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py \
        --batch-derived 8192
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the policy edits chip_smoke.py makes: (kind, name, new parameters)
GENERAL_EDIT = ("K8sContainerLimits", "limits-capped",
                {"cpu": "1", "memory": "1Gi"})


def constraint(kind: str, name: str, params) -> dict:
    return {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": name},
            "spec": ({"parameters": params} if params else {})}



def general_audit_count(n: int) -> dict:
    from bench_configs import GENERAL_CONSTRAINTS, synth_mixed_objects
    from gatekeeper_tpu import policies
    from gatekeeper_tpu.client import Backend
    from gatekeeper_tpu.ir import TpuDriver
    from gatekeeper_tpu.target import K8sValidationTarget

    drv = TpuDriver()
    client = Backend(drv).new_client([K8sValidationTarget()])
    for name in policies.names():
        if name.startswith("general/"):
            client.add_template(policies.load(name))
    for kind, cname, params in GENERAL_CONSTRAINTS:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {})})
    for o in synth_mixed_objects(n):
        client.add_data(o)
    t0 = time.perf_counter()
    results = client.audit().results()
    first = time.perf_counter() - t0
    client.audit()
    client.add_constraint(constraint(*GENERAL_EDIT))
    edited = client.audit().results()
    counts = dict(drv._eval_counts)
    return {"objects": n, "results": len(results),
            "edit_results": len(edited),
            "first_audit_s_host_cpu": round(first, 1),
            "vocab": len(drv.strtab),
            "join_paths": sorted({p for (k, p) in counts
                                  if k.startswith("K8sUnique")})}


def batch_derived_rows(n: int) -> list[dict]:
    """Derived-column rows (ops/derived.py's DerivedTables._eval_row
    calls) each package's driver evaluates in a review batch of n corpus
    manifests: all 23 shipped templates, the 2,000 corpus objects as
    inventory, after a batch of 512 (batch_profile.py's all23+inv setup,
    on the CPU). A count of work, not a time."""
    import batch_profile
    from bench_configs import GENERAL_CONSTRAINTS, PSP_CONSTRAINTS
    from gatekeeper_tpu import policies
    from gatekeeper_tpu.client import Backend
    from gatekeeper_tpu.ir import TpuDriver
    from gatekeeper_tpu.ops import derived as jderived
    from gatekeeper_tpu.target import K8sValidationTarget
    from gatekeeper_tpu_torch.ops import derived as tderived

    rows = {"jax": 0, "torch": 0}
    for mod, key in ((jderived, "jax"), (tderived, "torch")):
        def counted(self, *a, _f=mod.DerivedTables._eval_row, _k=key, **kw):
            rows[_k] += 1
            return _f(self, *a, **kw)
        mod.DerivedTables._eval_row = counted

    drv = TpuDriver()
    client = Backend(drv).new_client([K8sValidationTarget()])
    for name in policies.names():
        client.add_template(policies.load(name))
    for kind, cname, params in GENERAL_CONSTRAINTS + PSP_CONSTRAINTS:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {})})
    tdrv, tclient = batch_profile.client_for("all23+inv", "cpu", ROOT)
    for o in batch_profile.corpus(ROOT, 2000):
        client.add_data(o)
    out = []
    for key, d, c in (("jax", drv, client), ("torch", tdrv, tclient)):
        c.review_batch(batch_profile.corpus(ROOT, 512))
        before, vocab = rows[key], len(d.strtab)
        res = c.review_batch(batch_profile.corpus(ROOT, n))
        out.append({"package": key, "batch": n,
                    "derived_rows": rows[key] - before,
                    "vocab": [vocab, len(d.strtab)],
                    "results": sum(len(r.results()) for r in res)})
    return out


def churn_counts(n: int) -> dict:
    """BENCH config 6's audits in chip_smoke.py's order, through the JAX
    package's TpuDriver (its device path forced): each audit's result
    count and path, with its extract_batch calls and patches."""
    import random

    from bench_configs import PSP_CONSTRAINTS, synth_pods_psp
    from gatekeeper_tpu import policies
    from gatekeeper_tpu.client import Backend
    from gatekeeper_tpu.ir import TpuDriver
    from gatekeeper_tpu.ir import driver as jdriver
    from gatekeeper_tpu.target import K8sValidationTarget
    from gatekeeper_tpu_torch.parallel.workload import (
        CHURN_STEPS, churn_step)

    calls = {"extract": 0, "patched": 0}
    extract, patch = jdriver.extract_batch, jdriver.TpuDriver._patch_feats

    def counted_extract(*a, **k):
        calls["extract"] += 1
        return extract(*a, **k)

    def counted_patch(*a, **k):
        out = patch(*a, **k)
        calls["patched"] += out is not None
        return out

    jdriver.extract_batch = counted_extract
    jdriver.TpuDriver._patch_feats = counted_patch
    drv = TpuDriver()
    drv.async_warm = False
    drv._use_device_for_batch = lambda n_pairs: True
    client = Backend(drv).new_client([K8sValidationTarget()])
    for name in policies.names():
        if name.startswith("pod-security-policy/"):
            client.add_template(policies.load(name))
    for c in PSP_CONSTRAINTS:
        client.add_constraint(constraint(*c))
    pods = synth_pods_psp(n)
    for o in pods:
        client.add_data(o)
    rng = random.Random(6)
    out = {"pods": n, "churn": max(1, n // 100)}
    for step, round_, edit in CHURN_STEPS:
        churn_step(client, drv, pods, rng, out["churn"], round_, edit)
        calls.update(extract=0, patched=0)
        out[step] = [len(client.audit().results()), drv.last_audit_path,
                     calls["extract"], calls["patched"]]
    return out


def stream_counts(n: int) -> dict:
    """BENCH config 11's streaming scenario through the JAX package's
    AuditManager (TpuDriver, its device path forced): the first sweep's
    count and status sum, and the counts after the churn rounds."""
    import random

    from bench_configs import PSP_CONSTRAINTS, synth_pods_psp
    from gatekeeper_tpu import policies
    from gatekeeper_tpu.client import Backend
    from gatekeeper_tpu.control.audit import AuditManager
    from gatekeeper_tpu.control.kube import FakeKube
    from gatekeeper_tpu.ir import TpuDriver
    from gatekeeper_tpu.target import K8sValidationTarget
    from gatekeeper_tpu_torch.parallel.workload import (
        STREAM_ROUNDS, stream_churn_pods)

    kube = FakeKube()
    kube.register_kind(("", "v1", "Namespace"), namespaced=False)
    kube.register_kind(("", "v1", "Pod"), namespaced=True)
    pods = synth_pods_psp(n)
    for i, pod in enumerate(pods):
        pod["metadata"]["uid"] = f"c11-{i}"
        kube.create(pod)
    drv = TpuDriver()
    drv.async_warm = False
    drv._use_device_for_batch = lambda n_pairs: True
    client = Backend(drv).new_client([K8sValidationTarget()])
    for name in policies.names():
        if name.startswith("pod-security-policy/"):
            client.add_template(policies.load(name))
    for c in PSP_CONSTRAINTS:
        con = constraint(*c)
        client.add_constraint(con)
        kube.apply(dict(con))
    mgr = AuditManager(kube, client, incremental=True, interval=3600,
                       stream_audit=True, stream_window_s=0.025)

    def statuses() -> dict:
        out = {}
        for k, name, _p in PSP_CONSTRAINTS:
            st = dict(kube.get(("constraints.gatekeeper.sh", "v1beta1", k),
                               name).get("status") or {})
            st.pop("auditTimestamp", None)
            out[f"{k}/{name}"] = st
        return out

    def status_sum() -> int:
        return sum((kube.get(("constraints.gatekeeper.sh", "v1beta1", k),
                             name).get("status") or {})
                   .get("totalViolations", 0)
                   for k, name, _p in PSP_CONSTRAINTS)

    out = {"pods": n, "first": len(mgr.audit_once())}
    out["first_status_sum"] = status_sum()
    out["second"] = [len(mgr.audit_once()), drv.last_audit_path]
    rng = random.Random(11)
    burst = max(1, n // 100 // STREAM_ROUNDS)
    for r in range(STREAM_ROUNDS):
        for pod in stream_churn_pods(pods, rng, r, burst):
            kube.apply(pod)
    out["churn"] = [STREAM_ROUNDS, burst]
    out["after_churn"] = [len(mgr.audit_once()), drv.last_audit_path]
    published = statuses()
    mgr.full_resync_every = 1
    out["resync"] = [len(mgr.audit_once()),
                     mgr.last_sweep_stats.get("sweep")]
    out["resync_status_sum"] = status_sum()
    # what the full resync rewrote of the statuses the delta sweep had
    # published: per constraint, the entries whose message differs
    # (a capped delta sweep can publish an entry count-only)
    rewritten = statuses()
    out["resync_rewrote"] = {
        name: sum(a != b for a, b in zip(published[name]["violations"],
                                         rewritten[name]["violations"]))
        for name in sorted(published) if published[name] != rewritten[name]}
    out["empty_messages_published"] = sum(
        1 for st in published.values() for v in st["violations"]
        if not v.get("message"))
    mgr.stop()
    return out


def main(argv: list[str]) -> int:
    sys.path.insert(0, ROOT)
    if argv[:1] == ["--churn"]:
        print(json.dumps(churn_counts(int(argv[1]))), flush=True)
        return 0
    if argv[:1] == ["--stream"]:
        print(json.dumps(stream_counts(int(argv[1]))), flush=True)
        return 0
    if argv[:1] == ["--batch-derived"]:
        for rec in batch_derived_rows(int(argv[1])):
            print(json.dumps(rec), flush=True)
        return 0
    for arg in argv or ["10000"]:
        print(json.dumps(general_audit_count(int(arg))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
