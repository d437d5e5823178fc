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

With `--runtime N` it boots the JAX package's process entry point
(control/main.py's Runtime, ENTRY_FLAGS of the port's
parallel/workload.py) on BENCH config 9's cluster at N pods
(entry_cluster: 40 Namespaces, synth_pods_psp(N), the 16 PSP templates
and constraints as kube objects) with its driver's device path forced,
drains the controllers, sweeps once and prints each constraint's status
totalViolations and their sum (`totals`); beside them each constraint's
count from the JAX package's interpreter (RegoDriver) over the same
objects (`host_totals`: K8sPSPSELinux's compiled path flags the
Namespaces, which have no spec, and the interpreter does not); then it
stops the Runtime (the drain snapshot), boots a second one on the same
state dir and an identically seeded kube, and prints its first sweep's
stats and totals (chip_smoke.py's phase 17):

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py --runtime 25000

With `--sharded N` it runs BENCH config 13's sharded audit plane
(bench_configs.py config13; chip_smoke.py's phase 18 (a)) through the
JAX package on the CPU: the port's parallel/workload.py c13_objects(N)
on a leader client, and per constraint the unsharded audit's count, a
2-shard composed round (ShardedAuditPlane over an in-process fleet of
slice clients, each behind the JAX package's control/engine.py
LibrarySink and an AuditSliceServer), and the composed round after two
of config13's churn rounds routed to the shards (c13_churn):

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py --sharded 200000

With `--scan N` it runs BENCH config 16's offline fleet scan
(bench_configs.py config16; chip_smoke.py's phase 19) through the JAX
package's scan_main on the CPU: the JSONL export of N manifests
(synth_mixed_objects(N // 8, seed=16), each object 8 times in a
random.Random(16) shuffle, written as config16 writes it), the general
library's templates and GENERAL_CONSTRAINTS, 2 loaders, batches of 256,
depth 2, a 65,536-entry dedupe LRU; it prints the JSONL's sha256, the
summary's counts, the exit code and the records' digest (the port's
parallel/workload.py scan_digest: per record its line number and its
verdict without `outcome`):

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py --scan 100000

With `--config10 N` it runs BENCH config 10's audit (bench_configs.py
config10: REQUIRED_LABELS_TEMPLATE x synth_constraints(100, seed=1) over
synth_objects(N, violate_frac=0.002, seed=0)) through the JAX package's
TpuDriver in two child processes, one after the other: one device
(GATEKEEPER_TPU_MESH=off), then 8 forced host devices
(XLA_FLAGS=--xla_force_host_platform_device_count=8, the default mesh
path), as config10 runs it. For each it prints the first audit's and a
full warm sweep's total, the count per constraint in constraint order,
a digest of the sorted (constraint, object, message) triples
(tests/torch_bench_configs.py result_digest), the path, the pair
capacities and the vocabulary's size (chip_smoke.py's phase 21 (a) and
(b)):

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py --config10 1000000

With `--config1` it runs BENCH config 1 (bench_configs.py config1:
general/requiredlabels with the one allowedRegex constraint read from
that function's text, over synth_objects(1000, violate_frac=0.02,
seed=7)) through TpuDriver as
decided and pinned to the device path, and through the JAX package's
RegoDriver, and prints the three counts (phase 21 (d)):

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py --config1

With `--config12` it runs BENCH config 12's extended-form corpus
(bench_configs.py config12: EXTENDED_FORM_TEMPLATES, each kind alone with
its one constraint, the dense kinds over synth_mixed_objects(50,000,
seed=12) with the team-label tail, the join kinds over its 4,000
Ingresses and Services) through the JAX package's TpuDriver, as decided
after its warm-up audit and pinned to the device path, and through the
JAX package's RegoDriver, and prints each kind's counts and TpuDriver's
path (chip_smoke.py's phase 22):

    JAX_PLATFORMS=cpu python tests/torch_reference_counts.py --config12

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


def runtime_counts(n: int) -> dict:
    """BENCH config 9's cluster through the JAX package's Runtime, cold
    then warm on one state dir: per constraint the status's
    totalViolations after the first full-library sweep, and the warm
    boot's first sweep."""
    import shutil
    import tempfile

    from gatekeeper_tpu import policies
    from gatekeeper_tpu.client import Backend, RegoDriver
    from gatekeeper_tpu.control.kube import FakeKube
    from gatekeeper_tpu.control.main import Runtime, build_parser
    from gatekeeper_tpu.target import K8sValidationTarget
    from gatekeeper_tpu_torch.parallel.workload import (
        ENTRY_FLAGS, PSP_CONSTRAINTS, entry_cluster)

    templates = [policies.load(name) for name in policies.names()
                 if name.startswith("pod-security-policy/")]
    state = tempfile.mkdtemp(prefix="gk-entry-")

    def boot():
        kube = FakeKube()
        entry_cluster(kube, templates, n)
        args = build_parser().parse_args(
            ENTRY_FLAGS + ["--state-dir", state, "--metrics-backend",
                           "none"])
        return kube, Runtime(args, kube=kube)

    def totals(kube) -> dict:
        return {f"{k}/{name}": (kube.get(
            ("constraints.gatekeeper.sh", "v1beta1", k), name)
            .get("status") or {}).get("totalViolations")
            for k, name, _p in PSP_CONSTRAINTS}

    out = {"pods": n}
    try:
        kube, rt = boot()
        drv = rt.opa.driver
        drv.async_warm = False
        drv._use_device_for_batch = lambda n_pairs: True
        t0 = time.perf_counter()
        rt.start()
        rt.manager.drain()
        out["cold_results"] = len(rt.audit.audit_once())
        out["cold_s_host_cpu"] = round(time.perf_counter() - t0, 1)
        out["totals"] = totals(kube)
        out["total"] = sum(out["totals"].values())
        out["paths"] = sorted({p for (_k, p) in drv._eval_counts})
        rt.stop()
        host = Backend(RegoDriver()).new_client([K8sValidationTarget()])
        for templ in templates:
            host.add_template(templ)
        for k, name, params in PSP_CONSTRAINTS:
            host.add_constraint(constraint(k, name, params))
        for gvk in (("", "v1", "Namespace"), ("", "v1", "Pod")):
            for o in kube.list(gvk):
                host.add_data(o)
        counts = {f"{k}/{name}": 0 for k, name, _p in PSP_CONSTRAINTS}
        for r in host.audit().results():
            counts[f"{r.constraint['kind']}/"
                   f"{r.constraint['metadata']['name']}"] += 1
        out["host_totals"] = counts
        kube, rt = boot()
        t0 = time.perf_counter()
        results = rt.audit.audit_once()
        out["warm_first_sweep"] = {
            "results": len(results),
            "s_host_cpu": round(time.perf_counter() - t0, 1),
            **{k: rt.audit.last_sweep_stats.get(k)
               for k in ("sweep", "dirty", "inventory")},
            "rows_adopted": getattr(rt.opa.driver, "restored_rows_adopted",
                                    0)}
        out["warm_totals"] = totals(kube)
        rt.audit.stop()
    finally:
        shutil.rmtree(state, ignore_errors=True)
    return out


def sharded_counts(n: int) -> dict:
    """BENCH config 13 through the JAX package: per constraint the
    unsharded audit, the 2-shard composed round, and the composed round
    after two churn rounds."""
    from gatekeeper_tpu import policies
    from gatekeeper_tpu.client import Backend
    from gatekeeper_tpu.control.audit import (AuditSliceServer,
                                              ShardedAuditPlane)
    from gatekeeper_tpu.control.engine import LibrarySink
    from gatekeeper_tpu.control.kube import FakeKube
    from gatekeeper_tpu.ir import TpuDriver
    from gatekeeper_tpu.target import K8sValidationTarget
    from gatekeeper_tpu_torch.parallel.workload import (
        C13_CONSTRAINTS, REQUIRED_LABELS_TEMPLATE, c13_churn, c13_objects)

    shards = 2

    def new_client():
        return Backend(TpuDriver()).new_client([K8sValidationTarget()])

    def per_constraint(results) -> dict:
        out = {f"{c['kind']}/{c['metadata']['name']}": 0
               for c in C13_CONSTRAINTS}
        for r in results:
            out[f"{r.constraint['kind']}/"
                f"{r.constraint['metadata']['name']}"] += 1
        return out

    class Fleet:
        """The shard supervisor's stand-in, in this process."""

        def __init__(self):
            self.clients = [new_client() for _ in range(shards)]
            for k, c in enumerate(self.clients):
                c.driver.set_audit_shard(k, shards)
            self.sinks = [LibrarySink(c) for c in self.clients]
            self.servers = [AuditSliceServer(c, shard_id=k,
                                             shard_count=shards)
                            for k, c in enumerate(self.clients)]

        def send(self, k, op, timeout=30.0):
            self.sinks[k](op)

        def replicate(self, op, obj):
            for sink in self.sinks:
                sink({"op": op, "obj": obj})

        def sweep(self, k, body, timeout_s=600.0):
            return self.servers[k].handle_http(body)

    leader = new_client()
    plane = ShardedAuditPlane(FakeKube(), leader, Fleet(), shards)
    plane.attach()
    leader.add_template(REQUIRED_LABELS_TEMPLATE)
    leader.add_template(policies.load("general/uniqueingresshost"))
    for c in C13_CONSTRAINTS:
        leader.add_constraint(c)
    objs = c13_objects(n)
    t0 = time.perf_counter()
    for o in objs:
        leader.add_data(o)
    out = {"pods": n, "objects": len(objs),
           "ingest_s_host_cpu": round(time.perf_counter() - t0, 1)}
    out["unsharded"] = per_constraint(leader.audit().results())
    out["composed"] = per_constraint(plane.sweep(None)[0])
    for round_ in range(2):
        for pod in c13_churn(n, round_):
            leader.add_data(pod)
    out["composed_after_churn"] = per_constraint(plane.sweep(None)[0])
    out["unsharded_after_churn"] = per_constraint(leader.audit().results())
    plane.stop()
    return out


def scan_counts(n: int) -> dict:
    import hashlib
    import random
    import shutil
    import tempfile

    import yaml

    from bench_configs import GENERAL_CONSTRAINTS, synth_mixed_objects
    from gatekeeper_tpu.control.scan import scan_main
    from gatekeeper_tpu_torch.parallel.workload import scan_digest

    work = tempfile.mkdtemp(prefix="gk-scan-counts-")
    try:
        # config16's export, as bench_configs.py writes it
        dup = 8
        unique = max(1, n // dup)
        blobs = [json.dumps(o).encode()
                 for o in synth_mixed_objects(unique, seed=16)]
        order = list(range(unique)) * dup
        random.Random(16).shuffle(order)
        jsonl = os.path.join(work, "inventory.jsonl")
        with open(jsonl, "wb") as f:
            for i in order:
                f.write(blobs[i])
                f.write(b"\n")
        with open(jsonl, "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
        constraints_yaml = os.path.join(work, "constraints.yaml")
        with open(constraints_yaml, "w") as f:
            yaml.safe_dump_all([constraint(*c) for c in GENERAL_CONSTRAINTS],
                               f)
        out = os.path.join(work, "records.jsonl")
        summary_path = os.path.join(work, "summary.json")
        t0 = time.perf_counter()
        rc = scan_main([
            jsonl, "--format", "jsonl", "--loaders", "2", "--batch", "256",
            "--depth", "2", "--dedupe", "65536", "--output", out,
            "--summary", summary_path, "--policies",
            os.path.join(ROOT, "gatekeeper_tpu", "policies", "general"),
            "--policies", constraints_yaml])
        wall = time.perf_counter() - t0
        with open(summary_path) as f:
            summary = json.load(f)
        with open(out) as f:
            digest = scan_digest(json.loads(line) for line in f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"manifests": unique * dup, "unique": unique,
            "jsonl_sha256": sha, "exit": rc,
            "summary": {k: summary[k] for k in (
                "manifests", "unique_evaluated", "deduped", "allowed",
                "denied", "errors", "skipped_docs")},
            "records_sha256": digest, "wall_s_host_cpu": round(wall, 1)}


def config10_child(mode: str, n: int) -> dict:
    """One of --config10's children: the environment (the mesh switch,
    the forced host devices) is set by the parent before JAX starts."""
    import jax

    from gatekeeper_tpu.client import Backend
    from gatekeeper_tpu.ir import TpuDriver
    from gatekeeper_tpu.parallel.workload import (
        REQUIRED_LABELS_TEMPLATE, synth_constraints, synth_objects)
    from gatekeeper_tpu.target import K8sValidationTarget
    from tests.torch_bench_configs import (
        C10_CONSTRAINTS, C10_VIOLATE_FRAC, per_constraint_counts,
        result_digest)

    drv = TpuDriver()
    client = Backend(drv).new_client([K8sValidationTarget()])
    client.add_template(REQUIRED_LABELS_TEMPLATE)
    cons = synth_constraints(C10_CONSTRAINTS, seed=1)
    for c in cons:
        client.add_constraint(c)
    t0 = time.perf_counter()
    for o in synth_objects(n, violate_frac=C10_VIOLATE_FRAC, seed=0):
        client.add_data(o)
    ingest = time.perf_counter() - t0
    out = {"mode": mode, "objects": n, "devices": len(jax.devices()),
           "ingest_s_host_cpu": round(ingest, 1)}
    for what in ("first", "warm"):
        if what == "warm":
            drv._audit_results_cache.clear()
        t0 = time.perf_counter()
        results = client.audit().results()
        out[f"{what}_s_host_cpu"] = round(time.perf_counter() - t0, 1)
        out[what] = {"results": len(results),
                     "path": drv.last_audit_path,
                     "per_constraint": per_constraint_counts(results, cons),
                     "digest": result_digest(results)}
    ct = drv.compiled_for("K8sRequiredLabels")
    out.update(rows_cap=ct._rows_cap, rows_cap_mesh=ct._rows_cap_mesh,
               vocab=len(drv.strtab))
    return out


def config10_counts(n: int) -> dict:
    """BENCH config 10 through the JAX package: one device, then 8
    forced host devices, each in a child process of its own."""
    import subprocess

    out = {}
    for mode in ("single", "mesh8"):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        if mode == "single":
            env["GATEKEEPER_TPU_MESH"] = "off"
        else:
            env["GATEKEEPER_TPU_MESH"] = "auto"
            env["XLA_FLAGS"] = (
                env.get("XLA_FLAGS", "") +
                " --xla_force_host_platform_device_count=8").strip()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--config10-child",
             mode, str(n)], env=env, capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode or not lines:
            raise RuntimeError(f"the {mode} child exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        out[mode] = json.loads(lines[-1])
    return out


def config1_counts() -> dict:
    """BENCH config 1 through the JAX package: TpuDriver as decided and
    pinned to the device path, and the JAX package's RegoDriver."""
    from gatekeeper_tpu import policies
    from gatekeeper_tpu.client import Backend, RegoDriver
    from gatekeeper_tpu.ir import TpuDriver
    from gatekeeper_tpu.parallel.workload import synth_objects
    from gatekeeper_tpu.target import K8sValidationTarget
    from tests.torch_bench_configs import (
        C1_OBJECTS, C1_VIOLATE_FRAC, bench_constraint)
    from tests.torch_fuzz_gen import pin

    constraint = bench_constraint("config1")
    out = {"objects": C1_OBJECTS}
    for what in ("decided", "pinned", "rego"):
        drv = RegoDriver() if what == "rego" else TpuDriver()
        if what == "pinned":
            pin(drv)
        client = Backend(drv).new_client([K8sValidationTarget()])
        client.add_template(policies.load("general/requiredlabels"))
        client.add_constraint(constraint)
        for o in synth_objects(C1_OBJECTS, violate_frac=C1_VIOLATE_FRAC,
                               seed=7):
            client.add_data(o)
        out[what] = len(client.audit().results())
        if what != "rego":
            out[f"{what}_path"] = drv.last_audit_path
    return out


def config12_counts() -> dict:
    """BENCH config 12 through the JAX package at C12_DENSE / C12_JOIN
    objects: per extended-form kind, TpuDriver as decided (a warm-up
    audit, then a full sweep) and pinned, and the JAX package's
    RegoDriver."""
    os.environ.setdefault("GATEKEEPER_TPU_ASYNC_COMPILE", "0")
    import bench_configs
    from gatekeeper_tpu.client import Backend, RegoDriver
    from gatekeeper_tpu.ir import TpuDriver
    from gatekeeper_tpu.target import K8sValidationTarget
    from tests.torch_bench_configs import (
        C12_DENSE, C12_JOIN, c12_constraint, c12_dense_objects, c12_is_join,
        c12_join_objects)
    from tests.torch_fuzz_gen import pin

    dense = c12_dense_objects(C12_DENSE, bench_configs.synth_mixed_objects)
    join = c12_join_objects(C12_JOIN)
    out = {"objects": {"dense": C12_DENSE, "join": C12_JOIN}, "kinds": {}}
    for kind, tmpl, params in bench_configs.EXTENDED_FORM_TEMPLATES:
        rec = {}
        for what in ("decided", "pinned", "rego"):
            drv = RegoDriver() if what == "rego" else TpuDriver()
            if what == "pinned":
                pin(drv)
            client = Backend(drv).new_client([K8sValidationTarget()])
            client.add_template(tmpl)
            client.add_constraint(c12_constraint(kind, params))
            for o in (join if c12_is_join(kind) else dense):
                client.add_data(o)
            client.audit()  # the config's warm-up
            if what != "rego":
                drv._audit_results_cache.clear()
            t0 = time.perf_counter()
            rec[what] = len(client.audit().results())
            rec[f"{what}_s_host_cpu"] = round(time.perf_counter() - t0, 3)
            if what != "rego":
                rec[f"{what}_path"] = sorted(
                    p for (k, p), n in drv._eval_counts.items()
                    if k == kind and n)
        out["kinds"][kind] = rec
        print(json.dumps({kind: rec}), file=sys.stderr, flush=True)
    return out


def main(argv: list[str]) -> int:
    sys.path.insert(0, ROOT)
    if argv[:1] == ["--churn"]:
        print(json.dumps(churn_counts(int(argv[1]))), flush=True)
        return 0
    if argv[:1] == ["--stream"]:
        print(json.dumps(stream_counts(int(argv[1]))), flush=True)
        return 0
    if argv[:1] == ["--runtime"]:
        print(json.dumps(runtime_counts(int(argv[1]))), flush=True)
        return 0
    if argv[:1] == ["--sharded"]:
        print(json.dumps(sharded_counts(int(argv[1]))), flush=True)
        return 0
    if argv[:1] == ["--scan"]:
        print(json.dumps(scan_counts(int(argv[1]))), flush=True)
        return 0
    if argv[:1] == ["--config10"]:
        print(json.dumps(config10_counts(int(argv[1]))), flush=True)
        return 0
    if argv[:1] == ["--config10-child"]:
        print(json.dumps(config10_child(argv[1], int(argv[2]))), flush=True)
        return 0
    if argv[:1] == ["--config1"]:
        print(json.dumps(config1_counts()), flush=True)
        return 0
    if argv[:1] == ["--config12"]:
        print(json.dumps(config12_counts()), flush=True)
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
