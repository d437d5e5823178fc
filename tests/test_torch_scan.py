"""The offline fleet scan on the port (gatekeeper_tpu_torch/control/scan.py)
against the JAX package's (gatekeeper_tpu/control/scan.py).

  * every case of tests/test_scan.py on the port's module: loader
    formats, the tree walk, JSONL shards, malformed files, dedupe and its
    LRU, the content key against the port's DecisionCache, engine
    failures, a dead loader, parallel loaders, the verdict oracle,
    scan_main's exit codes and summary (`--device cpu`), the preview
    alias, the stage names and the streaming reporter;
  * differentials: the fixture tree through both packages'
    build_inproc_tier + run_scan (TpuDriver on the CPU,
    TorchDriver(device="cpu")), as the cost model decides and pinned to
    the device path, records equal origin for origin; a config-16-shaped
    JSONL export through both scan_main's (summaries less timings and
    records equal); the exit-code contract in both; `--preview-constraint`;
  * what the port rewired: scan_main without `--device` raises where no
    card is visible (no CPU fallback), and a spawned loader imports
    neither torch nor jax.
"""

from __future__ import annotations

import io
import json
import logging
import os
import tempfile

import pytest
import yaml

from gatekeeper_tpu.control import scan as jscan
from gatekeeper_tpu_torch.control import scan as scan_mod
from gatekeeper_tpu_torch.control.scan import (
    DedupeTier,
    LoaderPool,
    Reporter,
    ScanFatal,
    build_inproc_tier,
    content_key,
    exit_code,
    is_k8s_manifest,
    parse_file,
    parse_jsonl,
    run_scan,
    scan_main,
    synthesize_request,
    walk_tree,
)
from gatekeeper_tpu_torch.control.webhook import verdict_response
from gatekeeper_tpu_torch.parallel.workload import (
    GENERAL_CONSTRAINTS, c16_constraints_yaml, c16_jsonl, scan_digest)
from gatekeeper_tpu_torch.target import AugmentedReview

FIXTURE_TREE = os.path.join(os.path.dirname(__file__), "fixtures",
                            "fleet_scan")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pod(name, ns="a", labels=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns,
                         **({"labels": labels} if labels else {})},
            "spec": {"containers": [
                {"name": "c", "image": "registry.corp.example/app"}]}}


@pytest.fixture(autouse=True)
def _restore_gatekeeper_logger():
    """scan_main (both packages') calls glog.setup(), which turns off the
    shared "gatekeeper" logger's propagation and never restores it: that
    would blind caplog for every later test in this process. Snapshot
    and restore it around each test."""
    gklog = logging.getLogger("gatekeeper")
    saved = (gklog.handlers[:], gklog.propagate, gklog.level)
    try:
        yield
    finally:
        gklog.handlers[:], gklog.propagate, gklog.level = saved


def _die_loader(*args, **kwargs):  # spawn target must be picklable
    os._exit(3)


class EchoTier:
    """Engine stand-in: denies pods whose name contains 'bad',
    synchronously. Counts what crossed the 'wire'."""

    name = "inproc"
    wants_bytes = False

    def __init__(self, fail_names=()):
        self.sent: list = []
        self.batches = 0
        self.fail_names = set(fail_names)

    def begin(self, batch):
        self.batches += 1
        self.sent.extend(r[3]["name"] for r in batch)
        out = []
        for rec in batch:
            name = rec[3]["name"]
            if name in self.fail_names:
                out.append({"error": f"engine failed on {name}"})
            elif "bad" in name:
                out.append({"allowed": False, "reason": "denied"})
            else:
                out.append({"allowed": True})
        return out

    def finish(self, token):
        return token

    def close(self):
        pass


# ------------------------------------------------------- loader formats


def test_tree_walk_skips_non_manifests(tmp_path):
    (tmp_path / "a.yaml").write_text("apiVersion: v1\nkind: Pod\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.json").write_text("{}")
    (tmp_path / "README.md").write_text("docs")
    (tmp_path / ".hidden.yaml").write_text("x: 1")
    (tmp_path / ".git").mkdir()
    (tmp_path / ".git" / "c.yaml").write_text("x: 1")
    files, skipped = walk_tree(str(tmp_path))
    names = [os.path.relpath(f, tmp_path) for f in files]
    assert names == ["a.yaml", os.path.join("sub", "b.json")]
    assert skipped == 1  # README.md; dotfiles/dirs pruned silently


def test_multidoc_yaml_separators_and_skips(tmp_path):
    p = tmp_path / "m.yaml"
    with open(p, "w") as f:
        yaml.safe_dump_all(
            [_pod("one"), None, {"values": 1},  # blank + non-k8s doc
             {"kind": "List", "apiVersion": "v1",
              "items": [_pod("two"), _pod("three")]}], f)
    entries = list(parse_file(str(p)))
    states = [s for s, _ in entries]
    assert states == ["ok", "skip", "ok", "ok"]
    origins = [payload[0] for s, payload in entries if s == "ok"]
    # one origin per document, stable across re-parses
    assert origins == [f"{p}#0", f"{p}#2", f"{p}#3"]
    names = [payload[1]["metadata"]["name"]
             for s, payload in entries if s == "ok"]
    assert names == ["one", "two", "three"]


def test_jsonl_shards_partition_exactly(tmp_path):
    p = tmp_path / "inv.jsonl"
    with open(p, "w") as f:
        for i in range(17):
            f.write(json.dumps(_pod(f"p{i}")) + "\n")
        f.write("\n")           # blank line: ignored
        f.write("{broken\n")    # malformed line: one error record
    seen: list = []
    errs = 0
    for shard in range(3):
        for state, payload in parse_jsonl(str(p), shard, 3):
            if state == "ok":
                seen.append(payload[1]["metadata"]["name"])
            elif state == "err":
                errs += 1
    assert sorted(seen) == sorted(f"p{i}" for i in range(17))
    assert len(set(seen)) == 17  # no line claimed by two shards
    assert errs == 1


def test_malformed_files_error_but_never_abort(tmp_path):
    with open(tmp_path / "good.yaml", "w") as f:
        yaml.safe_dump_all([_pod("ok-one")], f)
    (tmp_path / "broken.yaml").write_text(
        "apiVersion: v1\nkind: Pod\n  bad: [\n")
    (tmp_path / "broken.json").write_text("{not json")
    tier = EchoTier()
    out = io.StringIO()
    files, _ = walk_tree(str(tmp_path))
    summary = run_scan(tier, LoaderPool("tree", files, 0, False), out)
    assert summary["errors"] == 2
    assert summary["allowed"] == 1  # the scan still evaluated the rest
    assert exit_code(summary) == 2  # errors take precedence
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    assert sum(1 for r in recs if r["outcome"] == "error") == 2
    assert all("error" in r for r in recs if r["outcome"] == "error")


def test_is_k8s_manifest():
    assert is_k8s_manifest(_pod("x"))
    assert not is_k8s_manifest({"values": {"x": 1}})
    assert not is_k8s_manifest({"apiVersion": "v1"})
    assert not is_k8s_manifest({"apiVersion": 3, "kind": "Pod"})
    assert not is_k8s_manifest(["apiVersion", "kind"])


# ---------------------------------------------------------------- dedupe


def test_dedupe_rejoins_and_counts(tmp_path):
    docs = [_pod("good"), _pod("bad-pod"), _pod("good"),
            _pod("bad-pod"), _pod("other", labels={"x": "y"})]
    with open(tmp_path / "m.yaml", "w") as f:
        yaml.safe_dump_all(docs, f)
    tier = EchoTier()
    out = io.StringIO()
    summary = run_scan(tier, LoaderPool(
        "tree", [str(tmp_path / "m.yaml")], 0, False), out)
    # only the 3 unique shapes crossed the wire
    assert sorted(tier.sent) == ["bad-pod", "good", "other"]
    assert summary["unique_evaluated"] == 3
    assert summary["deduped"] == 2
    assert summary["manifests"] == 5
    # every duplicate still gets its own record, with the SAME verdict
    recs = {r["origin"]: r
            for r in map(json.loads, out.getvalue().splitlines())}
    assert len(recs) == 5
    dedups = [r for r in recs.values() if r["outcome"] == "dedup"]
    assert len(dedups) == 2
    denied = [r for r in recs.values() if not r["allowed"]]
    assert len(denied) == 2  # bad-pod twice: one deny + one dedup
    assert summary["denied"] == 2
    assert exit_code(summary) == 1


def test_dedupe_never_replays_error_verdicts():
    d = DedupeTier(size=8)
    key = "k" * 32
    assert d.check(key, "o1") is None  # first: caller sends
    assert d.resolve(key, {"error": "shed"}) == []
    # the error was NOT cached: the next duplicate re-evaluates
    assert d.check(key, "o2") is None
    assert d.resolve(key, {"allowed": True}) == []
    assert d.check(key, "o3") == {"allowed": True}


def test_dedupe_lru_bounded():
    d = DedupeTier(size=2)
    for i in range(4):
        k = f"key{i}"
        assert d.check(k, f"o{i}") is None
        d.resolve(k, {"allowed": True})
    assert len(d._verdicts) == 2
    assert d.check("key0", "again") is None  # evicted: re-evaluates


def test_content_key_matches_decision_cache_recipe():
    from gatekeeper_tpu.control.webhook import DecisionCache as JCache
    from gatekeeper_tpu_torch.control.webhook import DecisionCache

    req = synthesize_request(_pod("x"))
    req["uid"] = "ignored"
    req["timeoutSeconds"] = 5
    assert content_key(req) == DecisionCache.request_key(req).hex()
    # and the JAX package's loaders key the same request alike
    assert content_key(req) == jscan.content_key(req) \
        == JCache.request_key(req).hex()


# ----------------------------------------------- engine failure honesty


def test_engine_failures_become_error_records(tmp_path):
    docs = [_pod("good"), _pod("flaky")]
    with open(tmp_path / "m.yaml", "w") as f:
        yaml.safe_dump_all(docs, f)
    tier = EchoTier(fail_names={"flaky"})
    out = io.StringIO()
    summary = run_scan(tier, LoaderPool(
        "tree", [str(tmp_path / "m.yaml")], 0, False), out)
    assert summary["errors"] == 1 and summary["allowed"] == 1
    assert exit_code(summary) == 2


def test_loader_death_is_error_records_not_a_hang(tmp_path,
                                                 monkeypatch):
    # a loader process that dies without its sentinel must surface as
    # an error record; the scan completes instead of blocking forever
    monkeypatch.setattr(scan_mod, "_loader_main", _die_loader)
    with open(tmp_path / "m.yaml", "w") as f:
        yaml.safe_dump_all([_pod("good")], f)
    tier = EchoTier()
    out = io.StringIO()
    summary = run_scan(tier, LoaderPool(
        "tree", [str(tmp_path / "m.yaml")], 1, False), out)
    assert summary["errors"] == 1
    assert "died" in out.getvalue()


def test_parallel_loaders_match_inline(tmp_path):
    """loaders=2 (spawned processes) and loaders=0 (inline) must produce
    the same records for the same source, origin for origin."""
    p = tmp_path / "inv.jsonl"
    with open(p, "w") as f:
        for i in range(40):
            f.write(json.dumps(_pod(f"p{i}" if i % 7 else f"bad{i}"))
                    + "\n")
    outs = []
    for loaders in (0, 2):
        out = io.StringIO()
        summary = run_scan(EchoTier(), LoaderPool(
            "jsonl", [str(p)], loaders, False), out, batch_size=16)
        assert summary["errors"] == 0
        outs.append(sorted(out.getvalue().splitlines()))
    assert outs[0] == outs[1]


# ------------------------------------------------------- verdict oracle


def _library(client):
    from gatekeeper_tpu_torch import policies

    client.add_template(policies.load("general/requiredlabels"))
    client.add_template(policies.load("general/allowedrepos"))
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sRequiredLabels", "metadata": {"name": "must-own"},
        "spec": {"parameters": {"labels": [
            {"key": "owner",
             "allowedRegex": "^[a-z]+.corp.example$"}]}}})
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sAllowedRepos", "metadata": {"name": "repos"},
        "spec": {"parameters": {"repos": [
            "registry.corp.example/", "gcr.io/corp/"]}}})
    return client


@pytest.fixture(scope="module")
def library_client():
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    return _library(Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()]))


def _oracle_verdict(client, request):
    pairs = [(r.enforcement_action, r.msg)
             for r in client.review(AugmentedReview(request)).results()]
    return scan_mod._verdict_from_response(verdict_response(pairs))


def test_scan_verdicts_bit_equal_review_oracle(library_client):
    """Acceptance: scan verdicts == per-manifest Client.review on
    fixture-tree files, including the dedupe path (the fixture carries
    exact duplicates)."""
    files = [os.path.join(FIXTURE_TREE, f)
             for f in ("manifests_00.yaml", "manifests_01.yaml")]
    tier = build_inproc_tier([], client=library_client,
                             decision_cache=64, timeout_s=120.0)
    out = io.StringIO()
    try:
        summary = run_scan(tier, LoaderPool("tree", files, 0, False),
                           out, batch_size=64, dedupe_size=1024)
    finally:
        tier.close()
    assert summary["errors"] == 0
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    assert len(recs) == summary["manifests"] > 0
    assert summary["deduped"] > 0, \
        "fixture files must exercise the dedupe path"
    by_origin = {}
    for state, payload in (e for f in files for e in parse_file(f)):
        assert state == "ok"
        by_origin[payload[0]] = synthesize_request(payload[1])
    assert set(by_origin) == {r["origin"] for r in recs}
    for rec in recs:
        expected = _oracle_verdict(library_client,
                                   by_origin[rec["origin"]])
        got = {k: v for k, v in rec.items()
               if k not in ("origin", "outcome")}
        assert got == expected, rec["origin"]


def test_dedup_verdict_identical_to_first_occurrence(library_client):
    pod = _pod("same", labels={"owner": "team.corp.example"})
    with_dupes = [pod, _pod("bad"), pod, _pod("bad")]
    tier = build_inproc_tier([], client=library_client,
                             decision_cache=0, timeout_s=120.0)
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "m.yaml")
        with open(p, "w") as f:
            yaml.safe_dump_all(with_dupes, f)
        try:
            run_scan(tier, LoaderPool("tree", [p], 0, False), out)
        finally:
            tier.close()
    recs = [json.loads(line) for line in out.getvalue().splitlines()]
    assert {r["outcome"] for r in recs} == {"allow", "deny", "dedup"}
    for outcome_pair in (("allow", 0), ("deny", 1)):
        first = next(r for r in recs if r["outcome"] == outcome_pair[0])
        twin = next(r for r in recs
                    if r["outcome"] == "dedup"
                    and r.get("allowed") == first["allowed"]
                    and r.get("reason") == first.get("reason"))
        assert {k: v for k, v in twin.items()
                if k not in ("origin", "outcome")} \
            == {k: v for k, v in first.items()
                if k not in ("origin", "outcome")}


# --------------------------------------------------- CLI + exit contract


def _exit_code_cases(tmp_path, main) -> list:
    """The exit codes of tests/test_scan.py's contract cases through
    `main` (a package's scan_main with its driver's arguments bound)."""
    pol = tmp_path / "policies"
    pol.mkdir()
    from gatekeeper_tpu_torch import policies

    with open(pol / "req.yaml", "w") as f:
        yaml.safe_dump_all([
            policies.load("general/requiredlabels"),
            {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
             "kind": "K8sRequiredLabels",
             "metadata": {"name": "must-own"},
             "spec": {"parameters": {"labels": [{"key": "owner"}]}}},
        ], f)
    clean = tmp_path / "clean"
    clean.mkdir()
    with open(clean / "m.yaml", "w") as f:
        yaml.safe_dump_all([_pod("ok", labels={"owner": "me"})], f)
    out = tmp_path / "out.jsonl"
    codes = [main([str(clean), "--policies", str(pol), "--loaders", "0",
                   "--output", str(out)])]
    denials = tmp_path / "denials"
    denials.mkdir()
    with open(denials / "m.yaml", "w") as f:
        yaml.safe_dump_all([_pod("no-labels")], f)
    codes.append(main([str(denials), "--policies", str(pol),
                       "--loaders", "0", "--output", str(out)]))
    (denials / "broken.yaml").write_text("a: [\n")
    codes.append(main([str(denials), "--policies", str(pol),
                       "--loaders", "0", "--output", str(out)]))
    # fatal: no policies for the in-process tier
    codes.append(main([str(clean), "--loaders", "0", "--output",
                       str(out)]))
    # fatal: nonexistent source
    codes.append(main([str(tmp_path / "missing"), "--policies", str(pol),
                       "--loaders", "0"]))
    return codes


def _torch_main(argv):
    return scan_main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("main", [_torch_main, jscan.scan_main],
                         ids=["torch", "jax"])
def test_scan_main_exit_codes(tmp_path, main):
    """The exit-code contract, through the port's scan_main and, on the
    same inputs, the JAX package's."""
    assert _exit_code_cases(tmp_path, main) == [0, 1, 2, 3, 3]


def test_scan_main_summary_file(tmp_path):
    pol = tmp_path / "pol.yaml"
    from gatekeeper_tpu_torch import policies

    with open(pol, "w") as f:
        yaml.safe_dump_all([
            policies.load("general/requiredlabels"),
            {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
             "kind": "K8sRequiredLabels", "metadata": {"name": "o"},
             "spec": {"parameters": {"labels": [{"key": "owner"}]}}},
        ], f)
    src = tmp_path / "src"
    src.mkdir()
    with open(src / "m.yaml", "w") as f:
        yaml.safe_dump_all([_pod("a"), _pod("a"),
                            _pod("b", labels={"owner": "me"})], f)
    summary_path = tmp_path / "s.json"
    rc = scan_main([str(src), "--policies", str(pol), "--loaders", "0",
                    "--output", os.devnull,
                    "--summary", str(summary_path), "--device", "cpu"])
    s = json.loads(summary_path.read_text())
    assert rc == 1
    assert s["manifests"] == 3
    assert s["deduped"] == 1
    assert s["unique_evaluated"] == 2
    assert s["denied"] == 2  # the deny and its dedup twin


# ---------------------------------------------------------------- preview


def test_preview_candidate_alias(library_client):
    """--preview ingests the candidate under the content-hashed alias
    kind, isolated from any serving library."""
    from gatekeeper_tpu_torch.client import Backend
    from gatekeeper_tpu_torch.ir import TorchDriver
    from gatekeeper_tpu_torch.target import K8sValidationTarget

    from tests.test_client import REQUIRED_LABELS_TEMPLATE

    client = Backend(TorchDriver(device="cpu")).new_client(
        [K8sValidationTarget()])
    alias = scan_mod.ingest_candidate(
        client, REQUIRED_LABELS_TEMPLATE,
        {"kind": "K8sRequiredLabelsTest",
         "spec": {"parameters": {"labels": ["owner"]}}})
    assert alias.startswith("K8sRequiredLabelsTestPV")
    assert len(alias) == len("K8sRequiredLabelsTest") + 2 + 12
    assert client.knows_kind(alias)
    tier2 = build_inproc_tier([], client=client, timeout_s=120.0)
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "m.yaml")
        with open(p, "w") as f:
            yaml.safe_dump_all([_pod("nolabel"),
                                _pod("ok", labels={"owner": "x"})], f)
        try:
            summary = run_scan(tier2, LoaderPool("tree", [p], 0, False),
                               out)
        finally:
            tier2.close()
    assert summary["denied"] == 1
    assert summary["allowed"] == 1


def test_preview_fatal_without_kind():
    with pytest.raises(ScanFatal):
        scan_mod.ingest_candidate(object(), None, {"spec": {}})


# ---------------------------------------------------------------- stages


def test_scan_stages_registered():
    from gatekeeper_tpu_torch.control.stages import STAGE_NAMES

    for s in ("scan_load", "scan_dedupe", "scan_feed", "scan_report"):
        assert s in STAGE_NAMES


def test_reporter_streams_not_accumulates():
    rep = Reporter(io.StringIO())
    for i in range(1000):
        rep.emit(f"o{i}", {"allowed": True}, "allow")
    assert rep.counts["allow"] == 1000
    # the reporter holds counters, never the verdict records
    assert not hasattr(rep, "records")


# ------------------------------------------ differentials against the JAX package


def _general_client(pkg: str, pinned: bool):
    """(client, driver): the general library and GENERAL_CONSTRAINTS on
    TpuDriver (pkg "jax", on the CPU) or TorchDriver(device="cpu"); pinned
    to the device path for every batch, as the JAX tests pin it (the
    driver's `pinned` list records each batch the pin sent there)."""
    if pkg == "jax":
        from gatekeeper_tpu import policies
        from gatekeeper_tpu.client import Backend
        from gatekeeper_tpu.ir import TpuDriver as Driver
        from gatekeeper_tpu.target import K8sValidationTarget
        drv = Driver()
    else:
        from gatekeeper_tpu_torch import policies
        from gatekeeper_tpu_torch.client import Backend
        from gatekeeper_tpu_torch.ir import TorchDriver as Driver
        from gatekeeper_tpu_torch.target import K8sValidationTarget
        drv = Driver(device="cpu")
    drv.pinned = []
    if pinned:
        drv._use_device_for_batch = lambda n: drv.pinned.append(n) or True
    client = Backend(drv).new_client([K8sValidationTarget()])
    for name in policies.names():
        if name.startswith("general/"):
            client.add_template(policies.load(name))
    for kind, cname, params in GENERAL_CONSTRAINTS:
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": kind, "metadata": {"name": cname},
            "spec": ({"parameters": params} if params else {})})
    return client, drv


def _tree_scan(mod, client) -> tuple[dict, list]:
    files, _ = mod.walk_tree(FIXTURE_TREE)
    tier = mod.build_inproc_tier([], client=client, decision_cache=0,
                                 timeout_s=120.0)
    out = io.StringIO()
    try:
        summary = mod.run_scan(tier, mod.LoaderPool("tree", files, 0, False),
                               out, batch_size=256, dedupe_size=65536)
    finally:
        tier.close()
    return summary, [json.loads(line) for line in out.getvalue().splitlines()]


_TIMINGS = ("wall_s", "manifests_per_sec")


@pytest.mark.parametrize("pinned", [False, True], ids=["decided", "pinned"])
def test_fixture_tree_records_equal_jax(pinned):
    """The fixture tree (40 files, 2,000 manifests with exact duplicates)
    through both packages' in-process tier at loaders=0: the same
    summary (less timings) and the same records, origin for origin and
    outcome for outcome. Pinned, both drivers send every compiled kind's
    batches to the device path (the port's paths per kind: the 5
    review-pure kinds "device", the 2 joins "join"); as decided, the
    port's cost model keeps these batches on the interpreter."""
    got = {}
    for pkg, mod in (("jax", jscan), ("torch", scan_mod)):
        client, drv = _general_client(pkg, pinned)
        summary, recs = _tree_scan(mod, client)
        got[pkg] = ({k: v for k, v in summary.items() if k not in _TIMINGS},
                    recs, drv)
    (jsum, jrecs, jdrv), (tsum, trecs, tdrv) = got["jax"], got["torch"]
    assert tsum == jsum
    assert jsum["errors"] == 0 and jsum["deduped"] > 0 and jsum["denied"] > 0
    assert len(trecs) == len(jrecs) == jsum["manifests"]
    assert trecs == jrecs
    paths = {}
    for (kind, path) in tdrv._eval_counts:
        paths.setdefault(kind, set()).add(path)
    compiled = {"device"} if pinned else {"interp"}
    assert paths == {**dict.fromkeys(
        ("K8sAllowedRepos", "K8sContainerLimits", "K8sContainerRatios",
         "K8sHttpsOnly", "K8sRequiredLabels"), compiled),
        "K8sUniqueIngressHost": {"join"}, "K8sUniqueServiceSelector": {"join"}}
    assert bool(tdrv.pinned) == bool(jdrv.pinned) == pinned
    assert sorted(tdrv.pinned) == sorted(jdrv.pinned)


def _c16_scan(main, work: str, extra: list) -> tuple[int, dict, list]:
    summary_path = os.path.join(work, f"s{len(os.listdir(work))}.json")
    out = summary_path + ".jsonl"
    rc = main([os.path.join(work, "inventory.jsonl"), "--format", "jsonl",
               "--loaders", "2", "--batch", "256", "--depth", "2",
               "--dedupe", "65536", "--output", out, "--summary",
               summary_path] + extra)
    with open(summary_path) as f:
        summary = json.load(f)
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    return rc, {k: v for k, v in summary.items() if k not in _TIMINGS}, recs


def test_config16_jsonl_equal_jax(tmp_path):
    """A config-16-shaped export (300 unique synth_mixed_objects x 8 in
    config16's shuffle, written by the port's parallel/workload.py)
    through both packages' scan_main with 2 loaders: equal exit codes and
    summaries (less timings), and equal records up to which copy of an
    object was the evaluated one (scan_digest)."""
    work = str(tmp_path)
    assert c16_jsonl(os.path.join(work, "inventory.jsonl"), 2400) \
        == (2400, 300)
    c16_constraints_yaml(os.path.join(work, "constraints.yaml"))
    pols = ["--policies", os.path.join(work, "constraints.yaml")]
    jrc, jsum, jrecs = _c16_scan(jscan.scan_main, work, pols + [
        "--policies", os.path.join(ROOT, "gatekeeper_tpu", "policies",
                                   "general")])
    trc, tsum, trecs = _c16_scan(scan_mod.scan_main, work, pols + [
        "--policies", os.path.join(ROOT, "gatekeeper_tpu_torch",
                                   "policies", "general"),
        "--device", "cpu"])
    assert (trc, tsum) == (jrc, jsum)
    assert jrc == 1 and jsum["manifests"] == 2400
    assert jsum["unique_evaluated"] == 300 and jsum["errors"] == 0
    assert scan_digest(trecs) == scan_digest(jrecs)
    assert sorted(r["origin"] for r in trecs) \
        == sorted(r["origin"] for r in jrecs)


def test_preview_constraint_equal_jax(tmp_path):
    """--preview-constraint with --preview-template: both packages ingest
    the candidate under the same <Kind>PV<sha12> alias and give the same
    records and exit code."""
    from tests.test_client import REQUIRED_LABELS_TEMPLATE

    tpl = tmp_path / "template.yaml"
    tpl.write_text(yaml.safe_dump(REQUIRED_LABELS_TEMPLATE))
    con = tmp_path / "constraint.yaml"
    con.write_text(yaml.safe_dump(
        {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
         "kind": "K8sRequiredLabelsTest", "metadata": {"name": "cand"},
         "spec": {"parameters": {"labels": ["owner"]}}}))
    src = tmp_path / "src"
    src.mkdir()
    with open(src / "m.yaml", "w") as f:
        yaml.safe_dump_all([_pod("nolabel"), _pod("ok", labels={"owner": "x"}),
                            _pod("nolabel")], f)
    got = {}
    for pkg, mod, extra in (("jax", jscan, []),
                            ("torch", scan_mod, ["--device", "cpu"])):
        out = tmp_path / f"{pkg}.jsonl"
        summary = tmp_path / f"{pkg}.json"
        rc = mod.scan_main([str(src), "--loaders", "0", "--output", str(out),
                            "--summary", str(summary), "--preview-constraint",
                            str(con), "--preview-template", str(tpl)] + extra)
        s = json.loads(summary.read_text())
        got[pkg] = (rc, {k: v for k, v in s.items() if k not in _TIMINGS},
                    out.read_text().splitlines())
    assert got["torch"] == got["jax"]
    rc, s, lines = got["jax"]
    assert rc == 1 and s["preview"] is True and s["denied"] == 2
    # the alias each package compiles the candidate under
    aliases = []
    for pkg in ("jax", "torch"):
        client, _drv = _general_client(pkg, pinned=False)
        mod = jscan if pkg == "jax" else scan_mod
        aliases.append(mod.ingest_candidate(
            client, REQUIRED_LABELS_TEMPLATE,
            {"kind": "K8sRequiredLabelsTest",
             "spec": {"parameters": {"labels": ["owner"]}}}))
    assert aliases[0] == aliases[1]
    assert aliases[0].startswith("K8sRequiredLabelsTestPV")


def test_scan_without_device_raises_without_a_card(tmp_path):
    """The in-process engine runs on the card unless asked for the CPU:
    with no card visible, scan_main (and main's scan subcommand) without
    --device raise TorchDriver's DriverError and write no record; the
    JAX package's scan runs on its default device."""
    import torch

    from gatekeeper_tpu_torch.client.drivers import DriverError
    from gatekeeper_tpu_torch.control.main import main

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    src = tmp_path / "src"
    src.mkdir()
    with open(src / "m.yaml", "w") as f:
        yaml.safe_dump_all([_pod("no-labels")], f)
    pol = os.path.join(ROOT, "gatekeeper_tpu_torch", "policies", "general",
                       "requiredlabels.yaml")
    out = tmp_path / "out.jsonl"
    argv = [str(src), "--policies", pol, "--loaders", "0", "--output",
            str(out)]
    assert scan_mod.build_scan_parser().parse_args(argv).device == "cuda"
    with pytest.raises(DriverError, match="no CUDA card"):
        scan_main(argv)
    with pytest.raises(DriverError, match="no CUDA card"):
        main(["scan"] + argv)
    assert not out.exists()
    # with --device cpu the same scan runs (the template alone: allowed)
    assert scan_main(argv + ["--device", "cpu"]) == 0
    assert jscan.scan_main(argv) == 0


_PROBE = '''
import sys

from gatekeeper_tpu_torch.control import scan


class _Probe:
    """The loader's queue: before its ("done", shard) sentinel, one chunk
    naming the heavy modules this spawned process loaded."""

    def __init__(self, outq):
        self.outq = outq

    def put(self, item):
        if isinstance(item, tuple) and item and item[0] == "done":
            loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
                "torch", "jax", "jaxlib", "gatekeeper_tpu"))
            self.outq.put([("skip", "loaded:" + ",".join(loaded)),
                           ("skip", "main:" + scan._loader_main.__module__)])
        self.outq.put(item)


def probe_loader(fmt, paths, shard, nshards, encode, outq):
    scan._loader_main(fmt, paths, shard, nshards, encode, _Probe(outq))
'''


@pytest.mark.parametrize("encode", [False, True], ids=["inproc", "bytes"])
def test_spawned_loader_imports_neither_torch_nor_jax(tmp_path, monkeypatch,
                                                      encode):
    """A LoaderPool's spawned loader resolves the port's module and runs
    its parse, envelope synthesis and content keys (and, for the
    backplane tier, the pre-encoded envelope bytes) with neither torch
    nor jax (nor the JAX package) loaded."""
    (tmp_path / "probe_scan_loader.py").write_text(_PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    import probe_scan_loader

    monkeypatch.setattr(scan_mod, "_loader_main",
                        probe_scan_loader.probe_loader)
    src = tmp_path / "inv.jsonl"
    with open(src, "w") as f:
        for i in range(10):
            f.write(json.dumps(_pod(f"p{i % 4}")) + "\n")
    pool = LoaderPool("jsonl", [str(src)], 2, encode)
    recs = [rec for chunk in pool.chunks() for rec in chunk]
    pool.close()
    probes = [r[1] for r in recs if r[0] == "skip"]
    assert probes.count("loaded:") == 2, probes  # each loader, nothing
    assert probes.count("main:gatekeeper_tpu_torch.control.scan") == 2
    oks = [r for r in recs if r[0] == "ok"]
    assert len(oks) == 10
    assert all((r[4] is not None) == encode for r in oks)
    assert len({r[2] for r in oks}) == 4


_SITE = '''
import atexit
import os
import sys


def _record():
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "torch", "jax", "jaxlib", "gatekeeper_tpu"))
    path = os.path.join(os.environ["SCAN_LOADER_PROBE"], str(os.getpid()))
    with open(path, "w") as f:
        f.write(",".join(loaded))


# a process multiprocessing spawned (the scan's loaders) records, as it
# exits, the heavy modules it loaded
if "--multiprocessing-fork" in sys.argv:
    atexit.register(_record)
'''


def test_cli_loaders_import_neither_torch_nor_jax(tmp_path):
    """`python -m gatekeeper_tpu_torch.control.main scan`: its spawned
    loaders re-import control/main.py as their __main__ (multiprocessing's
    spawn), which therefore must not load torch at import. Each of the 2
    loaders records the heavy modules it loaded: none."""
    import subprocess
    import sys

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITE)
    probe = tmp_path / "probe"
    probe.mkdir()
    c16_jsonl(str(tmp_path / "inventory.jsonl"), 80)
    env = dict(os.environ, PYTHONPATH=f"{site}{os.pathsep}{ROOT}",
               SCAN_LOADER_PROBE=str(probe))
    proc = subprocess.run(
        [sys.executable, "-m", "gatekeeper_tpu_torch.control.main", "scan",
         str(tmp_path / "inventory.jsonl"), "--format", "jsonl",
         "--loaders", "2", "--device", "cpu", "--output",
         str(tmp_path / "out.jsonl"), "--policies",
         os.path.join(ROOT, "gatekeeper_tpu_torch", "policies", "general",
                      "requiredlabels.yaml")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert len((tmp_path / "out.jsonl").read_text().splitlines()) == 80
    loaded = [f.read_text() for f in probe.iterdir()]
    assert loaded == ["", ""], loaded
