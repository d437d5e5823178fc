"""The port imports neither jax nor the JAX package.

The main check runs in a subprocess: tests/conftest.py imports
gatekeeper_tpu (and jax) into every pytest process, so only a fresh
interpreter can show what the port itself loads. A source scan catches
imports on paths the subprocess does not run, and the host modules the
port copies verbatim are diffed against the JAX package's.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys
from gatekeeper_tpu_torch import policies
from gatekeeper_tpu_torch.client import Backend
from gatekeeper_tpu_torch.ir import TorchDriver, aot, join  # noqa: F401
from gatekeeper_tpu_torch.kernels import rows_update  # noqa: F401 (K5)
from gatekeeper_tpu_torch.ops import regex_nfa
from gatekeeper_tpu_torch.target import K8sValidationTarget
# the serving plane: the webhook, its metrics (build info rendered), the
# what-if preview and the mutation system
import gatekeeper_tpu_torch.control  # noqa: F401
from gatekeeper_tpu_torch.control import metrics, preview  # noqa: F401
import gatekeeper_tpu_torch.mutation  # noqa: F401
# the profiler, the lockset tracer, the Rego formatter, the demo and the
# reconcile controllers with their resilience layer
from gatekeeper_tpu_torch.utils import locktrace, profiling  # noqa: F401
from gatekeeper_tpu_torch.rego import format as rego_format  # noqa: F401
from gatekeeper_tpu_torch.policies import demo  # noqa: F401
from gatekeeper_tpu_torch.control import (  # noqa: F401
    ControllerManager, controllers, resilience)
# the audit manager with its inventory tracker and the sharded plane
from gatekeeper_tpu_torch.control import AuditManager
from gatekeeper_tpu_torch.control.audit import ShardedAuditPlane
from gatekeeper_tpu_torch.control.kube import FakeKube
# the multi-process plane (frontends, engines, audit shards, the
# adaptive controller) and the policy service
from gatekeeper_tpu_torch.control import (  # noqa: F401
    adaptive, backplane, engine, liveness, stages)
from gatekeeper_tpu_torch import service  # noqa: F401
# the offline fleet scan
from gatekeeper_tpu_torch.control import scan  # noqa: F401
metrics.report_build_info()
build_info = [line for line in metrics.REGISTRY.render().splitlines()
              if line.startswith("gatekeeper_tpu_build_info{")]

# force the regex scan (K3) and join membership (K4) paths
regex_nfa.DEVICE_CROSSOVER = 1
join.JoinCompiled.MIN_DEVICE_REVIEWS = 1
drv = TorchDriver(device="cpu")
client = Backend(drv).new_client([K8sValidationTarget()])
client.add_template(policies.load("general/requiredlabels"))
client.add_constraint({
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels", "metadata": {"name": "need-owner"},
    "spec": {"parameters": {"labels": [{"key": "owner",
                                        "allowedRegex": "^[a-z]+$"}]}}})
objs = [{"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": f"ns{i}"}} for i in range(4)]
res = client.review_batch(objs)
timers0 = profiling.timers().snapshot()
# the churn audit: a delta-served audit, then churn plus a constraint
# edit, which patches the cached features (K5's path)
for o in objs:
    client.add_data(o)
paths = []
for step in range(3):
    if step == 2:
        client.add_data({**objs[1], "metadata": {
            "name": "ns1", "labels": {"owner": "x"}}})
        client.add_constraint({
            "apiVersion": "constraints.gatekeeper.sh/v1beta1",
            "kind": "K8sRequiredLabels", "metadata": {"name": "need-owner"},
            "spec": {"parameters": {"labels": [
                {"key": "owner", "allowedRegex": "^[a-y]+$"}]}}})
    n_res = len(client.audit().results())
    paths.append([drv.last_audit_path, n_res])
client.add_template(policies.load("general/uniqueingresshost"))
client.add_constraint({
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sUniqueIngressHost", "metadata": {"name": "hosts"}})
for name in ("a", "b"):
    client.add_data({"apiVersion": "networking.k8s.io/v1", "kind": "Ingress",
                     "metadata": {"name": name, "namespace": "ns0"},
                     "spec": {"rules": [{"host": "x.com"}]}})
# the audit manager's sweeps (their lazy imports included): discovery
# through review_batch, then incremental over the inventory tracker,
# each writing the constraint's status; the sharded plane's ring
kube = FakeKube()
kube.register_kind(("", "v1", "Namespace"), namespaced=False)
for o in objs:
    kube.create(dict(o))
mclient = Backend(TorchDriver(device="cpu")).new_client(
    [K8sValidationTarget()])
mclient.add_template(policies.load("general/requiredlabels"))
need_owner = {"apiVersion": "constraints.gatekeeper.sh/v1beta1",
              "kind": "K8sRequiredLabels", "metadata": {"name": "need-owner"},
              "spec": {"parameters": {"labels": [{"key": "owner"}]}}}
mclient.add_constraint(need_owner)
kube.apply(dict(need_owner))
sweeps = []
for kw in ({}, {"incremental": True}):
    mgr = AuditManager(kube, mclient, gc_stale_statuses=False, **kw)
    n_sweep = len(mgr.audit_once())
    status = kube.get(("constraints.gatekeeper.sh", "v1beta1",
                       "K8sRequiredLabels"), "need-owner")["status"]
    sweeps.append([n_sweep, status["totalViolations"]])
    mgr.stop()
shards = ShardedAuditPlane(FakeKube(), mclient, None, 2).shard_count
print(json.dumps({
    "sweeps": sweeps, "shards": shards,
    "audit": sorted((r.resource or {}).get("metadata", {}).get("name")
                    for r in client.audit().results()
                    if r.constraint["kind"] == "K8sUniqueIngressHost"),
    "msgs": [[r.msg for r in resp.results()] for resp in res],
    "paths": paths,
    "build_info": build_info,
    "phases": sorted(profiling.PhaseTimers.diff(
        timers0, profiling.timers().snapshot())),
    "loaded": sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "gatekeeper_tpu"
                     or m.startswith("gatekeeper_tpu.")),
}))
"""


def test_port_loads_no_jax_and_no_jax_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["msgs"] == [["you must provide labels: {\"owner\"}"]] * 4
    assert out["audit"] == ["a", "b"]
    assert out["sweeps"] == [[4, 4], [4, 4]] and out["shards"] == 2
    assert out["paths"] == [["single(cpu)", 4], ["delta(1/1)", 4],
                            ["single(cpu)", 3]]
    # the audits' phases (profiling.timers()), recorded at the
    # reference's sites (the cost model keeps these 4 objects on the host)
    assert {"delta_serve", "interp_eval"} <= set(out["phases"])
    # one build-info series, naming torch and the card in place of jax
    (info,) = out["build_info"]
    assert 'torch_version="' in info and 'cuda_version="' in info
    assert 'device="' in info and 'device_count="' in info
    assert "jax" not in info and "platform" not in info


# `import jax`, `from gatekeeper_tpu.x import y`, `import gatekeeper_tpu`,
# at any indent (imports inside function bodies included), or by name
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|gatekeeper_tpu)(?:[.\s]|$)"
    r"|import_module\(\s*[\"'](?:jax|gatekeeper_tpu)[.\"']",
    re.MULTILINE)


def test_port_sources_import_no_jax_and_no_jax_package():
    files = sorted((ROOT / "gatekeeper_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "batch_profile.py"]
    assert len(files) > 50
    # the entry point, rewired from the JAX package's (TorchDriver, the
    # card count, torch.profiler), is scanned like every other module
    assert ROOT / "gatekeeper_tpu_torch" / "control" / "main.py" in files
    hits = [f"{f.relative_to(ROOT)}:{m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []
    # the scan itself finds what it must
    assert _FORBIDDEN.search("    import jax\n")
    assert _FORBIDDEN.search("from gatekeeper_tpu.control import x\n")
    assert not _FORBIDDEN.search("from gatekeeper_tpu_torch import x\n")


# the audit mesh and K6's wrapper: each, imported alone in a fresh
# interpreter, loads neither jax nor the JAX package, and the source scan
# above covers it
MESH_MODULES = ["gatekeeper_tpu_torch.parallel.mesh",
                "gatekeeper_tpu_torch.parallel.collectives",
                "gatekeeper_tpu_torch.kernels.shard_counts"]


@pytest.mark.parametrize("module", MESH_MODULES)
def test_mesh_modules_load_no_jax(module):
    rel = pathlib.Path(*module.split(".")).with_suffix(".py")
    assert (ROOT / rel).exists()
    assert not _FORBIDDEN.search((ROOT / rel).read_text())
    code = ("import importlib, json, sys\n"
            f"importlib.import_module({module!r})\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'gatekeeper_tpu' or "
            "m.startswith('gatekeeper_tpu.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


# a module path in a string the port could hand to `python -m` or put
# on a child's command line: a JAX package module there would serve
# from the reference, and no import scan sees it. Metric names
# (gatekeeper_tpu_engine_requests_total) and the port's own paths pass.
_SPAWNS_JAX = re.compile(r"""["']gatekeeper_tpu\.|-m\s+["']?gatekeeper_tpu\.""")


def _spawn_hits(files) -> list:
    return [f"{f.name}:{text.count(chr(10), 0, m.start()) + 1}"
            for f in files for text in [f.read_text()]
            for m in _SPAWNS_JAX.finditer(text)]


def test_port_spawns_no_jax_package_module(tmp_path):
    files = sorted((ROOT / "gatekeeper_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "batch_profile.py"]
    assert ROOT / "gatekeeper_tpu_torch" / "control" / "backplane.py" in files
    assert _spawn_hits(files) == []
    assert _SPAWNS_JAX.search('cmd = [sys.executable, "-m", '
                              '"gatekeeper_tpu.control.engine"]')
    assert _SPAWNS_JAX.search("python -m gatekeeper_tpu.service")
    assert not _SPAWNS_JAX.search('"-m", "gatekeeper_tpu_torch.control.engine"')
    assert not _SPAWNS_JAX.search('"gatekeeper_tpu_engine_requests_total"')
    # the scan fails on a verbatim copy of the reference's backplane.py:
    # its frontends, engine children and audit shards (:1886, :2178,
    # :2654) and the two docstrings naming them
    copy = tmp_path / "backplane.py"
    copy.write_text((ROOT / "gatekeeper_tpu" / "control" /
                     "backplane.py").read_text())
    hits = _spawn_hits([copy])
    assert {"backplane.py:1886", "backplane.py:2178",
            "backplane.py:2654"} <= set(hits), hits
    assert len(hits) == 5


def _drop_function(text: str, name: str) -> str:
    """`text` without the top-level function `name` (to the next
    top-level def)."""
    start = text.index(f"\ndef {name}(")
    end = text.index("\ndef ", start + 1)
    return text[:start] + text[end:]


# the host modules the port copies verbatim, and the lines allowed to
# differ: logger names, the build-info gauge (torch, CUDA and the card in
# place of jax and its platform), and the history citations (_uncite)
VERBATIM = ["control/" + m for m in (
    "config_types.py", "jsonio.py", "kube.py", "logging.py", "metrics.py",
    "preview.py", "shardmap.py", "trace.py", "util.py", "watch.py",
    "webhook.py")] + ["mutation/" + m for m in (
        "__init__.py", "mutators.py", "patch.py", "path.py", "system.py")] \
    + ["client/drivers.py", "utils/locktrace.py", "rego/format.py",
       "control/resilience.py", "control/controllers.py",
       "control/audit.py", "control/__init__.py"] \
    + ["control/" + m for m in (
        "upgrade.py", "health.py", "certs.py", "slo.py", "shm.py",
        "chaos.py", "statestore.py")] \
    + ["control/" + m for m in (
        "liveness.py", "stages.py", "backplane.py", "engine.py",
        "adaptive.py")] \
    + ["service/" + m for m in (
        "__init__.py", "server.py", "client.py", "__main__.py")] \
    + ["control/scan.py"]

# docstrings the port words for itself: per file, (a pattern of the
# reference's text, the port's text)
WORDING = {
    "control/slo.py": [(
        r"PR \d+ gave the serving plane per-stage latency histograms and "
        r"PR \d+'s\nsaturation gauges",
        "The serving plane's per-stage latency histograms and its\n"
        "saturation gauges")],
    # the program store keys its entries on what a Triton kernel
    # cannot cross (ir/aot.py _platform_key)
    "control/statestore.py": [(
        r"the per-\(backend, device-count, jax-version\) subdirs\.",
        "the per-(compute capability, device count, torch/CUDA/Triton\n"
        "        versions) subdirs.")],
    # two citations of the JAX package's change history, worded
    "control/adaptive.py": [(
        r"was a hand-tuned constant: PR \d+ made saturation legible "
        r"\(seal\nreasons, fill ratios, queue depths, duty cycle, burn "
        r"rates\) and PR\n\d+'s scrape proved the plane edge-bound,",
        "was a hand-tuned constant: the plane's gauges made saturation "
        "legible\n(seal reasons, fill ratios, queue depths, duty cycle, "
        "burn rates) and a\nscrape of them proved the plane edge-bound,")],
    "control/engine.py": [(r"The PR \d+-\d+ serving contracts",
                           "The serving contracts")],
    # the audit's phases on the card (K2 and K1 in place of XLA)
    "control/stages.py": [
        (r'"XLA sweep dispatch \+ device wait"',
         '"K2 + K1 launches on the card + the wait for each "\n'
         '        "slab\'s pairs"'),
        (r'"XLA program acquisition \(AOT deserialize or "\n'
         r'        "lower\+compile\)"',
         '"K2 variant acquisition (program store load or "\n'
         '        "Triton compile)"')],
    # the loaders import neither torch nor jax; a preview's program
    # identity is served by the program store and Triton's cache
    "control/scan.py": [
        (r"Never imports jax or the serving stack\.",
         "Never imports torch or the serving stack."),
        (r"the AOT store and XLA cache serve both\.",
         "the program store and Triton's cache\n    serve both.")],
}

# code the port rewires, per file: (the port's text, the reference's,
# how many times it occurs). Each is a recorded difference (ROADMAP C).
REWIRES = {
    # C2: each status writer's conflict refresh overlays its own keys on
    # the live status
    "control/controllers.py": [
        ("from .audit import AUDIT_STATUS_KEYS\n", "", 1),
        ('''\
        # a conflict means another writer landed first: put back every
        # key of this write but the audit's, which stay as they live
        # (a byPod write prepared before an audit sweep's status write
        # must not erase its totals)
        live = cur.get("status") or {}
        status = {k: v for k, v in (cur_obj.get("status") or {}).items()
                  if k not in AUDIT_STATUS_KEYS}
        status.update((k, live[k]) for k in AUDIT_STATUS_KEYS if k in live)
        cur["status"] = status
''', '        cur["status"] = cur_obj.get("status")\n', 1)],
    "control/audit.py": [
        ('''\
# the keys of a constraint's status the audit writes; a status write
# retried on a conflict overlays its own keys on the live status
# (the audit these, the controllers every other)
AUDIT_STATUS_KEYS = ("auditTimestamp", "totalViolations", "violations")
''', "", 1),
        ('''\
            # a conflict means another writer landed first: overlay
            # this sweep's keys on the live status and keep the rest
            # (the controllers' byPod)
            live = dict(cur.get("status") or {})
            live.update((k, status[k]) for k in AUDIT_STATUS_KEYS)
            cur["status"] = live
''', '            cur["status"] = status\n', 1)],
    # the children the plane spawns are the port's modules
    "control/backplane.py": [
        ("gatekeeper_tpu_torch.control.", "gatekeeper_tpu.control.", 5),
        # C3: a failed start waits for each child it killed
        ('''\
REAP_TIMEOUT_S = 10.0


def _reap_failed_start(procs, what: str) -> None:
    """Kill and wait, REAP_TIMEOUT_S each, for every child of a start
    that failed: a child that raised before READY may still be tearing
    down its interpreter when its stdout closes, and a start that
    returns must leave no live or unreaped child behind (child_pids is
    the leak baseline)."""
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
    for proc in procs:
        if proc is None:
            continue
        try:
            proc.wait(REAP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            log.warning("failed start: child outlived its kill",
                        details={"child": what, "pid": proc.pid,
                                 "timeout_s": REAP_TIMEOUT_S})


''', "", 1),
        ('''\
            self._stopping.set()
            _reap_failed_start(self._procs, "admission frontend")
''', '''\
            self._stopping.set()
            for proc in self._procs:
                if proc is not None and proc.poll() is None:
                    proc.kill()
''', 1),
        ('''\
            self._stopping.set()
            _reap_failed_start(list(self._procs.values()),
                               "admission engine")
''', '''\
            self._stopping.set()
            for proc in self._procs.values():
                if proc is not None and proc.poll() is None:
                    proc.kill()
''', 1)],
    # one engine process on TorchDriver; --device takes a card index or
    # a device string (engine_device)
    "control/engine.py": [
        ('''\
`python -m gatekeeper_tpu_torch.control.engine --socket S --engine-id K
--device K ...` builds a full evaluation stack — TorchDriver pinned to
ONE card,''', '''\
`python -m gatekeeper_tpu.control.engine --socket S --engine-id K
--device K ...` builds a full evaluation stack — TpuDriver pinned to
ONE chip,''', 1),
        ('''\
def engine_device(flag: str) -> str:
    """The torch device of `--device`: card index k as
    cuda:{k % torch.cuda.device_count()} (-1: the current card), else
    the device string itself (`cpu`, `cuda:1`). With no card visible an
    index gives `cuda`, on which TorchDriver raises: a child never
    evaluates on the host unless asked to."""
    try:
        k = int(flag)
    except ValueError:
        return flag
    import torch

    n = torch.cuda.device_count()
    return f"cuda:{k % n}" if k >= 0 and n else "cuda"


''', "", 1),
        ('''\
    p.add_argument("--device", default="-1",
                   help="the card this engine pins its evaluation to: "
                        "an index k (cuda:k modulo the visible cards; "
                        "-1 = the current card), or cpu (the kernels' "
                        "plain versions, for tests). No fallback: a card "
                        "asked for where none is visible fails the "
                        "start")''', '''\
    p.add_argument("--device", type=int, default=-1,
                   help="index into jax.devices() this engine pins its "
                        "evaluation to; -1 = the platform default")''', 1),
        ("    from ..ir import TorchDriver\n",
         "    from ..ir import TpuDriver\n", 1),
        ("    driver = TorchDriver(device=engine_device(args.device))",
         "    driver = TpuDriver(device=args.device if args.device >= 0 "
         "else None)", 1)],
    # the service's driver is TorchDriver on `device` (the card by
    # default), and its CLI and docstrings name the port
    "service/__init__.py": [
        ("gatekeeper_tpu_torch.service", "gatekeeper_tpu.service", 1)],
    "service/client.py": [
        ("gatekeeper_tpu_torch.client", "gatekeeper_tpu.client", 2)],
    # the in-process engine is TorchDriver on `device` (the card by
    # default; --device), Triton's cache in place of XLA's, and no
    # force_durable (the program store keeps K2's variants as files)
    "control/scan.py": [
        ('                      client=None, device: str = "cuda") '
         '-> InprocTier:',
         "                      client=None) -> InprocTier:", 1),
        ('''\
        if compile_cache_dir:
            os.environ.setdefault("TRITON_CACHE_DIR", compile_cache_dir)
        from ..client import Backend
        from ..ir import TorchDriver
        from ..target import K8sValidationTarget

        # the card unless the caller asks for the CPU: TorchDriver
        # raises where none is visible
        driver = TorchDriver(device=device, aot_dir=aot_dir or None)
''', '''\
        if compile_cache_dir:
            os.environ["GATEKEEPER_TPU_COMPILE_CACHE"] = \\
                compile_cache_dir
        from ..client import Backend
        from ..ir import TpuDriver
        from ..target import K8sValidationTarget

        driver = TpuDriver(aot_dir=aot_dir) if aot_dir else TpuDriver()
        if aot_dir and hasattr(driver, "aot"):
            # like warm-cache: mint durable executables so the NEXT
            # scan boots warm even when the XLA cache answered this one
            driver.aot.force_durable = True
''', 1),
        ('''\
                   help="persistent Triton kernel cache dir "
                        "(TRITON_CACHE_DIR, unless it is set already)")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-batch verdict deadline seconds (a cold "
                        "first batch may wait out one K2 compile)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the in-process engine: cuda "
                        "(the card, the default; raises where none is "
                        "visible) or cpu (the kernels' plain versions, "
                        "for tests). No fallback")''', '''\
                   help="persistent XLA compile cache dir")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="per-batch verdict deadline seconds (a cold "
                        "first batch may wait out one XLA compile)")''', 1),
        ("decision_cache=args.decision_cache, device=args.device,",
         "decision_cache=args.decision_cache,", 1)],
    "service/server.py": [
        ("from ..ir import TorchDriver\n", "from ..ir import TpuDriver\n",
         1),
        ('''\
                driver: str = "torch", max_workers: int = 8,
                expose: Optional[tuple] = None, device: str = "cuda"):''',
         '''\
                driver: str = "tpu", max_workers: int = 8,
                expose: Optional[tuple] = None):''', 1),
        ('''
    the Runtime's evaluation-only bulk ingest port). `device` is the
    torch device of the driver built here: cuda (the card; raises where
    none is visible) or cpu."""
    if client is None:
        drv = (TorchDriver(device=device) if driver == "torch"
               else RegoDriver())''', '''
    the Runtime's evaluation-only bulk ingest port)."""
    if client is None:
        drv = TpuDriver() if driver == "tpu" else RegoDriver()''', 1),
        ('''\
def serve(address: str = "127.0.0.1:50061", driver: str = "torch",
          device: str = "cuda") -> None:
    """Blocking entry point (`python -m gatekeeper_tpu_torch.service`)."""
    server, port = make_server(address=address, driver=driver,
                               device=device)''', '''\
def serve(address: str = "127.0.0.1:50061", driver: str = "tpu") -> None:
    """Blocking entry point (`python -m gatekeeper_tpu.service`)."""
    server, port = make_server(address=address, driver=driver)''', 1)],
    "service/__main__.py": [
        ('''\
"""CLI entry: python -m gatekeeper_tpu_torch.service [--address A]
[--driver D] [--device DEV]"""''', '''\
"""CLI entry: python -m gatekeeper_tpu.service [--address A] [--driver D]"""''',
         1),
        ('''\
    p.add_argument("--driver", default="torch", choices=["torch", "rego"],
                   help="evaluation backend")
    p.add_argument("--device", default="cuda",
                   help="torch device of the torch driver: cuda (the "
                        "card, the default; raises where none is "
                        "visible) or cpu")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    serve(address=args.address, driver=args.driver, device=args.device)''',
         '''\
    p.add_argument("--driver", default="tpu", choices=["tpu", "rego"],
                   help="evaluation backend")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    serve(address=args.address, driver=args.driver)''', 1)],
}


def _uncite(text: str) -> str:
    """`text` without the citations of the JAX package's own change
    history in its docstrings (a pull request's number, the issue),
    which the port's copies leave out."""
    text = re.sub(r"(?m)^PR \d+ (\w)", lambda m: m.group(1).upper(), text)
    text = re.sub(r"(?m)^(\s*)PR \d+'s ", r"\1The ", text)
    text = re.sub(r"\bPR \d+'s ", "the ", text)
    return re.sub(r"\b(?:PR \d+|ISSUE's) ", "", text)


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_reference(rel):
    ref = (ROOT / "gatekeeper_tpu" / rel).read_text()
    port = (ROOT / "gatekeeper_tpu_torch" / rel).read_text()
    port = port.replace('logging.getLogger("gatekeeper_tpu_torch.',
                        'logging.getLogger("gatekeeper_tpu.')
    for port_text, ref_text, count in REWIRES.get(rel, ()):
        assert port.count(port_text) == count, (rel, port_text)
        port = port.replace(port_text, ref_text)
    for pattern, wording in WORDING.get(rel, ()):
        ref, n = re.subn(pattern, lambda _m: wording, ref)
        assert n == 1, (rel, pattern)
    ref = _uncite(ref)
    if rel == "control/metrics.py":
        assert "import torch" in port and "import jax" in ref
        ref = _drop_function(ref, "report_build_info")
        port = _drop_function(port, "report_build_info")
    assert port == ref


def test_profiling_copies_phase_timers():
    """utils/profiling.py keeps the JAX package's PhaseTimers and
    timers() verbatim (compiled_hlo and device_trace are rewritten for
    Triton and torch.profiler)."""
    def timers_part(text: str) -> str:
        return text[text.index("\nclass PhaseTimers:"):]

    ref = (ROOT / "gatekeeper_tpu" / "utils" / "profiling.py").read_text()
    port = (ROOT / "gatekeeper_tpu_torch" / "utils" /
            "profiling.py").read_text()
    assert timers_part(port) == timers_part(ref)


LOCKTRACE_CHILD = r"""
import json, sys, threading
order = sys.argv[1].split(",")
for name in order:
    __import__(name)
from gatekeeper_tpu_torch.control import audit, controllers, kube
from gatekeeper_tpu_torch.control import resilience
from gatekeeper_tpu_torch.kernels import clause_triton
from gatekeeper_tpu_torch.utils import locktrace as tlt

def layers(lock):
    n = 0
    while hasattr(lock, "_real"):
        n, lock = n + 1, lock._real
    return n, type(lock).__module__ + "." + type(lock).__name__

breaker = resilience.CircuitBreaker("locktrace-probe")
mgr = audit.AuditManager(kube.FakeKube(), None)
held = [threading.Lock(), threading.RLock(), breaker._lock,
        clause_triton._lock, mgr._sweep_lock, mgr._status_lock._lock]
# one lock-order inversion (two allocation sites, two lines): a finding
# each tracer would write to the out file
a = threading.Lock()
b = threading.Lock()
with a:
    with b:
        pass
with b:
    with a:
        pass
out = {"layers": [layers(lk) for lk in held],
       "tracers": [type(lk).__module__ for lk in held],
       "port_tracer": tlt.tracer() is not None}
if "gatekeeper_tpu" in order:
    from gatekeeper_tpu.utils import locktrace as jlt
    out["jax_tracer"] = jlt.tracer() is not None
print(json.dumps(out))
"""


@pytest.mark.parametrize("order", ["gatekeeper_tpu,gatekeeper_tpu_torch",
                                   "gatekeeper_tpu_torch"])
def test_locktrace_wraps_each_lock_once(order, tmp_path):
    """GATEKEEPER_TPU_LOCKTRACE=1 arms the lockset tracer in the
    package's __init__. With the JAX package imported first (as the
    suite's conftest does), its tracer is the process's and the port's
    hook stands down: every lock, the port's included, is wrapped once,
    and one tracer dumps at exit. The port alone installs its own."""
    out_file = tmp_path / "locktrace.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               GATEKEEPER_TPU_LOCKTRACE="1",
               GATEKEEPER_TPU_LOCKTRACE_OUT=str(out_file))
    proc = subprocess.run([sys.executable, "-c", LOCKTRACE_CHILD, order],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(n == 1 for n, _real in got["layers"]), got
    assert {real for _n, real in got["layers"]} == {
        "_thread.lock", "_thread.RLock"}
    owner = order.split(",")[0] + ".utils.locktrace"
    assert set(got["tracers"]) == {owner}
    assert got["port_tracer"] is (order == "gatekeeper_tpu_torch")
    if "jax_tracer" in got:
        assert got["jax_tracer"] is True
    # the inversion recorded once as it happened, and its cycle once at
    # exit: by the one tracer
    lines = [json.loads(line) for line in out_file.read_text().splitlines()]
    assert [f["kind"] for f in lines] == ["inversion", "cycle"]


# an import hook that makes `import jax` and `import gatekeeper_tpu` raise
# in the child, whatever is installed
_BLOCK_JAX = r"""
import sys


class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "gatekeeper_tpu"):
            raise ImportError(f"{name} is blocked in this process")
        return None


sys.meta_path.insert(0, _Blocked())
"""

ENTRY_CHILD = _BLOCK_JAX + r"""
import json, os, sys
state = sys.argv[1]
from gatekeeper_tpu_torch.control.main import (Runtime, build_parser,
                                               warm_cache_main)
args = build_parser().parse_args([
    "--fake-kube", "--device", "cpu", "--port", "0", "--health-addr", ":0",
    "--prometheus-port", "0", "--disable-cert-rotation", "--state-dir",
    state, "--audit-incremental", "true", "--audit-interval", "9999"])
rt = Runtime(args)
rt.start()
rt.stop()
code = warm_cache_main(["--state-dir", state, "--device", "cpu"])
print(json.dumps({"code": code, "sections": sorted(os.listdir(state)),
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in
                                   ("jax", "jaxlib", "gatekeeper_tpu"))}))
"""


def test_entry_point_runs_where_jax_cannot_be_imported(tmp_path):
    """`python -m gatekeeper_tpu_torch.control.main --help` in a process
    where importing jax (or the JAX package) raises; then, in another,
    a Runtime on the CPU through start() and stop() (its drain snapshot
    and every lazy import on that path) and warm-cache on its state."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    help_child = _BLOCK_JAX + (
        "import runpy\n"
        "sys.argv = ['gatekeeper_tpu_torch.control.main', '--help']\n"
        "runpy.run_module('gatekeeper_tpu_torch.control.main', "
        "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", help_child], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--device" in proc.stdout and "--state-dir" in proc.stdout
    assert "NVIDIA card" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-c", ENTRY_CHILD, str(tmp_path / "state")],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["code"] == 0 and out["loaded"] == []
    assert {"aot", "library.snapshot.json",
            "vocab.snapshot.json"} <= set(out["sections"])
