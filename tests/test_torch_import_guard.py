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
    hits = [f"{f.relative_to(ROOT)}:{m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert hits == []
    # the scan itself finds what it must
    assert _FORBIDDEN.search("    import jax\n")
    assert _FORBIDDEN.search("from gatekeeper_tpu.control import x\n")
    assert not _FORBIDDEN.search("from gatekeeper_tpu_torch import x\n")


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
       "control/audit.py", "control/__init__.py"]


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
