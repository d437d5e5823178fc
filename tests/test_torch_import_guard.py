"""The port imports neither jax nor the JAX package.

Runs in a subprocess: tests/conftest.py imports gatekeeper_tpu (and jax)
into every pytest process, so only a fresh interpreter can show what the
port itself loads.
"""

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
from gatekeeper_tpu_torch import policies
from gatekeeper_tpu_torch.client import Backend
from gatekeeper_tpu_torch.ir import TorchDriver, aot, join  # noqa: F401
from gatekeeper_tpu_torch.kernels import rows_update  # noqa: F401 (K5)
from gatekeeper_tpu_torch.ops import regex_nfa
from gatekeeper_tpu_torch.target import K8sValidationTarget

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
print(json.dumps({
    "audit": sorted((r.resource or {}).get("metadata", {}).get("name")
                    for r in client.audit().results()
                    if r.constraint["kind"] == "K8sUniqueIngressHost"),
    "msgs": [[r.msg for r in resp.results()] for resp in res],
    "paths": paths,
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
    assert out["paths"] == [["single(cpu)", 4], ["delta(1/1)", 4],
                            ["single(cpu)", 3]]
