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
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.target import K8sValidationTarget

client = Backend(TorchDriver(device="cpu")).new_client(
    [K8sValidationTarget()])
client.add_template(policies.load("general/requiredlabels"))
client.add_constraint({
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels", "metadata": {"name": "need-owner"},
    "spec": {"parameters": {"labels": [{"key": "owner"}]}}})
objs = [{"apiVersion": "v1", "kind": "Namespace",
         "metadata": {"name": f"ns{i}"}} for i in range(4)]
res = client.review_batch(objs)
print(json.dumps({
    "msgs": [[r.msg for r in resp.results()] for resp in res],
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
