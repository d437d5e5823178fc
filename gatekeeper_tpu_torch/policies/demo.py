"""Self-contained policy demo: `python -m gatekeeper_tpu_torch.policies.demo`.

Loads the shipped library, applies a few constraints, then shows the two
evaluation paths a cluster would exercise:
  * admission review of a compliant and a violating Pod;
  * an audit sweep over synced inventory.
The framework analog of the reference's demo/basic walkthrough. It
evaluates on the card; `--device cpu` asks for the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional

from gatekeeper_tpu_torch import policies
from gatekeeper_tpu_torch.client import Backend
from gatekeeper_tpu_torch.ir import TorchDriver
from gatekeeper_tpu_torch.target import (AugmentedUnstructured,
                                         K8sValidationTarget)


def pod(name: str, image: str, privileged: bool = False) -> dict:
    ctx = {"privileged": True} if privileged else {}
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name, "namespace": "default",
                     "labels": {"app": name}},
        "spec": {"containers": [{
            "name": "main", "image": image,
            "securityContext": ctx,
        }]},
    }


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description="The policy demo.")
    ap.add_argument("--device", default="cuda",
                    help="the torch device TorchDriver evaluates on "
                    "(default: cuda, the card)")
    args = ap.parse_args(argv)
    driver = TorchDriver(device=args.device)
    client = Backend(driver).new_client([K8sValidationTarget()])
    for name in policies.names():
        client.add_template(policies.load(name))
    print(f"installed {len(policies.names())} templates:",
          ", ".join(policies.names()[:4]), "...")

    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sAllowedRepos", "metadata": {"name": "corp-repos-only"},
        "spec": {"parameters": {"repos": ["registry.corp.example/"]}},
    })
    client.add_constraint({
        "apiVersion": "constraints.gatekeeper.sh/v1beta1",
        "kind": "K8sPSPPrivilegedContainer",
        "metadata": {"name": "no-privileged"},
        "spec": {},
    })

    print("\n--- admission ---")
    for p in (pod("good", "registry.corp.example/api:v1"),
              pod("rogue", "docker.io/evil:latest", privileged=True)):
        results = client.review(AugmentedUnstructured(p)).results()
        verdict = "ALLOWED" if not results else "DENIED"
        print(f"{p['metadata']['name']:>6}: {verdict}")
        for r in results:
            print(f"        [{r.constraint['metadata']['name']}] {r.msg}")

    print("\n--- audit ---")
    for p in (pod("legacy-a", "docker.io/old:1"),
              pod("legacy-b", "registry.corp.example/ok:2", privileged=True)):
        client.add_data(p)
    for r in client.audit().results():
        print(f"{r.resource['metadata']['name']:>8}: "
              f"[{r.constraint['metadata']['name']}] {r.msg}")


if __name__ == "__main__":
    main()
