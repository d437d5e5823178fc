"""BENCH configs 10 and 1 (bench_configs.py config10 and config1), for
chip_smoke.py's phase 21, tests/test_torch_scale.py and
tests/torch_reference_counts.py.

Config 10 is the flagship template with C10_CONSTRAINTS
synth_constraints(seed=1) over synth_objects(C10_OBJECTS,
C10_VIOLATE_FRAC, seed=0), on one device and over the default mesh.
Config 1 is general/requiredlabels with one allowedRegex constraint
(C1_CONSTRAINT, a copy of the one in bench_configs.config1, which
`bench_constraint` reads from that file's text) over
synth_objects(C1_OBJECTS, C1_VIOLATE_FRAC, seed=7). Beside them: an
audit's count per constraint and a digest of its results. Imports
neither jax nor the JAX package, so that the card's smoke can use it.
Not a test module (pytest does not collect it).
"""

from __future__ import annotations

import ast
import hashlib
import os

C10_OBJECTS = 1_000_000
C10_CONSTRAINTS = 100
C10_VIOLATE_FRAC = 0.002
C1_OBJECTS = 1000
C1_VIOLATE_FRAC = 0.02
C1_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "K8sRequiredLabels", "metadata": {"name": "must-own"},
    "spec": {"parameters": {"labels": [
        {"key": "owner", "allowedRegex": "^[a-z]+.corp.example$"}]}},
}

BENCH_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bench_configs.py")


def bench_constraint(config: str) -> dict:
    """The literal dict that bench_configs.py's function `config` assigns
    to `constraint`, read from the file's text (nothing is imported)."""
    with open(BENCH_CONFIGS) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == config)
    return next(ast.literal_eval(n.value) for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and
                [t.id for t in n.targets if isinstance(t, ast.Name)] ==
                ["constraint"])


def per_constraint_counts(results, constraints) -> list[int]:
    """Each constraint's result count, in the order of `constraints`
    (one template's: matched by name)."""
    at = {c["metadata"]["name"]: k for k, c in enumerate(constraints)}
    out = [0] * len(constraints)
    for r in results:
        out[at[r.constraint["metadata"]["name"]]] += 1
    return out


def result_digest(results) -> str:
    """sha256 over an audit's (constraint kind and name, object name,
    message) triples, sorted: equal for equal result sets whatever the
    order a driver emits them in."""
    rows = sorted(
        (r.constraint["kind"], r.constraint["metadata"]["name"],
         ((r.resource or {}).get("metadata") or {}).get("name", ""),
         r.msg)
        for r in results)
    h = hashlib.sha256()
    for row in rows:
        h.update(("\t".join(row) + "\n").encode())
    return h.hexdigest()
