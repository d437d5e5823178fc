"""Shipped policy library.

The framework's counterpart of the reference's `library/` content
(library/general + library/pod-security-policy): 23 ConstraintTemplates
as ready-to-apply YAML, authored for this engine (each template's rego is
an independent implementation; behavior parity with the reference
library is asserted differentially over the reference's own test corpus
in tests/test_policies.py).

Use:
    from gatekeeper_tpu_torch import policies
    client.add_template(policies.load("general/requiredlabels"))
    for name in policies.names(): ...
"""

from __future__ import annotations

import functools
import pathlib

import yaml

_ROOT = pathlib.Path(__file__).parent
GROUPS = ("general", "pod-security-policy")


def names() -> list[str]:
    """All shipped template names, e.g. "general/requiredlabels"."""
    out = []
    for group in GROUPS:
        for p in sorted((_ROOT / group).glob("*.yaml")):
            out.append(f"{group}/{p.stem}")
    return out


@functools.lru_cache(maxsize=64)
def _load_cached(name: str) -> dict:
    path = _ROOT / f"{name}.yaml"
    if not path.is_file():
        raise KeyError(f"no shipped policy named {name!r}; "
                       f"see gatekeeper_tpu_torch.policies.names()")
    with open(path) as f:
        return yaml.safe_load(f)


def load(name: str) -> dict:
    """The ConstraintTemplate dict for a shipped policy (fresh copy)."""
    import copy

    return copy.deepcopy(_load_cached(name))


def load_all() -> dict[str, dict]:
    return {n: load(n) for n in names()}


def kind_of(name: str) -> str:
    """The constraint Kind a shipped template defines."""
    return _load_cached(name)["spec"]["crd"]["spec"]["names"]["kind"]
