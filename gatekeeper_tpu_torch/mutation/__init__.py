"""TPU-batched mutating admission: Assign / AssignMetadata / ModifySet.

The mutation counterpart of the validation stack — mutator CRD types
with location-path parsing (`path.py`), per-kind apply semantics
(`mutators.py`), the ingestion cache + schema-conflict quarantine +
apply-to-convergence engine (`system.py`), and RFC-6902 patch
generation (`patch.py`). The `/v1/mutate` webhook endpoint rides the
same micro-batcher and vectorized target-matcher as validation
(control/webhook.py MutationHandler).
"""

from .mutators import (
    MUTATOR_GROUP,
    MUTATOR_KINDS,
    AssignMetadataMutator,
    AssignMutator,
    ModifySetMutator,
    MutationError,
    Mutator,
    load_mutator,
)
from .patch import apply_patch, json_patch
from .path import ListNode, ObjectNode, PathError, parse, render
from .system import DEFAULT_MAX_ITERATIONS, MutationSystem, implied_types

__all__ = [
    "MUTATOR_GROUP",
    "MUTATOR_KINDS",
    "AssignMetadataMutator",
    "AssignMutator",
    "DEFAULT_MAX_ITERATIONS",
    "ListNode",
    "ModifySetMutator",
    "MutationError",
    "MutationSystem",
    "Mutator",
    "ObjectNode",
    "PathError",
    "apply_patch",
    "implied_types",
    "json_patch",
    "load_mutator",
    "parse",
    "render",
]
