"""Mutator CRD types: Assign / AssignMetadata / ModifySet.

Counterparts of the reference's pkg/mutation/mutators/{assign,
assignmeta,modifyset}: each wraps one mutator CR, validates its spec at
ingestion time, and knows how to apply itself to an unstructured object
in place. Applicability (applyTo + spec.match) is evaluated separately —
batched across a whole micro-batch by the MutationSystem through the
same vectorized target-matcher the validation path uses.

Semantics mirrored from the reference:

  * Assign may not mutate `metadata.*` (that is AssignMetadata's job)
    and requires a non-empty `applyTo`.
  * AssignMetadata may ONLY write `metadata.labels.<key>` /
    `metadata.annotations.<key>`, the assigned value must be a string,
    and an existing value is never overwritten.
  * ModifySet's location terminates at a list; `merge` appends missing
    values (creating the list if absent), `prune` removes equal values.
  * Traversal creates missing object fields and — for concrete-keyed
    list accessors — missing elements (seeded with the key field); glob
    accessors never create.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Optional

from .path import ListNode, ObjectNode, PathError, PathNode, parse, render

MUTATOR_GROUP = "mutations.gatekeeper.sh"
MUTATOR_KINDS = ("Assign", "AssignMetadata", "ModifySet")


class MutationError(Exception):
    pass


def _spec(obj: dict) -> dict:
    spec = obj.get("spec")
    return spec if isinstance(spec, dict) else {}


class Mutator:
    """One validated mutator CR. `id` is (kind, name) — the ingestion
    cache key; `nodes` the parsed location path."""

    kind: str = ""

    def __init__(self, obj: dict):
        self.obj = copy.deepcopy(obj)
        meta = self.obj.get("metadata")
        self.name = (meta or {}).get("name") or ""
        if not self.name:
            raise MutationError(f"{self.kind} has no metadata.name")
        self.id: tuple[str, str] = (self.kind, self.name)
        spec = _spec(self.obj)
        location = spec.get("location")
        try:
            self.nodes: list[PathNode] = parse(location)
        except PathError as e:
            raise MutationError(f"{self.kind} {self.name}: bad "
                                f"spec.location: {e}") from e
        self.match = spec.get("match") or {}
        if not isinstance(self.match, dict):
            raise MutationError(f"{self.kind} {self.name}: spec.match "
                                "must be an object")
        self.apply_to = self._parse_apply_to(spec)
        self._validate(spec)

    # ---------------------------------------------------------- applyTo

    def _parse_apply_to(self, spec: dict) -> Optional[list[dict]]:
        apply_to = spec.get("applyTo")
        if apply_to is None:
            return None
        if not isinstance(apply_to, list):
            raise MutationError(f"{self.kind} {self.name}: spec.applyTo "
                                "must be an array")
        out = []
        for i, entry in enumerate(apply_to):
            if not isinstance(entry, dict):
                raise MutationError(f"{self.kind} {self.name}: "
                                    f"spec.applyTo[{i}] must be an object")
            out.append({
                "groups": [g for g in entry.get("groups") or []
                           if isinstance(g, str)],
                "versions": [v for v in entry.get("versions") or []
                             if isinstance(v, str)],
                "kinds": [k for k in entry.get("kinds") or []
                          if isinstance(k, str)],
            })
        return out

    def applies_to_gvk(self, group: str, version: str, kind: str) -> bool:
        """applyTo gate (reference match.AppliesTo): any entry whose
        three lists each contain the value or `*`. A mutator without
        applyTo (AssignMetadata) applies to every kind."""
        if self.apply_to is None:
            return True
        for entry in self.apply_to:
            if (("*" in entry["groups"] or group in entry["groups"])
                    and ("*" in entry["versions"]
                         or version in entry["versions"])
                    and ("*" in entry["kinds"] or kind in entry["kinds"])):
                return True
        return False

    # ------------------------------------------------------- validation

    def _validate(self, spec: dict) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------ apply

    def apply(self, obj: dict) -> bool:
        """Mutate `obj` in place; True iff anything changed."""
        raise NotImplementedError

    def location(self) -> str:
        return render(self.nodes)

    def __repr__(self):
        return f"<{self.kind} {self.name} @ {self.location()}>"


# --------------------------------------------------------- path traversal


def _descend(parent: dict, node: PathNode, create: bool,
             who: str) -> list[Any]:
    """Resolve one non-terminal path node to the child containers to
    recurse into (possibly creating them). Returns [] when the path
    does not resolve and must not be created."""
    if isinstance(node, ObjectNode):
        child = parent.get(node.name)
        if child is None:
            if not create:
                return []
            child = parent[node.name] = {}
        if not isinstance(child, dict):
            raise MutationError(
                f"{who}: {node.name} is not an object (found "
                f"{type(child).__name__})")
        return [child]
    lst = parent.get(node.name)
    if lst is None:
        if not create or node.glob:
            return []
        lst = parent[node.name] = []
    if not isinstance(lst, list):
        raise MutationError(f"{who}: {node.name} is not a list (found "
                            f"{type(lst).__name__})")
    matched = [el for el in lst
               if isinstance(el, dict)
               and (node.glob or el.get(node.key_field) == node.key_value)]
    if not matched and not node.glob:
        if not create:
            return []
        el: dict = {node.key_field: node.key_value}
        lst.append(el)
        matched = [el]
    return matched


# ------------------------------------------------------------------ Assign


class AssignMutator(Mutator):
    kind = "Assign"

    def _validate(self, spec: dict) -> None:
        if not self.apply_to:
            raise MutationError(f"Assign {self.name}: spec.applyTo is "
                                "required and must be non-empty")
        first = self.nodes[0]
        if first.name == "metadata":
            raise MutationError(f"Assign {self.name}: changing metadata is "
                                "not allowed (use AssignMetadata)")
        params = spec.get("parameters")
        params = params if isinstance(params, dict) else {}
        assign = params.get("assign")
        if not isinstance(assign, dict) or "value" not in assign:
            raise MutationError(f"Assign {self.name}: "
                                "spec.parameters.assign.value is required")
        self.value = assign["value"]
        last = self.nodes[-1]
        if isinstance(last, ListNode):
            if last.glob:
                # a glob terminal would rewrite every element with one
                # identical value, dropping the key field that
                # distinguishes them (the reference forbids it too)
                raise MutationError(
                    f"Assign {self.name}: the final list node may not "
                    "use the glob key (it would collapse every element "
                    "into one value)")
            if not (isinstance(self.value, dict)
                    and self.value.get(last.key_field) == last.key_value):
                raise MutationError(
                    f"Assign {self.name}: value for terminal "
                    f"[{last.key_field}: {last.key_value}] must be an "
                    "object carrying that key")

    def apply(self, obj: dict) -> bool:
        who = f"Assign {self.name}"
        parents = [obj]
        for node in self.nodes[:-1]:
            nxt: list = []
            for p in parents:
                nxt.extend(_descend(p, node, create=True, who=who))
            parents = nxt
        changed = False
        last = self.nodes[-1]
        for p in parents:
            if isinstance(last, ObjectNode):
                if p.get(last.name) != self.value or last.name not in p:
                    p[last.name] = copy.deepcopy(self.value)
                    changed = True
                continue
            lst = p.get(last.name)
            if lst is None:
                lst = p[last.name] = []
            if not isinstance(lst, list):
                raise MutationError(f"{who}: {last.name} is not a list")
            # glob terminals are rejected at validation; only concrete
            # keys reach here
            hit = False
            for i, el in enumerate(lst):
                if isinstance(el, dict) and \
                        el.get(last.key_field) == last.key_value:
                    hit = True
                    if el != self.value:
                        lst[i] = copy.deepcopy(self.value)
                        changed = True
            if not hit:
                lst.append(copy.deepcopy(self.value))
                changed = True
        return changed


# ---------------------------------------------------------- AssignMetadata


class AssignMetadataMutator(Mutator):
    kind = "AssignMetadata"

    def _validate(self, spec: dict) -> None:
        nodes = self.nodes
        ok = (len(nodes) == 3
              and all(isinstance(n, ObjectNode) for n in nodes)
              and nodes[0].name == "metadata"
              and nodes[1].name in ("labels", "annotations"))
        if not ok:
            raise MutationError(
                f"AssignMetadata {self.name}: location must be "
                "metadata.labels.<key> or metadata.annotations.<key>, "
                f"got {spec.get('location')!r}")
        params = spec.get("parameters")
        params = params if isinstance(params, dict) else {}
        assign = params.get("assign")
        if not isinstance(assign, dict) or "value" not in assign:
            raise MutationError(f"AssignMetadata {self.name}: "
                                "spec.parameters.assign.value is required")
        if not isinstance(assign["value"], str):
            raise MutationError(f"AssignMetadata {self.name}: value must "
                                "be a string")
        self.value = assign["value"]

    def apply(self, obj: dict) -> bool:
        meta = obj.setdefault("metadata", {})
        if not isinstance(meta, dict):
            raise MutationError(f"AssignMetadata {self.name}: metadata is "
                                "not an object")
        bucket = meta.setdefault(self.nodes[1].name, {})
        if not isinstance(bucket, dict):
            raise MutationError(
                f"AssignMetadata {self.name}: metadata."
                f"{self.nodes[1].name} is not an object")
        key = self.nodes[2].name
        if key in bucket:
            return False  # never overwrites (reference assignmeta.go)
        bucket[key] = self.value
        return True


# --------------------------------------------------------------- ModifySet


class ModifySetMutator(Mutator):
    kind = "ModifySet"

    def _validate(self, spec: dict) -> None:
        if not self.apply_to:
            raise MutationError(f"ModifySet {self.name}: spec.applyTo is "
                                "required and must be non-empty")
        first = self.nodes[0]
        if first.name == "metadata":
            raise MutationError(f"ModifySet {self.name}: changing metadata "
                                "is not allowed")
        if isinstance(self.nodes[-1], ListNode):
            raise MutationError(
                f"ModifySet {self.name}: location must terminate at the "
                "list field itself, not a keyed element")
        params = spec.get("parameters")
        params = params if isinstance(params, dict) else {}
        self.operation = params.get("operation") or "merge"
        if self.operation not in ("merge", "prune"):
            raise MutationError(f"ModifySet {self.name}: operation must be "
                                "merge or prune")
        values = params.get("values")
        values = values if isinstance(values, dict) else {}
        from_list = values.get("fromList")
        if not isinstance(from_list, list):
            raise MutationError(f"ModifySet {self.name}: "
                                "spec.parameters.values.fromList is required")
        self.values = from_list

    def apply(self, obj: dict) -> bool:
        who = f"ModifySet {self.name}"
        # prune must not create the path it would prune from
        create = self.operation == "merge"
        parents = [obj]
        for node in self.nodes[:-1]:
            nxt: list = []
            for p in parents:
                nxt.extend(_descend(p, node, create=create, who=who))
            parents = nxt
        last = self.nodes[-1]
        changed = False
        for p in parents:
            lst = p.get(last.name)
            if lst is None:
                if not create:
                    continue
                lst = p[last.name] = []
            if not isinstance(lst, list):
                raise MutationError(f"{who}: {last.name} is not a list")
            if self.operation == "merge":
                for v in self.values:
                    if v not in lst:
                        lst.append(copy.deepcopy(v))
                        changed = True
            else:
                kept = [el for el in lst if el not in self.values]
                if len(kept) != len(lst):
                    lst[:] = kept
                    changed = True
        return changed


_BY_KIND = {
    "Assign": AssignMutator,
    "AssignMetadata": AssignMetadataMutator,
    "ModifySet": ModifySetMutator,
}


def load_mutator(obj: Any) -> Mutator:
    """Validate + wrap a mutator CR dict; raises MutationError."""
    if not isinstance(obj, dict):
        raise MutationError(f"mutator must be an object, got "
                            f"{type(obj).__name__}")
    kind = obj.get("kind")
    cls = _BY_KIND.get(kind)
    if cls is None:
        raise MutationError(f"unknown mutator kind {kind!r}; expected one "
                            f"of {MUTATOR_KINDS}")
    group = (obj.get("apiVersion") or "").partition("/")[0]
    if group and group != MUTATOR_GROUP:
        raise MutationError(f"mutator group must be {MUTATOR_GROUP}, got "
                            f"{group!r}")
    return cls(obj)


def semantic_equal(a: dict, b: dict) -> bool:
    """Spec-level equality for ingestion dedupe (metadata churn —
    resourceVersion, managedFields — must not re-ingest)."""
    return json.dumps(_spec(a), sort_keys=True) == \
        json.dumps(_spec(b), sort_keys=True)
