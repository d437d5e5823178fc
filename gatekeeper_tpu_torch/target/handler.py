"""K8s validation target handler.

Counterpart of the reference's K8sValidationTarget (pkg/target/target.go):
maps synced objects onto inventory paths, wraps inputs into gkReview dicts,
re-extracts violating resources, and publishes the `spec.match` schema.
Objects are unstructured dicts throughout; inventory paths are tuples of
segments, so group/version strings like "apps/v1" need no URL escaping
(the reference's url.PathEscape at target.go:73-76 — which its audit-cache
Rego then mis-splits — is unnecessary here).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from ..client.types import Result
from .matcher import matches_label_selector

TARGET_NAME = "admission.k8s.gatekeeper.sh"

_VALID_OPERATORS = ("In", "NotIn", "Exists", "DoesNotExist")


class TargetError(Exception):
    pass


class WipeData:
    """Sentinel: RemoveData(WipeData()) clears the target's inventory
    (reference pkg/target/target.go:36-40; config controller uses it)."""


@dataclass
class AugmentedReview:
    admission_request: dict
    namespace: Optional[dict] = None


@dataclass
class AugmentedUnstructured:
    object: dict
    namespace: Optional[dict] = None


def _gvk_of(obj: dict) -> tuple[str, str, str]:
    api_version = obj.get("apiVersion") or ""
    group, _, version = api_version.rpartition("/")
    return group, version, obj.get("kind") or ""


def _meta(obj: dict) -> dict:
    m = obj.get("metadata")
    return m if isinstance(m, dict) else {}


class K8sValidationTarget:
    def __init__(self):
        # cross-audit Result.resource render memo (see handle_violation)
        self._resource_memo: dict = {}

    def get_name(self) -> str:
        return TARGET_NAME

    # ------------------------------------------------------------ data path

    def process_data(self, obj: Any) -> Tuple[bool, tuple, Any]:
        """Map an object to its inventory path (reference target.go:62-89).

        Returns (handled, path, data); WipeData maps to the empty path.
        """
        if isinstance(obj, WipeData) or obj is WipeData:
            return True, (), None
        if isinstance(obj, dict):
            group, version, kind = _gvk_of(obj)
            if not version:
                raise TargetError(f"resource {_meta(obj).get('name')} has no version")
            if not kind:
                raise TargetError(f"resource {_meta(obj).get('name')} has no kind")
            gv = f"{group}/{version}" if group else version
            name = _meta(obj).get("name") or ""
            ns = _meta(obj).get("namespace") or ""
            if not ns:
                return True, ("cluster", gv, kind, name), obj
            return True, ("namespace", ns, gv, kind, name), obj
        return False, (), None

    # ------------------------------------------------------------- reviews

    def handle_review(self, obj: Any) -> Tuple[bool, Optional[dict]]:
        """Wrap supported inputs into a gkReview dict
        (reference target.go:91-127)."""
        if isinstance(obj, AugmentedReview):
            review = dict(obj.admission_request)
            if obj.namespace is not None:
                review["_unstable"] = {"namespace": obj.namespace}
            return True, review
        if isinstance(obj, AugmentedUnstructured):
            review = self._object_to_review(obj.object)
            if obj.namespace is not None:
                review["_unstable"] = {"namespace": obj.namespace}
                ns_name = _meta(obj.namespace).get("name")
                if ns_name:
                    review["namespace"] = ns_name
            return True, review
        if isinstance(obj, dict):
            if "kind" in obj and isinstance(obj.get("kind"), dict):
                # already AdmissionRequest-shaped
                return True, dict(obj)
            if "apiVersion" in obj and isinstance(obj.get("kind"), str):
                return True, self._object_to_review(obj)
        return False, None

    def _object_to_review(self, obj: dict) -> dict:
        group, version, kind = _gvk_of(obj)
        review: dict = {
            "kind": {"group": group, "version": version, "kind": kind},
            "object": obj,
        }
        name = _meta(obj).get("name")
        if name:
            review["name"] = name
        ns = _meta(obj).get("namespace")
        if ns:
            review["namespace"] = ns
        return review

    # ----------------------------------------------------------- violations

    def handle_violation(self, result: Result,
                         memo: Optional[dict] = None) -> None:
        """Re-extract the violating resource from the review
        (reference target.go:193-244).

        memo (scoped to one response batch by the caller) dedupes the
        deep copy across the many results one object produces in a large
        audit; like Result.constraint, the resource dict is then shared
        between those results."""
        review = result.review
        if not isinstance(review, dict):
            raise TargetError(f"could not cast review as object: {review!r}")
        kind = review.get("kind")
        if not isinstance(kind, dict):
            raise TargetError("review has no kind")
        group = kind.get("group")
        version = kind.get("version")
        kname = kind.get("kind")
        for f, v in (("group", group), ("version", version), ("kind", kname)):
            if not isinstance(v, str):
                raise TargetError(f"review[kind][{f}] is not a string: {v!r}")
        api_version = version if not group else f"{group}/{version}"
        obj = review.get("object")
        if not isinstance(obj, dict):
            obj = review.get("oldObject")
        if not isinstance(obj, dict):
            raise TargetError("no object or oldObject returned in review")
        key = (id(obj), api_version, kname)
        resource = memo.get(key) if memo is not None else None
        if resource is None:
            # cross-audit memo: steady-state sweeps re-render the same
            # store objects every interval; identity-checked so a
            # replaced object re-copies
            ent = self._resource_memo.get(key)
            if ent is not None and ent[0] is obj:
                resource = ent[1]
            else:
                resource = json.loads(json.dumps(obj))
                resource["apiVersion"] = api_version
                resource["kind"] = kname
                if len(self._resource_memo) > 131072:
                    self._resource_memo.clear()
                self._resource_memo[key] = (obj, resource)
            if memo is not None:
                memo[key] = resource
        result.resource = resource

    # -------------------------------------------------------------- schema

    def match_schema(self) -> dict:
        """JSONSchema of spec.match (reference target.go:246-310)."""
        string_list = {"type": "array", "items": {"type": "string"}}
        label_selector = {
            "properties": {
                "matchExpressions": {
                    "type": "array",
                    "items": {
                        "properties": {
                            "key": {"type": "string"},
                            "operator": {
                                "type": "string",
                                "enum": list(_VALID_OPERATORS),
                            },
                            "values": {
                                "type": "array",
                                "items": {"type": "string"},
                            },
                        }
                    },
                }
            }
        }
        return {
            "properties": {
                "kinds": {
                    "type": "array",
                    "items": {
                        "properties": {
                            "apiGroups": {"items": {"type": "string"}},
                            "kinds": {"items": {"type": "string"}},
                        }
                    },
                },
                "namespaces": string_list,
                "excludedNamespaces": string_list,
                "labelSelector": label_selector,
                "namespaceSelector": label_selector,
            }
        }

    # ----------------------------------------------------------- validation

    def validate_constraint(self, constraint: dict) -> None:
        """Label-selector validation (reference target.go:312-346)."""
        spec = constraint.get("spec") or {}
        match = spec.get("match") or {}
        for sel_field in ("labelSelector", "namespaceSelector"):
            sel = match.get(sel_field)
            if sel is None:
                continue
            if not isinstance(sel, dict):
                raise TargetError(f"spec.match.{sel_field} must be an object")
            self._validate_label_selector(sel, f"spec.match.{sel_field}")

    def _validate_label_selector(self, sel: dict, path: str) -> None:
        ml = sel.get("matchLabels")
        if ml is not None:
            if not isinstance(ml, dict):
                raise TargetError(f"{path}.matchLabels must be an object")
            for k, v in ml.items():
                if not isinstance(v, str):
                    raise TargetError(f"{path}.matchLabels[{k!r}] must be a string")
        exprs = sel.get("matchExpressions")
        if exprs is None:
            return
        if not isinstance(exprs, list):
            raise TargetError(f"{path}.matchExpressions must be an array")
        for i, e in enumerate(exprs):
            if not isinstance(e, dict):
                raise TargetError(f"{path}.matchExpressions[{i}] must be an object")
            op = e.get("operator")
            if op not in _VALID_OPERATORS:
                raise TargetError(
                    f"{path}.matchExpressions[{i}]: invalid operator {op!r}"
                )
            values = e.get("values") or []
            if op in ("In", "NotIn") and not values:
                raise TargetError(
                    f"{path}.matchExpressions[{i}]: operator {op} requires values"
                )
            if op in ("Exists", "DoesNotExist") and values:
                raise TargetError(
                    f"{path}.matchExpressions[{i}]: operator {op} forbids values"
                )

    # sanity: matcher import is part of the public target surface
    matches_label_selector = staticmethod(matches_label_selector)
