"""Native constraint-match predicate.

The reference evaluates `spec.match` (kinds / namespaces /
excludedNamespaces / labelSelector / namespaceSelector) with a generated
Rego library (pkg/target/regolib/src.rego, embedded at
pkg/target/target_template_source.go:6-336). Here the same semantics are
implemented natively — this predicate is the batch-selection mask of the
vectorized audit sweep, so it must be cheap and host-side.

Semantics are mirrored clause-by-clause from the Rego source, including its
edge cases (differentially tested against that Rego running in our
interpreter — tests/test_target_matcher.py):

  * `get_default` treats JSON null as missing; `has_field` treats null as
    PRESENT (src.rego:84-118) — so `namespaceSelector: null` still triggers
    autoreject but selects like `{}`.
  * a `kinds` entry missing `apiGroups` or `kinds` never matches
    (src.rego:135-149: enumeration over a missing field is undefined).
  * `namespaces`/`excludedNamespaces` require a resolvable namespace name —
    cluster-scoped non-Namespace objects never match a constraint that sets
    either field (src.rego:286-302, get_ns_name undefined).
  * label-selector matching considers object/oldObject per
    src.rego:203-252 (either may satisfy the selector when both exist; an
    empty object counts as absent).
  * matchExpressions: unknown operators are ignored; `In` with empty
    values is violated only by a missing key (src.rego:156-181).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

_MISSING = object()


def _get_default(obj: Any, field: str, default: Any) -> Any:
    """Field lookup treating null as missing (src.rego:100-118)."""
    if not isinstance(obj, dict):
        return default
    v = obj.get(field, _MISSING)
    if v is _MISSING or v is None:
        return default
    return v


def _has_field(obj: Any, field: str) -> bool:
    """Presence check; null counts as present (src.rego:84-98)."""
    return isinstance(obj, dict) and field in obj


NamespaceLookup = Callable[[str], Optional[dict]]


def _review_kind(review: dict) -> dict:
    k = review.get("kind")
    return k if isinstance(k, dict) else {}


def _is_ns(kind: dict) -> bool:
    # reference is_ns (src.rego:258-261) requires kind.group == "" exactly;
    # a missing or null group leaves it undefined, so it must NOT match
    return kind.get("group") == "" and kind.get("kind") == "Namespace"


def _get_ns_name(review: dict):
    """src.rego:272-280; returns None when undefined."""
    if _is_ns(_review_kind(review)):
        obj = review.get("object")
        if isinstance(obj, dict):
            meta = obj.get("metadata")
            if isinstance(meta, dict) and "name" in meta:
                return meta["name"]
        return None
    return review.get("namespace", _MISSING) if "namespace" in review else None


def _get_ns(review: dict, lookup_namespace: NamespaceLookup):
    """Resolve the review's namespace object (src.rego:263-270)."""
    unstable = review.get("_unstable")
    if isinstance(unstable, dict):
        ns = unstable.get("namespace")
        if ns is not None:
            return ns
    name = review.get("namespace")
    if isinstance(name, str) and name:
        return lookup_namespace(name)
    return None


def needs_autoreject(
    match: Any, review: dict, lookup_namespace: NamespaceLookup
) -> bool:
    """autoreject_review preconditions per constraint (src.rego:7-20):
    namespaceSelector present, namespace not resolvable from the cache or
    the sideloaded `_unstable.namespace`, and review.namespace not
    explicitly empty."""
    if not _has_field(match if isinstance(match, dict) else {}, "namespaceSelector"):
        return False
    ns_name = review.get("namespace")
    if "namespace" in review and ns_name == "":
        return False
    unstable = review.get("_unstable")
    if isinstance(unstable, dict) and unstable.get("namespace"):
        return False
    if isinstance(ns_name, str) and ns_name and lookup_namespace(ns_name):
        return False
    return True


def constraint_matches(
    constraint: dict, review: dict, lookup_namespace: NamespaceLookup
) -> bool:
    """matching_constraints body (src.rego:22-37)."""
    spec = _get_default(constraint, "spec", {})
    match = _get_default(spec, "match", {})
    if not isinstance(match, dict):
        match = {}
    return (
        _any_kind_selector_matches(match, review)
        and _matches_namespaces(match, review)
        and _does_not_match_excluded(match, review)
        and _matches_nsselector(match, review, lookup_namespace)
        and _any_labelselector_match(_get_default(match, "labelSelector", {}), review)
    )


# ------------------------------------------------------------------- kinds


def _any_kind_selector_matches(match: dict, review: dict) -> bool:
    selectors = _get_default(match, "kinds", [{"apiGroups": ["*"], "kinds": ["*"]}])
    if not isinstance(selectors, (list, tuple)):
        return False
    kind = _review_kind(review)
    group = kind.get("group")
    kname = kind.get("kind")
    for ks in selectors:
        if not isinstance(ks, dict):
            continue
        groups = ks.get("apiGroups")
        kinds = ks.get("kinds")
        if not isinstance(groups, (list, tuple)) or not isinstance(kinds, (list, tuple)):
            continue  # missing/null field → selector can never match
        if ("*" in groups or (group is not None and group in groups)) and (
            "*" in kinds or (kname is not None and kname in kinds)
        ):
            return True
    return False


# -------------------------------------------------------------- namespaces


def _matches_namespaces(match: dict, review: dict) -> bool:
    if not _has_field(match, "namespaces"):
        return True
    ns = _get_ns_name(review)
    if ns is None or ns is _MISSING:
        return False
    nss = match.get("namespaces")
    listed = set(x for x in nss if isinstance(x, str)) if isinstance(nss, (list, tuple)) else set()
    return ns in listed


def _does_not_match_excluded(match: dict, review: dict) -> bool:
    if not _has_field(match, "excludedNamespaces"):
        return True
    ns = _get_ns_name(review)
    if ns is None or ns is _MISSING:
        return False
    nss = match.get("excludedNamespaces")
    listed = set(x for x in nss if isinstance(x, str)) if isinstance(nss, (list, tuple)) else set()
    return ns not in listed


# ---------------------------------------------------------- label selectors


def _labels_of(obj: Any) -> dict:
    meta = _get_default(obj if isinstance(obj, dict) else {}, "metadata", {})
    labels = _get_default(meta if isinstance(meta, dict) else {}, "labels", {})
    return labels if isinstance(labels, dict) else {}


def _match_expression_violated(op: str, labels: dict, key: str, values: list) -> bool:
    """src.rego:156-181; unknown operators are never violated."""
    if op == "In":
        if key not in labels:
            return True
        return len(values) > 0 and not any(labels[key] == v for v in values)
    if op == "NotIn":
        return len(values) > 0 and key in labels and any(labels[key] == v for v in values)
    if op == "Exists":
        return key not in labels
    if op == "DoesNotExist":
        return key in labels
    return False


def matches_label_selector(selector: Any, labels: dict) -> bool:
    if not isinstance(selector, dict):
        selector = {}
    match_labels = _get_default(selector, "matchLabels", {})
    if isinstance(match_labels, dict):
        for k, v in match_labels.items():
            if k not in labels or labels[k] != v:
                return False
    exprs = _get_default(selector, "matchExpressions", [])
    if isinstance(exprs, (list, tuple)):
        for e in exprs:
            if not isinstance(e, dict):
                continue
            op = e.get("operator")
            key = e.get("key")
            values = _get_default(e, "values", [])
            if not isinstance(values, (list, tuple)):
                values = []
            if isinstance(op, str) and isinstance(key, str):
                if _match_expression_violated(op, labels, key, values):
                    return False
    return True


def _obj_or_empty(review: dict, field: str) -> Any:
    v = _get_default(review, field, {})
    return v if isinstance(v, dict) else {}


def _any_labelselector_match(selector: Any, review: dict) -> bool:
    """src.rego:203-252: which of object/oldObject carries the labels."""
    obj = _obj_or_empty(review, "object")
    old = _obj_or_empty(review, "oldObject")
    if old == {} and obj != {}:
        return matches_label_selector(selector, _labels_of(obj))
    if old != {} and obj == {}:
        return matches_label_selector(selector, _labels_of(old))
    if old != {} and obj != {}:
        return matches_label_selector(selector, _labels_of(obj)) or \
            matches_label_selector(selector, _labels_of(old))
    return matches_label_selector(selector, {})


# ------------------------------------------------------- namespace selector


def _matches_nsselector(
    match: dict, review: dict, lookup_namespace: NamespaceLookup
) -> bool:
    if not _has_field(match, "namespaceSelector"):
        return True
    selector = _get_default(match, "namespaceSelector", {})
    if _is_ns(_review_kind(review)):
        return _any_labelselector_match(selector, review)
    ns = _get_ns(review, lookup_namespace)
    if ns is None:
        return False
    return matches_label_selector(selector, _labels_of(ns))
