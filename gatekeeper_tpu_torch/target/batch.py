"""Batched constraint matching: match masks for the audit cross-product.

Computes mask[R, C] (review × constraint) without R×C Python calls. The
match predicate (matcher.py, mirroring pkg/target/regolib/src.rego) reads
only a small projection of each review:

  * kinds clause            → (kind.group, kind.kind)
  * namespaces / excluded   → the effective namespace name (get_ns_name)
  * namespaceSelector       → raw review.namespace (cache lookup key) plus
                              the object/oldObject label state for
                              Namespace-kind reviews
  * labelSelector           → object/oldObject label state

Reviews are therefore grouped ONCE by the full signature of all those
components; each constraint declares which components it depends on, and
`constraint_matches` runs once per (constraint, projected signature) —
for selector-free constraints that is once per (group, kind) in the whole
cluster. Semantics still delegate to the differentially-tested predicate
in matcher.py; this module only memoizes it (correctness asserted by the
brute-force differential in tests/test_target_matcher.py).

Reviews carrying `_unstable` (namespace sideload — the webhook per
request, discovery-mode audit for every namespaced object) contribute
the sideloaded namespace's LABELS to the signature: that is all
_matches_nsselector can observe of it, so objects sharing a namespace
still collapse into one group instead of falling back to per-review
evaluation (the discovery audit sideloads on every namespaced review —
a fallback there would reintroduce the R×C matcher loop).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils.values import freeze
from .matcher import NamespaceLookup, _get_ns_name, _has_field, _MISSING, \
    constraint_matches


def _dependence(constraint: dict) -> tuple:
    """(name_dep, nssel_dep, lblsel_dep) — which signature components the
    constraint's match clauses read beyond (group, kind)."""
    spec = constraint.get("spec")
    spec = spec if isinstance(spec, dict) else {}
    match = spec.get("match")
    match = match if isinstance(match, dict) else {}
    name_dep = _has_field(match, "namespaces") or \
        _has_field(match, "excludedNamespaces")
    return (name_dep, "namespaceSelector" in match, "labelSelector" in match)


def _labels_key(labels: dict):
    """Hashable signature key for a labels dict. Labels are dict[str, str]
    in practice: a sorted-items tuple is a ~4x cheaper key than a
    recursive freeze (hash() probes for unhashable values so malformed
    labels fall back cleanly)."""
    try:
        t = tuple(sorted(labels.items()))
        hash(t)
        return t
    except TypeError:
        return freeze(labels)


def _label_state(review: dict, field: str):
    """(is-empty, hashable labels key) of review.object/.oldObject —
    everything _any_labelselector_match can observe."""
    v = review.get(field)
    v = v if isinstance(v, dict) else {}
    if not v:
        return (True, None)
    meta = v.get("metadata")
    labels = meta.get("labels") if isinstance(meta, dict) else None
    if not isinstance(labels, dict):
        return (False, None)
    return (False, _labels_key(labels))


def _unstable_state(review: dict):
    """Hashable key of the sideloaded namespace as _get_ns observes it:
    (present-and-resolving, labels key), or _MISSING for a malformed
    sideload (→ per-review fallback)."""
    if "_unstable" not in review:
        return None
    unstable = review.get("_unstable")
    if not isinstance(unstable, dict):
        return _MISSING
    ns = unstable.get("namespace")
    if ns is None:
        return (False, None)
    if not isinstance(ns, dict):
        return _MISSING
    meta = ns.get("metadata")
    labels = meta.get("labels") if isinstance(meta, dict) else None
    if not isinstance(labels, dict):
        return (True, None)
    return (True, _labels_key(labels))


def _signature(review: dict) -> Optional[tuple]:
    """Full match-relevant signature, or None for per-review fallback."""
    ust = _unstable_state(review)
    if ust is _MISSING:
        return None
    kind = review.get("kind")
    kind = kind if isinstance(kind, dict) else {}
    eff_ns = _get_ns_name(review)
    if eff_ns is _MISSING:
        eff_ns = "\x00missing"
    return (
        kind.get("group"), kind.get("kind"),
        ("namespace" in review, review.get("namespace")),
        eff_ns,
        _label_state(review, "object"),
        _label_state(review, "oldObject"),
        ust,
    )


def _project(sig: tuple, dep: tuple) -> tuple:
    name_dep, nssel_dep, lblsel_dep = dep
    key = (sig[0], sig[1])
    if name_dep:
        key += (sig[3],)
    if nssel_dep:
        key += (sig[2], sig[4], sig[5], sig[6])
    if lblsel_dep:
        key += (sig[4], sig[5])
    return key


def match_masks(constraints: list[dict], reviews: list[dict],
                lookup_ns: NamespaceLookup,
                sig_cache: Optional[dict] = None) -> np.ndarray:
    """mask[R, C]. sig_cache (id(review) -> signature) lets one audit
    reuse signatures across per-kind calls over the same review list."""
    R, C = len(reviews), len(constraints)
    mask = np.zeros((R, C), dtype=bool)

    groups: dict[tuple, list[int]] = {}
    fallback: list[int] = []
    for r, review in enumerate(reviews):
        if sig_cache is not None:
            sig = sig_cache.get(id(review), _MISSING)
            if sig is _MISSING:
                sig = _signature(review)
                sig_cache[id(review)] = sig
        else:
            sig = _signature(review)
        if sig is None:
            fallback.append(r)
        else:
            groups.setdefault(sig, []).append(r)

    # constraints bucketed by dependence class (usually 1-2 classes per
    # audit); the expensive group->projection collapse runs once per class,
    # NOT once per constraint — selector-free constraints then cost one
    # matcher call per (group, kind) in the whole cluster
    classes: dict[tuple, list[int]] = {}
    for c, constraint in enumerate(constraints):
        classes.setdefault(_dependence(constraint), []).append(c)

    for dep, cidxs in classes.items():
        proj: dict[tuple, list] = {}
        rep: dict[tuple, int] = {}
        for sig, rows in groups.items():
            key = _project(sig, dep)
            bucket = proj.get(key)
            if bucket is None:
                proj[key] = list(rows)
                rep[key] = rows[0]
            else:
                bucket.extend(rows)
        proj_rows = [(np.asarray(rows), reviews[rep[key]])
                     for key, rows in proj.items()]
        cidx_arr = np.asarray(cidxs)
        # assign per (projection group, matched-constraint set) BLOCK:
        # one np.ix_ write instead of |groups|×|constraints| fancy-index
        # writes (the all-match case — selector-free constraints — is a
        # single [R, C] block memset)
        for rows, review in proj_rows:
            matched = [c for c in cidxs
                       if constraint_matches(constraints[c], review,
                                             lookup_ns)]
            if not matched:
                continue
            cols = cidx_arr if len(matched) == len(cidxs) \
                else np.asarray(matched)
            mask[np.ix_(rows, cols)] = True
        for r in fallback:
            for c in cidxs:
                mask[r, c] = constraint_matches(constraints[c], reviews[r],
                                                lookup_ns)
    return mask
