"""The mutation system: ingestion cache, schema-conflict quarantine,
batched applicability, and apply-to-convergence.

Counterpart of the reference's pkg/mutation/system.go + the mutation
schema DB (pkg/mutation/schema): mutators are cached by id
(kind, name); every upsert/remove rebuilds the implied type graph over
ALL cached mutators' location paths and quarantines the ones whose
implied types disagree (a path prefix one mutator traverses as an
object and another as a keyed list). Quarantined mutators are excluded
from application — conflicts surface as a status condition at
ingestion time instead of failing open at apply time.

Application is batched: applicability (spec.match × applyTo) for a
whole admission micro-batch is computed through the same vectorized
target-matcher path the validation webhook uses (target/batch.py
match_masks — one signature-grouped sweep instead of R×M predicate
calls), then each matched object is mutated on the host by applying
its mutators in deterministic id order, pass after pass, until a full
pass changes nothing. A pass budget (`max_iterations`) bounds
ping-pong mutator sets: exceeding it raises instead of admitting a
half-mutated object. Convergence doubles as the idempotence proof —
the final pass re-applies every mutator to the already-mutated object
and observes zero changes, so a second webhook trip yields an empty
patch set.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Optional

import numpy as np

from ..target.batch import match_masks
from .mutators import (
    MUTATOR_KINDS,
    MutationError,
    Mutator,
    load_mutator,
    semantic_equal,
)
from .path import ListNode, ObjectNode

DEFAULT_MAX_ITERATIONS = 10

NamespaceLookup = Callable[[str], Optional[dict]]

_OBJECT = "object"
_LIST = "list"


def implied_types(mutator: Mutator) -> list[tuple[tuple, str]]:
    """(path-prefix, implied type) pairs for the conflict graph.

    A keyed-list accessor implies its field is a LIST; a non-terminal
    object node implies an OBJECT. A terminal object node implies
    nothing for Assign/AssignMetadata (the assigned value defines it)
    but LIST for ModifySet (its location names the list itself)."""
    out: list[tuple[tuple, str]] = []
    names: tuple = ()
    last = len(mutator.nodes) - 1
    for i, node in enumerate(mutator.nodes):
        names = names + (node.name,)
        if isinstance(node, ListNode):
            out.append((names, _LIST))
        elif i < last:
            out.append((names, _OBJECT))
        elif mutator.kind == "ModifySet":
            out.append((names, _LIST))
    return out


def _lists_overlap(a: list[str], b: list[str]) -> bool:
    return "*" in a or "*" in b or bool(set(a) & set(b))


def _scopes_overlap(a, b) -> bool:
    """Can the two mutators' applyTo scopes select the same object?
    A mutator without applyTo (AssignMetadata) scopes to everything."""
    if a.apply_to is None or b.apply_to is None:
        return True
    for ea in a.apply_to:
        for eb in b.apply_to:
            if (_lists_overlap(ea["groups"], eb["groups"])
                    and _lists_overlap(ea["versions"], eb["versions"])
                    and _lists_overlap(ea["kinds"], eb["kinds"])):
                return True
    return False


class MutationSystem:
    def __init__(self, max_iterations: int = DEFAULT_MAX_ITERATIONS):
        self.max_iterations = max_iterations
        self._lock = threading.RLock()
        self._mutators: dict[tuple, Mutator] = {}
        self._quarantine: dict[tuple, str] = {}  # id -> conflict reason
        # appliable mutators in id order, rebuilt on every effective
        # upsert/remove — active() is on the per-request webhook hot
        # path and must not re-sort the library each call. Treated as
        # immutable by readers.
        self._active_list: list[Mutator] = []
        # mutator-change observer (N-engine replication hook): called
        # after an EFFECTIVE upsert/remove with (op, plain object) —
        # semantic-equal dedupes do not notify
        self.on_change = None

    def _notify(self, op: str, obj) -> None:
        cb = self.on_change
        if cb is None or obj is None:
            return
        try:
            cb(op, obj)
        except Exception:
            import logging

            logging.getLogger("gatekeeper_tpu_torch.mutation").warning(
                "mutator change notification failed", exc_info=True)

    # ------------------------------------------------------------ cache

    def upsert(self, obj: dict) -> tuple[Mutator, set]:
        """Validate + cache a mutator CR. Returns (mutator, ids whose
        quarantine state changed — including this one when it enters
        quarantined). Raises MutationError on an invalid spec."""
        mutator = load_mutator(obj)
        with self._lock:
            prev = self._mutators.get(mutator.id)
            if prev is not None and semantic_equal(prev.obj, mutator.obj):
                return prev, set()
            self._mutators[mutator.id] = mutator
            changed = self._recompute_conflicts()
        self._notify("upsert_mutator", obj)
        return mutator, changed

    def remove(self, mid: tuple) -> set:
        """Drop a mutator by (kind, name); returns changed-quarantine
        ids (removals can clear conflicts on surviving mutators)."""
        with self._lock:
            if self._mutators.pop(tuple(mid), None) is None:
                return set()
            changed = self._recompute_conflicts()
        self._notify("remove_mutator", {"kind": mid[0],
                                        "metadata": {"name": mid[1]}})
        return changed

    def get(self, mid: tuple) -> Optional[Mutator]:
        with self._lock:
            return self._mutators.get(tuple(mid))

    def mutators(self) -> list[Mutator]:
        with self._lock:
            return [self._mutators[k] for k in sorted(self._mutators)]

    def sources(self) -> list[dict]:
        """Raw CRs of every cached mutator in id order, for the
        warm-restart library snapshot (restore replays them through
        upsert, re-running validation and conflict detection)."""
        with self._lock:
            return [copy.deepcopy(self._mutators[k].obj)
                    for k in sorted(self._mutators)]

    def active(self) -> list[Mutator]:
        """Appliable mutators in deterministic id order (quarantined
        ones excluded). O(1): returns the cached snapshot — do not
        mutate it."""
        return self._active_list

    def conflicts(self) -> dict[tuple, str]:
        with self._lock:
            return dict(self._quarantine)

    def counts(self) -> dict[str, int]:
        """Gauge fodder: cached mutators by kind plus the conflict set."""
        with self._lock:
            out = {k: 0 for k in MUTATOR_KINDS}
            for kind, _ in self._mutators:
                out[kind] = out.get(kind, 0) + 1
            out["conflicting"] = len(self._quarantine)
            return out

    def _recompute_conflicts(self) -> set:
        """Rebuild the implied type graph; returns ids whose quarantine
        state flipped or whose conflict reason changed. Caller holds
        the lock.

        Type disagreement alone is not enough: the implied schemas are
        scoped by applyTo (as the reference's schema DB binds per GVK),
        so two mutators that can never touch the same kind of object —
        say a Pod mutator treating spec.containers as a list and a CRD
        mutator treating its own spec.containers as an object — do NOT
        quarantine each other."""
        by_prefix: dict[tuple, dict[str, list[tuple]]] = {}
        for mid, m in self._mutators.items():
            for prefix, t in implied_types(m):
                by_prefix.setdefault(prefix, {}).setdefault(t, []).append(mid)
        quarantine: dict[tuple, str] = {}
        for prefix, types in sorted(by_prefix.items()):
            if len(types) < 2:
                continue
            dotted = ".".join(prefix)
            lists = sorted(types.get(_LIST, ()))
            objects = sorted(types.get(_OBJECT, ()))
            for side, mine, other in ((_LIST, lists, objects),
                                      (_OBJECT, objects, lists)):
                other_side = _OBJECT if side == _LIST else _LIST
                for mid in mine:
                    opp = [o for o in other
                           if _scopes_overlap(self._mutators[mid],
                                              self._mutators[o])]
                    if opp:
                        quarantine.setdefault(
                            mid,
                            f"schema conflict at {dotted!r}: {side} per "
                            f"{mid} vs {other_side} per {opp}")
        # changed = membership flips AND reason-text changes: a third
        # mutator joining an existing conflict must refresh the original
        # pair's status conditions too
        changed = {mid for mid in set(quarantine) | set(self._quarantine)
                   if quarantine.get(mid) != self._quarantine.get(mid)}
        self._quarantine = quarantine
        self._active_list = [self._mutators[k]
                             for k in sorted(self._mutators)
                             if k not in quarantine]
        return changed

    # ---------------------------------------------------- applicability

    def match_mask(self, mutators: list[Mutator], reviews: list[dict],
                   lookup_ns: NamespaceLookup) -> np.ndarray:
        """mask[R, M]: which mutators apply to which reviews. spec.match
        rides the vectorized constraint matcher (signature-grouped, one
        predicate call per (projection, mutator) instead of R×M);
        applyTo is AND-ed per distinct review GVK."""
        R, M = len(reviews), len(mutators)
        if not R or not M:
            return np.zeros((R, M), dtype=bool)
        shaped = [{"spec": {"match": m.match}} for m in mutators]
        mask = match_masks(shaped, reviews, lookup_ns)
        by_gvk: dict[tuple, list[int]] = {}
        for r, review in enumerate(reviews):
            kind = review.get("kind")
            kind = kind if isinstance(kind, dict) else {}
            gvk = (kind.get("group") or "", kind.get("version") or "",
                   kind.get("kind") or "")
            by_gvk.setdefault(gvk, []).append(r)
        for gvk, rows in by_gvk.items():
            cols = [c for c, m in enumerate(mutators)
                    if not m.applies_to_gvk(*gvk)]
            if cols:
                mask[np.ix_(rows, cols)] = False
        return mask

    # ------------------------------------------------------ application

    def mutate_batch(self, reviews: list[dict],
                     lookup_ns: Optional[NamespaceLookup] = None
                     ) -> list:
        """One micro-batch: returns per review either the mutated object
        (a fresh deep copy), None when nothing applies (no object — e.g.
        DELETE — or no matching mutator: the caller skips the deep copy
        AND the patch diff for the common all-allow case), or the
        MutationError raised for that review."""
        lookup = lookup_ns or (lambda name: None)
        active = self.active()
        out: list = []
        mask = self.match_mask(active, reviews, lookup) if active else None
        for r, review in enumerate(reviews):
            obj = review.get("object")
            mine = [active[int(c)] for c in np.flatnonzero(mask[r])] \
                if mask is not None else []
            if not isinstance(obj, dict) or not mine:
                out.append(None)
                continue
            try:
                out.append(self._converge(obj, mine))
            except MutationError as e:
                out.append(e)
        return out

    def mutate(self, review: dict,
               lookup_ns: Optional[NamespaceLookup] = None):
        """Single-review convenience over mutate_batch; raises the
        per-review MutationError instead of returning it. None means
        nothing applied."""
        res = self.mutate_batch([review], lookup_ns)[0]
        if isinstance(res, MutationError):
            raise res
        return res

    def _converge(self, obj: dict, mutators: list[Mutator]) -> dict:
        out = copy.deepcopy(obj)
        if not mutators:
            return out
        for _ in range(max(1, self.max_iterations)):
            changed = False
            for m in mutators:
                changed = m.apply(out) or changed
            if not changed:
                return out
        raise MutationError(
            f"mutation did not converge after {self.max_iterations} "
            f"iterations (mutators: "
            f"{sorted('/'.join(m.id) for m in mutators)})")
