"""Driver seam + the interpreter-backed reference driver.

The Driver protocol is the framework's replaceable evaluation backend —
shape parity with the reference interface
(vendor/.../constraint/pkg/client/drivers/interface.go:21-39): module CRUD,
data CRUD at tree paths, Query, Dump. Two implementations exist:

  * RegoDriver (here): modules run in the tree-walking interpreter; the
    hook join (matching constraints ⋈ template violation rules,
    reference regolib/src.go:23-62) and the match predicate
    (pkg/target/regolib/src.rego) are evaluated natively rather than as
    installed Rego — same results, no meta-interpretation.
  * TpuDriver (ir/driver.py): compiles templates to vectorized JAX programs
    and evaluates reviews in batches; falls back to this driver for
    templates outside the vectorizable subset.

Paths are tuples of segments (not strings), so no URL escaping is needed
anywhere. Well-known roots (reference client.go:79-86, 493-511):
  ("constraints", <target>, "cluster", <group>, <Kind>, <name>)
  ("external", <target>, ...)       synced inventory
"""

from __future__ import annotations

import json
import logging
from typing import Any, Iterable, Optional, Protocol

from ..rego import ast as A
from ..rego.interp import UNDEF, Interpreter, RegoError
from ..target.matcher import constraint_matches, needs_autoreject
from ..utils.values import FrozenDict, freeze, sort_key, thaw
from .templates import CONSTRAINT_GROUP
from .types import Response, Result

log = logging.getLogger("gatekeeper_tpu_torch.client.drivers")


class DriverError(Exception):
    pass


class Driver(Protocol):
    def init(self) -> None: ...

    def put_module(self, name: str, module: A.Module) -> None: ...

    def put_modules(self, prefix: str, modules: Iterable[A.Module]) -> None: ...

    def delete_module(self, name: str) -> bool: ...

    def delete_modules(self, prefix: str) -> int: ...

    def put_data(self, path: tuple, data: Any) -> None: ...

    def delete_data(self, path: tuple) -> bool: ...

    def query(self, path: tuple, input_value: Any = None,
              tracing: bool = False) -> Response: ...

    def dump(self) -> str: ...


def hook_violation_path(target: str) -> tuple:
    return ("hooks", target, "violation")


def hook_audit_path(target: str) -> tuple:
    return ("hooks", target, "audit")


def split_group_version(gv: str) -> tuple[str, str]:
    group, _, version = gv.rpartition("/")
    return group, version


class RegoDriver:
    """Interpreter-backed driver with native hook/matcher evaluation."""

    def __init__(self):
        self._interp = Interpreter()
        self._module_names: set[str] = set()
        self._trace_sink: Optional[list] = None
        # per-template codegen'd materializers (rego/codegen.py): None =
        # outside the compilable subset, fall through to the interpreter
        self._codegen: dict[tuple, Any] = {}
        # kind -> (review, dict): per-review memo for review-pure
        # comprehensions in the codegen'd evaluator
        self._rmemo: dict[str, tuple] = {}
        # kind -> (frozen inventory, dict): arg-pure function memo
        self._fmemo: dict[str, tuple] = {}
        # kind -> {id(constraint): (constraint, dict)}: params-pure
        # comprehension memo, one dict per constraint (valid for its
        # lifetime; identity-checked so a replaced constraint re-derives)
        self._pmemo: dict[str, dict] = {}
        # kind -> dict: head-witness memo — (slot, *witness values) ->
        # materialized head tuple. Values-keyed over pure computation, so
        # never invalidated by data churn; cleared on module changes and
        # capped for boundedness
        self._hmemo: dict[str, dict] = {}
        # identity-keyed freeze caches for the audit materialization loop
        # (consecutive firing pairs share the review; constraints repeat)
        self._frz_review: dict[int, tuple] = {}
        self._frz_params: dict[int, tuple] = {}
        self._frz_inv: tuple = (None, None)
        self._plain_constraint: dict[int, tuple] = {}
        # steady-state audit caches: flattening 100k inventory objects into
        # review dicts (and computing their match signatures) each sweep
        # costs seconds; both are stable until the data tree changes
        self._data_rev = 0
        self._inv_reviews_cache: dict[str, tuple] = {}  # target -> (rev, l)
        self._inv_key_cache: dict[str, tuple] = {}  # target -> (rev, keys)
        self._sig_cache: dict[str, tuple] = {}  # target -> (rev, dict)
        self._inv_tree_cache: dict[str, tuple] = {}  # target -> (rev, tree)
        # audit-scoped freeze cache: id(review) -> (review, frozen),
        # valid for one data generation (inventory reviews are stable
        # then), journal-patched on single-object replacements. Sized by
        # the inventory, unlike the small capped _frz_review the
        # webhook's transient reviews go through.
        self._audit_frz: tuple = (None, {})
        # incremental-mutation journal: ("patch", rev, target, index,
        # old_review, new_review) for single-object in-place replacements
        # that PATCHED the warm caches, ("break", rev) for anything else.
        # Consumers (mask/feature caches in ir/driver.py) replay the
        # range since their snapshot instead of rebuilding from scratch.
        self._patch_notes: list = []
        self._con_rev = 0  # constraint-store revision (ns-selector cache)
        self._ns_sel_cache: tuple = (None, False)
        # per-constraint violation cap applied BEFORE message
        # materialization (control/audit.py arms it with its status
        # violations limit): pairs beyond the cap for their constraint
        # still count toward totals but skip message assembly — capped
        # constraints stop paying for messages that are never published
        self.audit_violations_cap: Optional[int] = None
        # audit ownership predicate pred(gv, kind, namespace) -> bool,
        # installed by the sharded audit plane (control/shardmap.py) so
        # this driver flattens reviews only for its inventory slice.
        # None = unsharded. Applies ONLY to review building — the
        # inventory data tree stays whole so joins and interpreter
        # data.inventory reads keep seeing broadcast objects.
        self.audit_review_filter = None

    # ------------------------------------------------------------- modules

    def init(self) -> None:  # hooks are native; nothing to install
        return None

    def put_module(self, name: str, module: A.Module) -> None:
        self._interp.put_module(name, module)
        self._module_names.add(name)
        self._codegen.clear()
        self._rmemo.clear()
        self._fmemo.clear()
        self._pmemo.clear()
        self._hmemo.clear()

    def put_modules(self, prefix: str, modules: Iterable[A.Module]) -> None:
        # mirror of PutModules upsert semantics (local.go:124-148): existing
        # modules under the prefix not in the new set are removed
        new_names = []
        mods = list(modules)
        for i, m in enumerate(mods):
            new_names.append(f"{prefix}#{i}")
        for old in sorted(self._module_names):
            if old.startswith(prefix + "#") and old not in new_names:
                self._interp.delete_module(old)
                self._module_names.discard(old)
        for name, m in zip(new_names, mods):
            self._interp.put_module(name, m)
            self._module_names.add(name)
        self._codegen.clear()
        self._rmemo.clear()
        self._fmemo.clear()
        self._pmemo.clear()
        self._hmemo.clear()

    def delete_module(self, name: str) -> bool:
        if name not in self._module_names:
            return False
        self._interp.delete_module(name)
        self._module_names.discard(name)
        self._codegen.clear()
        self._rmemo.clear()
        self._fmemo.clear()
        self._pmemo.clear()
        self._hmemo.clear()
        return True

    def delete_modules(self, prefix: str) -> int:
        doomed = [n for n in self._module_names if n.startswith(prefix + "#")]
        for n in doomed:
            self._interp.delete_module(n)
            self._module_names.discard(n)
        self._codegen.clear()
        self._rmemo.clear()
        self._fmemo.clear()
        self._pmemo.clear()
        self._hmemo.clear()
        return len(doomed)

    # ---------------------------------------------------------------- data

    def put_data(self, path: tuple, data: Any) -> None:
        if not path:
            raise DriverError("cannot put data at the root")
        self._interp.put_data(tuple(path), data)
        self._frz_params.clear()
        self._plain_constraint.clear()
        self._frz_inv = (None, None)
        if path[0] != "constraints":
            # constraint churn leaves the inventory-review/signature/tree
            # caches valid — only actual inventory writes invalidate them
            self._data_rev += 1
            self._note_inventory_write(tuple(path), deleted=False)
        else:
            # bound growth: dead constraint objects would pin stale
            # per-constraint memo dicts (identity checks keep them safe,
            # clearing keeps them small)
            self._pmemo.clear()
            self._con_rev += 1

    def delete_data(self, path: tuple) -> bool:
        if not path:
            raise DriverError("cannot delete the data root")
        out = self._interp.delete_data(tuple(path))
        self._frz_params.clear()
        self._plain_constraint.clear()
        self._frz_inv = (None, None)
        if path[0] != "constraints":
            self._data_rev += 1
            self._note_inventory_write(tuple(path), deleted=True)
        else:
            self._pmemo.clear()
            self._con_rev += 1
        return out

    # ------------------------------------------------ incremental writes

    def drop_inventory_caches(self) -> None:
        """Full re-encode backstop: forget every derived inventory cache
        so the next audit rebuilds from the raw data tree. The
        incremental audit's --audit-full-resync-every routes here — a
        reachable from-scratch path self-heals any cache-patching bug."""
        self._data_rev += 1
        self._patch_notes.append(("break", self._data_rev))
        self._inv_reviews_cache.clear()
        self._inv_key_cache.clear()
        self._sig_cache.clear()
        self._inv_tree_cache.clear()
        self._audit_frz = (None, {})
        self._frz_inv = (None, None)

    def set_audit_review_filter(self, pred) -> None:
        """Install (or clear, pred=None) the audit ownership predicate.
        Tears down every derived inventory cache: the flattened review
        list changes shape under a new filter, and any cache keyed off
        it (signatures, encoded rows downstream) must rebuild from the
        filtered view. Installed once at shard start, so the full
        rebuild is a non-event."""
        if pred is self.audit_review_filter:
            return
        self.audit_review_filter = pred
        self.drop_inventory_caches()

    # spine depth below each scope node at which object leaves sit:
    # cluster/<gv>/<kind>/<name>, namespace/<ns>/<gv>/<kind>/<name> —
    # the same layout knowledge _try_patch_reviews encodes below
    _INV_SCOPE_DEPTH = {"cluster": 3, "namespace": 4}

    def inventory_snapshot(self) -> Optional[dict]:
        """PLAIN copy of the synced-inventory subtree ("external") for
        the warm-restart blob snapshot. Plain on purpose: unpickling
        plain dicts is C-native, while reconstructing FrozenDict leaves
        costs a Python call per node — and every consumer of the tree
        (review building, the frozen _inventory_tree cache, the
        interpreter's _freeze_review memo) freezes on demand anyway,
        exactly as it does for never-frozen admission reviews. The one
        deep pass here runs on the snapshot thread, off the serving
        path; a concurrent mutation mid-copy fails the save (caught by
        the manager — previous snapshot kept), never corrupts it. None
        when empty."""
        tree = self._interp.get_data(("external",))
        if tree is UNDEF or not isinstance(tree, dict):
            return None
        return _deep_plain(tree) or None

    def inventory_restore(self, tree: dict) -> int:
        """Attach a snapshotted synced-inventory subtree, bypassing the
        per-object add_data path (target-handler processing, freezing,
        journal notes, and cache invalidation per object) that makes a
        cold boot O(cluster) — the warm-restart fast path. Leaves stay
        plain; eval paths freeze them on demand (see
        inventory_snapshot), and any later per-object put_data
        re-freezes its own leaf. Returns the number of objects
        installed; unknown scopes are skipped (the tracker's resync
        cold-path heals them)."""
        if not isinstance(tree, dict):
            raise DriverError("inventory snapshot must be a mapping")
        n = 0
        root = self._interp.data
        ext = root.get("external")
        if not isinstance(ext, dict):
            ext = {}
            root["external"] = ext

        def count(node, left: int) -> int:
            if left == 0:
                return 1
            if not isinstance(node, dict):
                return 0
            return sum(count(v, left - 1) for v in node.values())

        for target, scopes in tree.items():
            if not isinstance(scopes, dict):
                continue
            tnode = ext.get(target)
            if not isinstance(tnode, dict):
                tnode = {}
                ext[target] = tnode
            for scope, sub in scopes.items():
                depth = self._INV_SCOPE_DEPTH.get(scope)
                if depth is None or not isinstance(sub, dict):
                    continue
                tnode[scope] = dict(sub)
                n += count(sub, depth)
        # one journal break + cache drop for the whole install: the next
        # audit rebuilds reviews from the restored tree exactly as it
        # would after a full resync
        self.drop_inventory_caches()
        self._frz_params.clear()
        self._plain_constraint.clear()
        return n

    def _note_inventory_write(self, path: tuple, deleted: bool) -> None:
        notes = self._patch_notes
        if len(notes) >= 1024:
            # journal cap: older ranges fall out of coverage and replay
            # degrades to a rebuild (checked via note count == rev delta)
            del notes[: len(notes) // 2]
        patched = None if deleted else self._try_patch_reviews(path)
        if patched is None:
            notes.append(("break", self._data_rev))
        else:
            notes.append(("patch", self._data_rev) + patched)

    def _any_namespace_selector(self) -> bool:
        """True when any stored constraint matches via namespaceSelector
        (cached per constraint revision)."""
        ent = self._ns_sel_cache
        if ent[0] == self._con_rev:
            return ent[1]
        found = False
        root = self._interp.get_data(("constraints",))
        stack = [root] if isinstance(root, dict) else []
        while stack and not found:
            node = stack.pop()
            for v in node.values():
                if not isinstance(v, dict):
                    continue
                if v.get("kind") and isinstance(v.get("spec"), dict):
                    match = v["spec"].get("match")
                    if isinstance(match, dict) and \
                            "namespaceSelector" in match:
                        found = True
                        break
                else:
                    stack.append(v)
        self._ns_sel_cache = (self._con_rev, found)
        return found

    def _notes_between(self, rev_a: int, rev_b: int):
        """Patch notes for writes in (rev_a, rev_b], or None when the
        range is uncovered or contains a non-patchable write."""
        if rev_b <= rev_a:
            return []
        sel = [n for n in self._patch_notes if rev_a < n[1] <= rev_b]
        if len(sel) != rev_b - rev_a or any(n[0] == "break" for n in sel):
            return None
        return sel

    def _try_patch_reviews(self, path: tuple):
        """In-place REPLACEMENT of a single existing inventory object
        patches the warm steady-state caches (review list, signature
        cache, frozen inventory tree) instead of invalidating them — the
        churning-cluster case where one object mutates between audits.
        Inserts, deletes, and non-object writes return None (rebuild).
        Returns (target, index, old_review, new_review) on success."""
        import bisect

        if len(path) < 2 or path[0] != "external":
            return None
        target = path[1]
        rest = path[2:]
        if len(rest) == 4 and rest[0] == "cluster":
            gv, kind, name = rest[1], rest[2], rest[3]
            sort_key_t = (0, "", gv, kind, name)
            ns = None
        elif len(rest) == 5 and rest[0] == "namespace":
            ns, gv, kind, name = rest[1], rest[2], rest[3], rest[4]
            sort_key_t = (1, ns, gv, kind, name)
        else:
            return None
        if kind == "Namespace" and self._any_namespace_selector():
            # a Namespace's labels feed OTHER reviews' match verdicts
            # through namespaceSelector; patching only its own mask row
            # would leave every other review in that namespace stale
            return None
        prev = self._data_rev - 1
        cached = self._inv_reviews_cache.get(target)
        keys = self._inv_key_cache.get(target)
        if cached is None or cached[0] != prev or keys is None or \
                keys[0] != prev:
            return None
        reviews, keylist = cached[1], keys[1]
        i = bisect.bisect_left(keylist, sort_key_t)
        if not (i < len(keylist) and keylist[i] == sort_key_t):
            return None  # insertion would shift every later index
        node = self._interp.get_data(tuple(path))
        if node is UNDEF or not isinstance(node, dict):
            return None
        group, version = split_group_version(gv)
        new_review = {"kind": {"group": group, "version": version,
                               "kind": kind},
                      "name": name, "object": node}
        if ns is not None:
            new_review["namespace"] = ns
        old = reviews[i]
        reviews[i] = new_review
        self._inv_reviews_cache[target] = (self._data_rev, reviews)
        self._inv_key_cache[target] = (self._data_rev, keylist)
        sig = self._sig_cache.get(target)
        if sig is not None and sig[0] == prev:
            sig[1].pop(id(old), None)
            self._sig_cache[target] = (self._data_rev, sig[1])
        tre = self._inv_tree_cache.get(target)
        if tre is not None and tre[0] == prev:
            self._inv_tree_cache[target] = (
                self._data_rev,
                _tree_with(tre[1], rest, freeze(_deep_plain(node))))
        return (target, i, old, new_review)

    def get_data(self, path: tuple) -> Any:
        v = self._interp.get_data(tuple(path))
        return None if v is UNDEF else v

    # --------------------------------------------------------------- query

    def query(self, path: tuple, input_value: Any = None,
              tracing: bool = False) -> Response:
        path = tuple(path)
        trace: Optional[list] = [] if tracing else None
        if len(path) == 3 and path[0] == "hooks" and path[2] == "violation":
            results = self._eval_violation(path[1], input_value or {}, trace)
        elif len(path) == 3 and path[0] == "hooks" and path[2] == "audit":
            results = self._eval_audit(path[1], trace)
        else:
            results = self._eval_data_path(path, input_value)
        resp = Response(results=results)
        if tracing:
            resp.trace = "\n".join(trace or [])
            resp.input = json.dumps(thaw(freeze(input_value)), sort_keys=True)
        return resp

    # hooks["<target>"].violation — the admission path (regolib/src.go:7-41)
    def _eval_violation(self, target: str, input_value: dict,
                        trace: Optional[list]) -> list[Result]:
        review = input_value.get("review") or {}
        results: list[Result] = []
        lookup_ns = self._namespace_lookup(target)
        inventory = self._inventory_tree(target)
        for constraint in self._constraints(target):
            spec = constraint.get("spec")
            spec = spec if isinstance(spec, dict) else {}
            match = spec.get("match")
            match = match if isinstance(match, dict) else {}
            enforcement = spec.get("enforcementAction") or "deny"
            if needs_autoreject(match, review, lookup_ns):
                if trace is not None:
                    trace.append(
                        f"autoreject {constraint.get('kind')}/"
                        f"{(constraint.get('metadata') or {}).get('name')}"
                    )
                results.append(Result(
                    msg="Namespace is not cached in OPA.",
                    metadata={"details": {}},
                    constraint=thaw(freeze(constraint)),
                    review=review,
                    enforcement_action=enforcement,
                ))
                # no `continue`: the reference hook UNIONS autoreject with
                # matching_constraints results (regolib/src.go rules 1+2) —
                # a Namespace-kind review can still match via its own labels
            if not constraint_matches(constraint, review, lookup_ns):
                continue
            results.extend(
                self._eval_template_violations(
                    target, constraint, review, enforcement, inventory, trace
                )
            )
        return results

    # hooks["<target>"].audit — cached-state sweep (regolib/src.go:45-62)
    def _eval_audit(self, target: str, trace: Optional[list]) -> list[Result]:
        results: list[Result] = []
        lookup_ns = self._namespace_lookup(target)
        constraints = self._constraints(target)
        inventory = self._inventory_tree(target)
        for review in self._inventory_reviews(target):
            for constraint in constraints:
                if not constraint_matches(constraint, review, lookup_ns):
                    continue
                spec = constraint.get("spec")
                spec = spec if isinstance(spec, dict) else {}
                enforcement = spec.get("enforcementAction") or "deny"
                results.extend(
                    self._eval_template_violations(
                        target, constraint, review, enforcement, inventory,
                        trace
                    )
                )
        return results

    def _codegen_for(self, target: str, kind: str):
        """Per-template codegen'd materializer, or None (interpreter
        path). Built lazily from the same rewritten modules the
        interpreter holds, merged into one compile unit."""
        key = (target, kind)
        if key in self._codegen:
            return self._codegen[key]
        fn = None
        prefix = f'templates["{target}"]["{kind}"]#'
        names = sorted(n for n in self._module_names
                       if n.startswith(prefix))
        if names:
            from ..rego.codegen import Unsupported, compile_module
            # lazy: ir imports this module at load; no cycle at call time
            from ..ir.driver import merge_template_modules
            mods = [self._interp.modules[n] for n in names]
            try:
                merged = (mods[0] if len(mods) == 1
                          else merge_template_modules(mods))
                if merged is not None:
                    fn = compile_module(merged, entry="violation")
            except Unsupported as e:
                log.debug("codegen unsupported for %s: %s", kind, e)
                fn = None
        self._codegen[key] = fn
        return fn

    def _freeze_review_audit(self, review: dict):
        ent = self._audit_frz
        if ent[0] != self._data_rev:
            notes = self._notes_between(ent[0], self._data_rev) \
                if ent[0] is not None else None
            if notes is None:
                ent = (self._data_rev, {})
            else:
                for n in notes:
                    ent[1].pop(id(n[4]), None)  # replaced review object
                ent = (self._data_rev, ent[1])
            self._audit_frz = ent
        m = ent[1]
        c = m.get(id(review))
        if c is not None and c[0] is review:
            return c[1]
        f = freeze(review)
        m[id(review)] = (review, f)
        return f

    def _freeze_review(self, review: dict):
        # id-keyed with identity check: a micro-batch sweeps the same
        # reviews once per KIND, and a single-entry cache would re-freeze
        # the whole batch for every kind after the first
        c = self._frz_review.get(id(review))
        if c is not None and c[0] is review:
            return c[1]
        if len(self._frz_review) > 32768:
            # bound retention: webhook reviews are transient (never
            # reused), so the cache exists for audits re-sweeping the
            # stable inventory — ~32k distinct materialized objects
            self._frz_review.clear()
        f = freeze(review)
        self._frz_review[id(review)] = (review, f)
        return f

    def _freeze_params(self, constraint: dict, parameters):
        c = self._frz_params.get(id(constraint))
        if c is not None and c[0] is constraint:
            return c[1]
        f = freeze(parameters)
        self._frz_params[id(constraint)] = (constraint, f)
        return f

    def _freeze_inv(self, inventory):
        if isinstance(inventory, FrozenDict):
            return inventory  # _inventory_tree output is deep-frozen
        c = self._frz_inv
        if c[0] is inventory:
            return c[1]
        f = freeze(inventory)
        self._frz_inv = (inventory, f)
        return f

    def _constraint_plain(self, constraint: dict) -> dict:
        """Result.constraint deep-copy, cached per constraint object (one
        audit materializes the same constraint thousands of times)."""
        c = self._plain_constraint.get(id(constraint))
        if c is not None and c[0] is constraint:
            return c[1]
        p = thaw(freeze(constraint))
        self._plain_constraint[id(constraint)] = (constraint, p)
        return p

    def _eval_template_violations(self, target: str, constraint: dict,
                                  review: dict, enforcement: str,
                                  inventory: Any,
                                  trace: Optional[list]) -> list[Result]:
        kind = constraint.get("kind")
        pkg = ("templates", target, kind)
        if pkg not in self._interp.packages:
            return []
        spec = constraint.get("spec")
        spec = spec if isinstance(spec, dict) else {}
        parameters = spec.get("parameters")
        if parameters is None:
            parameters = {}
        out = _MISSING_OUT = object()
        fn = self._codegen_for(target, kind) if trace is None else None
        if fn is not None:
            frz_review = self._freeze_review(review)
            frz_params = self._freeze_params(constraint, parameters)
            # review-pure comprehension memo: audit materialization is
            # row-major, so consecutive calls share the review — reuse its
            # review-only subresults across the constraints it fired
            ent = self._rmemo.get(kind)
            if ent is None or ent[0] is not review:
                ent = (review, {})
                self._rmemo[kind] = ent
            # arg-pure function memo: scoped to the frozen inventory tree,
            # so inventory-join projections (selector flattening etc.)
            # evaluate once per inventory object, not once per (review ×
            # object) pair
            frozen_inv = self._freeze_inv(inventory)
            fent = self._fmemo.get(kind)
            if fent is None or fent[0] is not frozen_inv:
                fent = (frozen_inv, {})
                self._fmemo[kind] = fent
            # params-pure memo: one dict per constraint object
            pmap = self._pmemo.setdefault(kind, {})
            pent = pmap.get(id(constraint))
            if pent is None or pent[0] is not constraint:
                pent = (constraint, {})
                pmap[id(constraint)] = pent
            # head-witness memo: cross-review AND cross-constraint
            hm = self._hmemo.get(kind)
            if hm is None:
                hm = self._hmemo[kind] = {}
            elif len(hm) > 500_000:
                hm.clear()
            try:
                if fn.__sections__:
                    out = fn(frz_review, frz_params, frozen_inv, ent[1],
                             fent[1], pent[1], hm)
                else:
                    finp = FrozenDict((("review", frz_review),
                                       ("parameters", frz_params)))
                    out = fn(finp, frozen_inv, ent[1], fent[1], pent[1], hm)
            except RegoError as e:
                raise DriverError(
                    f"evaluating {kind} violation: {e}"
                ) from e
            except Exception as e:
                # a codegen bug must be visible, never silent, and must
                # not take the request down: log + permanent fallback
                log.warning("codegen evaluator for %s failed (%s: %s); "
                            "falling back to the interpreter",
                            kind, type(e).__name__, e)
                self._codegen[(target, kind)] = None
                out = _MISSING_OUT
        if out is _MISSING_OUT:
            inp = {"review": review, "parameters": parameters}
            try:
                out = self._interp.eval_rule(
                    pkg, "violation", inp,
                    overrides={("inventory",): inventory}
                )
            except RegoError as e:
                raise DriverError(
                    f"evaluating {kind} violation: {e}"
                ) from e
        results = []
        if out is UNDEF:
            return results
        constraint_plain = self._constraint_plain(constraint)
        ordered = out if len(out) <= 1 else sorted(out, key=sort_key)
        for r in ordered:
            if not isinstance(r, FrozenDict) or "msg" not in r:
                raise DriverError(
                    f"template {kind}: violation output must be an object "
                    f"with msg, got {thaw(r)!r}"
                )
            msg = r["msg"]
            if not isinstance(msg, str):
                raise DriverError(f"template {kind}: msg must be a string")
            details = thaw(r["details"]) if "details" in r else {}
            if trace is not None:
                trace.append(f"violation {kind}: {msg}")
            results.append(Result(
                msg=msg,
                metadata={"details": details},
                constraint=constraint_plain,
                review=review,
                enforcement_action=enforcement,
            ))
        return results

    def _vec_msgs(self, target: str, kind: str, cons: list,
                  pair_reviews: list, rows, cols, cand):
        """Vectorized per-pair message assembly hook. The base driver
        has no encoded columns: always the exact path. TpuDriver
        overrides with the ir/vecmat.py plan evaluator, returning
        (status[P] int8, msgs[P], details) — status 1 = message ready,
        0 = veto (exact evaluator), 2 = provably no violation."""
        return None

    def materialize_pairs(self, target: str, cons: list, pair_reviews: list,
                          rows, cols, inventory: Any,
                          cand=None) -> list[Result]:
        """Batched exact materialization of firing (review, constraint)
        pairs, row-major. Semantically identical to calling
        _eval_template_violations per pair (the audit differential tests
        assert that), but:

          * kinds with a message plan (ir/vecmat.py) render their
            messages VECTORIZED — one numpy assembly pass over the
            already-built witness columns instead of one evaluator call
            per pair — with per-pair fallback to the exact evaluator
            for witnesses outside the plan's subset (the differential
            suite asserts bit-equal messages either way);
          * the exact path hoists per-constraint context (frozen
            params, enforcement, plain copy, params-memo) and
            per-review context (frozen review, review-memo) out of the
            pair loop, and caches thawed msg/details per distinct
            violation object;
          * with audit_violations_cap armed, vectorized pairs past the
            cap for their constraint emit count-only results (empty
            msg) — the status writer never publishes past its limit,
            so the messages were pure waste.

        `cand`, when given, maps pair rows to global inventory-review
        indices (rows index pair_reviews == [reviews[i] for i in
        cand]), letting witness columns cache across sweeps on the
        stable full review list. Results share constraint/details
        structures (callers treat results as read-only, as they
        already must for .constraint)."""
        if not len(rows):
            return []
        kind = cons[0].get("kind")
        vec = self._vec_msgs(target, kind, cons, pair_reviews, rows, cols,
                             cand)
        fn = self._codegen_for(target, kind)
        if fn is None and vec is None:
            out: list[Result] = []
            for ri, ci in zip(rows, cols):
                c = cons[int(ci)]
                spec = c.get("spec")
                spec = spec if isinstance(spec, dict) else {}
                out.extend(self._eval_template_violations(
                    target, c, pair_reviews[int(ri)],
                    spec.get("enforcementAction") or "deny", inventory,
                    None))
            return out
        # per-constraint context, built once
        n_c = len(cons)
        frz_params: list = [None] * n_c
        enforce: list = [None] * n_c
        plain: list = [None] * n_c
        pmemos: list = [None] * n_c
        pmap = self._pmemo.setdefault(kind, {})
        for ci in range(n_c):
            c = cons[ci]
            spec = c.get("spec")
            spec = spec if isinstance(spec, dict) else {}
            p = spec.get("parameters")
            frz_params[ci] = self._freeze_params(c, p if p is not None
                                                 else {})
            enforce[ci] = spec.get("enforcementAction") or "deny"
            plain[ci] = self._constraint_plain(c)
            pe = pmap.get(id(c))
            if pe is None or pe[0] is not c:
                pe = (c, {})
                pmap[id(c)] = pe
            pmemos[ci] = pe[1]
        frozen_inv = self._freeze_inv(inventory)
        fent = self._fmemo.get(kind)
        if fent is None or fent[0] is not frozen_inv:
            fent = (frozen_inv, {})
            self._fmemo[kind] = fent
        fmemo = fent[1]
        hm = self._hmemo.get(kind)
        if hm is None:
            hm = self._hmemo[kind] = {}
        elif len(hm) > 500_000:
            hm.clear()
        sections = fn.__sections__ if fn is not None else None
        vcache: dict[int, tuple] = {}  # id(violation) -> (msg, details)
        out = []
        append = out.append
        cur_ri = -1
        frz_review = None
        review = None
        rmemo: dict = {}
        # plain-int lists: iterating numpy scalars costs ~100ns per
        # element extraction and they are slow dict keys
        rows = rows.tolist() if hasattr(rows, "tolist") else rows
        cols = cols.tolist() if hasattr(cols, "tolist") else cols
        vec_status = vec_msgs = vec_details = None
        if vec is not None:
            vec_status, vec_msgs, vec_details = vec
        # the cap applies only inside a full audit sweep (the flag is
        # set by the sweep entry point): what-if previews and direct
        # pair materialization stay uncapped
        cap = (self.audit_violations_cap
               if getattr(self, "_in_audit_sweep", False) else None)
        # per-call cap counters: blocks of one sweep each materialize at
        # most `cap` messages per constraint, so the sweep's global
        # first `cap` per constraint are always fully materialized even
        # when mesh blocks reassemble out of materialization order
        cap_counts: dict[int, int] = {}
        n_vec = n_capped = 0
        for j, (ri, ci) in enumerate(zip(rows, cols)):
            if vec_status is not None:
                st = vec_status[j]
                if st == 2:  # msg witness undefined for this constraint:
                    continue  # the head binding fails — no violation
                if st == 1:
                    n_vec += 1
                    if cap is not None:
                        seen = cap_counts.get(ci, 0)
                        cap_counts[ci] = seen + 1
                        if seen >= cap:
                            n_capped += 1
                            append(Result(
                                msg="",
                                metadata={"details": {}},
                                constraint=plain[ci],
                                review=pair_reviews[ri],
                                enforcement_action=enforce[ci],
                            ))
                            continue
                    append(Result(
                        msg=vec_msgs[j],
                        metadata={"details": vec_details},
                        constraint=plain[ci],
                        review=pair_reviews[ri],
                        enforcement_action=enforce[ci],
                    ))
                    continue
            if ri != cur_ri:
                cur_ri = ri
                review = pair_reviews[ri]
                frz_review = self._freeze_review_audit(review)
                ent = self._rmemo.get(kind)
                if ent is None or ent[0] is not review:
                    ent = (review, {})
                    self._rmemo[kind] = ent
                rmemo = ent[1]
            if fn is None:  # demoted mid-batch / no codegen: exact path
                out.extend(self._eval_template_violations(
                    target, cons[ci], review, enforce[ci], inventory,
                    None))
                continue
            try:
                if sections:
                    res = fn(frz_review, frz_params[ci], frozen_inv, rmemo,
                             fmemo, pmemos[ci], hm)
                else:
                    finp = FrozenDict((("review", frz_review),
                                       ("parameters", frz_params[ci])))
                    res = fn(finp, frozen_inv, rmemo, fmemo, pmemos[ci], hm)
            except RegoError as e:
                raise DriverError(
                    f"evaluating {kind} violation: {e}") from e
            except Exception as e:
                log.warning("codegen evaluator for %s failed (%s: %s); "
                            "falling back to the interpreter",
                            kind, type(e).__name__, e)
                self._codegen[(target, kind)] = None
                fn = None
                out.extend(self._eval_template_violations(
                    target, cons[ci], review, enforce[ci], inventory,
                    None))
                continue
            if res is UNDEF or not res:
                continue
            ordered = (tuple(res) if len(res) == 1
                       else sorted(res, key=sort_key))
            for r in ordered:
                ent2 = vcache.get(id(r))
                if ent2 is None or ent2[0] is not r:
                    if not isinstance(r, FrozenDict) or "msg" not in r:
                        raise DriverError(
                            f"template {kind}: violation output must be "
                            f"an object with msg, got {thaw(r)!r}")
                    msg = r["msg"]
                    if not isinstance(msg, str):
                        raise DriverError(
                            f"template {kind}: msg must be a string")
                    details = thaw(r["details"]) if "details" in r else {}
                    ent2 = (r, msg, details)
                    vcache[id(r)] = ent2
                append(Result(
                    msg=ent2[1],
                    metadata={"details": ent2[2]},
                    constraint=plain[ci],
                    review=review,
                    enforcement_action=enforce[ci],
                ))
        return out

    # ---------------------------------------------------------- store views

    def _constraints(self, target: str) -> list[dict]:
        root = self._interp.get_data(("constraints", target, "cluster",
                                      CONSTRAINT_GROUP))
        if root is UNDEF or not isinstance(root, dict):
            return []
        out = []
        for kind in sorted(root):
            by_name = root[kind]
            if isinstance(by_name, dict):
                for name in sorted(by_name):
                    if isinstance(by_name[name], dict):
                        out.append(by_name[name])
        return out

    def _namespace_lookup(self, target: str):
        def lookup(name: str):
            v = self._interp.get_data(
                ("external", target, "cluster", "v1", "Namespace", name)
            )
            return None if v is UNDEF or not isinstance(v, dict) else v
        return lookup

    def _inventory_tree(self, target: str) -> Any:
        cached = self._inv_tree_cache.get(target)
        if cached is not None and cached[0] == self._data_rev:
            return cached[1]
        v = self._interp.get_data(("external", target))
        tree = {} if v is UNDEF else freeze(_deep_plain(v))
        self._inv_tree_cache[target] = (self._data_rev, tree)
        return tree

    def _inventory_reviews(self, target: str) -> list[dict]:
        """Flatten the inventory into make_review-shaped dicts
        (reference regolib src.rego:40-61). Cached until the data tree
        changes — the recurring audit sweep's steady state."""
        cached = self._inv_reviews_cache.get(target)
        if cached is not None and cached[0] == self._data_rev:
            return cached[1]
        reviews, keys = self._build_inventory_reviews(target)
        self._inv_reviews_cache[target] = (self._data_rev, reviews)
        self._inv_key_cache[target] = (self._data_rev, keys)
        return reviews

    def _audit_sig_cache(self, target: str) -> dict:
        """Match-signature cache (id(review) -> signature) valid for the
        cached review list of the current data revision."""
        cached = self._sig_cache.get(target)
        if cached is not None and cached[0] == self._data_rev:
            return cached[1]
        sigs: dict = {}
        self._sig_cache[target] = (self._data_rev, sigs)
        return sigs

    def _build_inventory_reviews(self, target: str) -> tuple:
        """-> (reviews, sort keys) aligned; the key list lets single-
        object writes bisect to their review index for in-place cache
        patching (_try_patch_reviews)."""
        reviews: list[dict] = []
        keys: list[tuple] = []
        root = self._interp.get_data(("external", target))
        if root is UNDEF or not isinstance(root, dict):
            return reviews, keys
        flt = self.audit_review_filter
        cluster = root.get("cluster")
        if isinstance(cluster, dict):
            for gv in sorted(cluster):
                by_kind = cluster[gv]
                if not isinstance(by_kind, dict):
                    continue
                group, version = split_group_version(gv)
                for kind in sorted(by_kind):
                    by_name = by_kind[kind]
                    if not isinstance(by_name, dict):
                        continue
                    if flt is not None and not flt(gv, kind, ""):
                        continue
                    for name in sorted(by_name):
                        reviews.append({
                            "kind": {"group": group, "version": version,
                                     "kind": kind},
                            "name": name,
                            "object": by_name[name],
                        })
                        keys.append((0, "", gv, kind, name))
        namespaced = root.get("namespace")
        if isinstance(namespaced, dict):
            for ns in sorted(namespaced):
                by_gv = namespaced[ns]
                if not isinstance(by_gv, dict):
                    continue
                for gv in sorted(by_gv):
                    by_kind = by_gv[gv]
                    if not isinstance(by_kind, dict):
                        continue
                    group, version = split_group_version(gv)
                    for kind in sorted(by_kind):
                        by_name = by_kind[kind]
                        if not isinstance(by_name, dict):
                            continue
                        if flt is not None and not flt(gv, kind, ns):
                            continue
                        for name in sorted(by_name):
                            reviews.append({
                                "kind": {"group": group, "version": version,
                                         "kind": kind},
                                "name": name,
                                "namespace": ns,
                                "object": by_name[name],
                            })
                            keys.append((1, ns, gv, kind, name))
        return reviews, keys

    def _eval_data_path(self, path: tuple, input_value: Any) -> list[Result]:
        """Generic data query: wrap each value at `path` as a bare Result
        (used by tests and Dump; the reference local driver's
        data.<path>[result] shape, local.go:302-324)."""
        if len(path) >= 2:
            pkg, name = tuple(path[:-1]), path[-1]
            if pkg in self._interp.packages and name in self._interp.packages[pkg]:
                v = self._interp.eval_rule(pkg, name, input_value)
                if v is UNDEF:
                    return []
                return [Result(msg="", metadata={"value": thaw(v)})]
        v = self._interp.get_data(path)
        if v is UNDEF:
            return []
        return [Result(msg="", metadata={"value": thaw(freeze(_deep_plain(v)))})]

    # ---------------------------------------------------------------- dump

    def dump(self) -> str:
        data = thaw(freeze(_deep_plain(self._interp.data)))
        return json.dumps({
            "modules": sorted(self._module_names),
            "data": data,
        }, indent=2, sort_keys=True)


def _tree_with(tree: Any, segs: tuple, frozen_value: Any) -> Any:
    """Frozen inventory tree with tree[segs...] replaced, rebuilding
    only the spine (O(path depth x siblings), not O(inventory))."""
    if not segs:
        return frozen_value
    base = tree if isinstance(tree, dict) else {}
    d = dict(base)
    d[segs[0]] = _tree_with(base.get(segs[0]), segs[1:], frozen_value)
    return FrozenDict(d)


def _deep_plain(v: Any) -> Any:
    """Make a store subtree JSON-able (mutable dict shells + frozen leaves)."""
    if isinstance(v, dict):
        return {k: _deep_plain(x) for k, x in v.items()}
    return thaw(v)
