"""Inventory-join templates on device: cross-object policy evaluation.

Templates like uniqueingresshost / uniqueserviceselector join each review
against the whole synced cluster state
(gatekeeper-library's library/general/uniqueingresshost/src.rego:8-18,
 library/general/uniqueserviceselector/src.rego:8-22) —
quadratic through any per-pair evaluator, and the last two general-library
templates with no device story. This module recognizes the join shape in
the merged template AST and splits the clause:

  review side   filters + join-key extraction, compiled to a codegen'd
                Python fn (exact; microseconds per review);
  inventory side  enumerate + filter + key extraction, one interpreter
                pass per data generation over the whole inventory
                (exact, O(M), cached until data changes);
  join          interned key ids, aggregated per unique key: the device
                answers "does some OTHER object share my key" with a
                searchsorted membership test against the sorted unique-key
                table carrying per-key object counts and (for singleton
                keys) the owner's identity key — O(N·H·log K) total,
                instead of the interpreter's O(N·M) rescan. On the card
                this is kernel K4 (kernels/join_member.py).

The `not identical(other, input.review)` exclusion becomes an identity-key
comparison: a review never fires on a key whose only holder is its own
stored copy. Identity fns may have ANY arity and MULTIPLE clauses — each
clause becomes an identity GROUP, and a pair is "identical" when any
group's tuples match; inline self-exclusion disequalities
(`name != input.review.object.metadata.name`) compile as single-pair
groups. `some`-decls are accepted, and an inventory ref used inline in a
literal (rather than bound `other := ...` first) is extracted into a
synthesized generator binding. The join decision is exact except in the
degenerate case of distinct inventory objects sharing one identity key
(then it may only OVER-fire); host materialization re-checks every firing
pair, the same authority contract as ir/evaltorch.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace as dc_replace
from typing import Optional

import numpy as np
import torch

from ..kernels.join_member import join_fences, join_member
from ..rego import ast as A
from ..rego.builtins import BUILTINS
from ..utils.values import thaw
from .aot import program_fingerprint
from .carry import to_tensor
from .compile import Uncompilable

REV_KEYS = "__join_rev_keys"
REV_IDENT = "__join_rev_ident"
INV_ENTRIES = "__join_inv_entries"
INV_IDENT = "__join_inv_ident"

# identity-key sentinels: never equal to any interned sid or to each other
IK_INV_MISSING = -1  # inventory object with undefined identity components
IK_REV_MISSING = -2  # review with undefined identity components
IK_MULTI = -3        # key held by >= 2 objects (identity irrelevant)
KEY_PAD = -5


# ------------------------------------------------------------- AST helpers


def _names(t, out: set) -> None:
    """All Var names appearing in a term (no fn names)."""
    if isinstance(t, A.Var):
        out.add(t.name)
    elif isinstance(t, A.Ref):
        _names(t.base, out)
        for a in t.args:
            _names(a, out)
    elif isinstance(t, A.Call):
        for a in t.args:
            _names(a, out)
    elif isinstance(t, A.BinOp):
        _names(t.lhs, out)
        _names(t.rhs, out)
    elif isinstance(t, A.UnaryMinus):
        _names(t.term, out)
    elif isinstance(t, (A.ArrayLit, A.SetLit)):
        for x in t.items:
            _names(x, out)
    elif isinstance(t, A.ObjectLit):
        for k, v in t.items:
            _names(k, out)
            _names(v, out)
    elif isinstance(t, (A.ArrayCompr, A.SetCompr)):
        _names(t.head, out)
        for lit in t.body:
            if not isinstance(lit.expr, A.SomeDecl):
                _names(lit.expr, out)
    elif isinstance(t, A.ObjectCompr):
        _names(t.key, out)
        _names(t.value, out)
        for lit in t.body:
            if not isinstance(lit.expr, A.SomeDecl):
                _names(lit.expr, out)
    elif isinstance(t, (A.Assign, A.Unify)):
        _names(t.lhs, out)
        _names(t.rhs, out)


def _subst(t, env: dict):
    """Replace Var occurrences by replacement ASTs (capture-naive; the
    substituted bodies are tiny field-projection chains)."""
    if isinstance(t, A.Var):
        return env.get(t.name, t)
    if isinstance(t, A.Ref):
        return A.Ref(base=_subst(t.base, env),
                     args=tuple(_subst(a, env) for a in t.args))
    if isinstance(t, A.Call):
        return A.Call(t.fn, tuple(_subst(a, env) for a in t.args))
    if isinstance(t, A.BinOp):
        return A.BinOp(t.op, _subst(t.lhs, env), _subst(t.rhs, env))
    if isinstance(t, A.UnaryMinus):
        return A.UnaryMinus(_subst(t.term, env))
    if isinstance(t, (A.ArrayLit, A.SetLit)):
        return type(t)(tuple(_subst(x, env) for x in t.items))
    if isinstance(t, A.ObjectLit):
        return A.ObjectLit(tuple((_subst(k, env), _subst(v, env))
                                 for k, v in t.items))
    return t


def _is_inventory_ref(t) -> Optional[A.Ref]:
    if isinstance(t, A.Ref) and isinstance(t.base, A.Var) and \
            t.base.name == "data" and t.args and \
            isinstance(t.args[0], A.Scalar) and t.args[0].value == "inventory":
        return t
    return None


# --------------------------------------------------------------- programs


@dataclass
class JoinClause:
    rev_keys: str     # partial-set rule: {[k1, k2, ...]} join-key tuples
    # identity-fn clauses become GROUPS: one (rev complete rule, inv
    # partial-set rule) pair per clause of the identity fn. A pair is
    # "identical" when ANY group's tuples match, so the exclusion
    # `not identical(...)` holds when EVERY group mismatches.
    rev_ident: list   # complete-rule names: [i1, i2, ...] per group
    inv_entries: str  # partial-set rule: {[[path...], [k...]]}
    inv_ident: list   # partial-set rules: {[[path...], [i...]]} per group


@dataclass
class JoinProgram:
    kind: str
    module: A.Module            # helpers + synthesized join rules
    clauses: list[JoinClause] = field(default_factory=list)


def _rule_flags(rules_by_name: dict) -> dict:
    """Transitive {'input','data'} read flags per rule/function name."""
    direct: dict[str, set] = {}
    deps: dict[str, set] = {}
    for name, rs in rules_by_name.items():
        flags: set = set()
        dep: set = set()

        def walk(t) -> None:
            if isinstance(t, A.Var):
                if t.name == "input":
                    flags.add("input")
                elif t.name == "data":
                    flags.add("data")
                elif t.name in rules_by_name:
                    dep.add(t.name)
            elif isinstance(t, A.Ref):
                walk(t.base)
                for a in t.args:
                    walk(a)
            elif isinstance(t, A.Call):
                if len(t.fn) == 1 and t.fn[0] in rules_by_name:
                    dep.add(t.fn[0])
                elif t.fn[0] == "data":
                    flags.add("data")
                for a in t.args:
                    walk(a)
            elif isinstance(t, A.BinOp):
                walk(t.lhs)
                walk(t.rhs)
            elif isinstance(t, A.UnaryMinus):
                walk(t.term)
            elif isinstance(t, (A.ArrayLit, A.SetLit)):
                for x in t.items:
                    walk(x)
            elif isinstance(t, A.ObjectLit):
                for k, v in t.items:
                    walk(k)
                    walk(v)
            elif isinstance(t, (A.ArrayCompr, A.SetCompr, A.ObjectCompr)):
                for lit in t.body:
                    if not isinstance(lit.expr, A.SomeDecl):
                        walk(lit.expr)
                for h in (getattr(t, "head", None), getattr(t, "key", None),
                          getattr(t, "value", None)):
                    if h is not None:
                        walk(h)
            elif isinstance(t, (A.Assign, A.Unify)):
                walk(t.lhs)
                walk(t.rhs)

        for r in rs:
            for lit in r.body:
                if not isinstance(lit.expr, A.SomeDecl):
                    walk(lit.expr)
            for h in (r.key, r.value):
                if h is not None:
                    walk(h)
            for a in r.args:
                walk(a)
        direct[name] = flags
        deps[name] = dep
    out = {n: set(f) for n, f in direct.items()}
    changed = True
    while changed:
        changed = False
        for n in out:
            for d in deps[n]:
                add = out.get(d, {"input", "data"}) - out[n]
                if add:
                    out[n] |= add
                    changed = True
    return out


def _rejects_parameters(module: A.Module) -> None:
    """Join programs are parameter-independent by construction (one
    fires[] per kind serves every constraint): any input.parameters
    reference — or a dynamic input reference that could reach it —
    makes the template uncompilable as a join."""

    def walk(t) -> None:
        if isinstance(t, A.Var):
            if t.name == "input":
                raise Uncompilable("join-input", "bare input reference")
        elif isinstance(t, A.Ref):
            if isinstance(t.base, A.Var) and t.base.name == "input":
                if not (t.args and isinstance(t.args[0], A.Scalar)
                        and t.args[0].value == "review"):
                    raise Uncompilable(
                        "join-input",
                        "input reference outside input.review "
                        "(parameterized join templates cannot share one "
                        "fires[] per kind)")
                for a in t.args:
                    walk(a)
                return
            walk(t.base)
            for a in t.args:
                walk(a)
        elif isinstance(t, A.Call):
            for a in t.args:
                walk(a)
        elif isinstance(t, A.BinOp):
            walk(t.lhs)
            walk(t.rhs)
        elif isinstance(t, A.UnaryMinus):
            walk(t.term)
        elif isinstance(t, (A.ArrayLit, A.SetLit)):
            for x in t.items:
                walk(x)
        elif isinstance(t, A.ObjectLit):
            for k, v in t.items:
                walk(k)
                walk(v)
        elif isinstance(t, (A.ArrayCompr, A.SetCompr, A.ObjectCompr)):
            for lit in t.body:
                if not isinstance(lit.expr, A.SomeDecl):
                    walk(lit.expr)
            for h in (getattr(t, "head", None), getattr(t, "key", None),
                      getattr(t, "value", None)):
                if h is not None:
                    walk(h)
        elif isinstance(t, (A.Assign, A.Unify)):
            walk(t.lhs)
            walk(t.rhs)

    for r in module.rules:
        for lit in r.body:
            if not isinstance(lit.expr, A.SomeDecl):
                walk(lit.expr)
        for h in (r.key, r.value):
            if h is not None:
                walk(h)
        for a in r.args:
            walk(a)


# -------------------------------------------------------------- recognizer


def _drop_head_only(body: list, head_names: set, rules: dict) -> list:
    """Remove Assign literals that only feed the violation head (the
    device decides fire/no-fire; host materialization recomputes msg)."""
    body = list(body)
    changed = True
    while changed:
        changed = False
        for i, lit in enumerate(body):
            e = lit.expr
            if lit.negated or not isinstance(e, A.Assign) or \
                    not isinstance(e.lhs, A.Var):
                continue
            name = e.lhs.name
            if name not in head_names:
                continue
            used = set()
            for j, other in enumerate(body):
                if j != i and not isinstance(other.expr, A.SomeDecl):
                    _names(other.expr, used)
            if name not in used:
                body.pop(i)
                changed = True
                break
    return body


def _find_inv_refs(t, out: list) -> None:
    """Collect inventory Ref nodes (by identity) anywhere in a term."""
    if isinstance(t, A.Ref):
        if _is_inventory_ref(t) is not None:
            out.append(t)
            return
        _find_inv_refs(t.base, out)
        for a in t.args:
            _find_inv_refs(a, out)
    elif isinstance(t, A.Call):
        for a in t.args:
            _find_inv_refs(a, out)
    elif isinstance(t, A.BinOp):
        _find_inv_refs(t.lhs, out)
        _find_inv_refs(t.rhs, out)
    elif isinstance(t, A.UnaryMinus):
        _find_inv_refs(t.term, out)
    elif isinstance(t, (A.ArrayLit, A.SetLit)):
        for x in t.items:
            _find_inv_refs(x, out)
    elif isinstance(t, A.ObjectLit):
        for k, v in t.items:
            _find_inv_refs(k, out)
            _find_inv_refs(v, out)
    elif isinstance(t, (A.Assign, A.Unify)):
        _find_inv_refs(t.lhs, out)
        _find_inv_refs(t.rhs, out)


def _replace_node(t, old, new):
    """Replace a node found by identity (splicing ref-into-ref bases)."""
    if t is old:
        return new
    if isinstance(t, A.Ref):
        base = _replace_node(t.base, old, new)
        args = tuple(_replace_node(a, old, new) for a in t.args)
        if isinstance(base, A.Ref):
            return A.Ref(base=base.base, args=base.args + args)
        return A.Ref(base=base, args=args)
    if isinstance(t, A.Call):
        return A.Call(t.fn, tuple(_replace_node(a, old, new)
                                  for a in t.args))
    if isinstance(t, A.BinOp):
        return A.BinOp(t.op, _replace_node(t.lhs, old, new),
                       _replace_node(t.rhs, old, new))
    if isinstance(t, A.UnaryMinus):
        return A.UnaryMinus(_replace_node(t.term, old, new))
    if isinstance(t, (A.ArrayLit, A.SetLit)):
        return type(t)(tuple(_replace_node(x, old, new) for x in t.items))
    if isinstance(t, A.ObjectLit):
        return A.ObjectLit(tuple((_replace_node(k, old, new),
                                  _replace_node(v, old, new))
                                 for k, v in t.items))
    if isinstance(t, (A.Assign, A.Unify)):
        return type(t)(_replace_node(t.lhs, old, new),
                       _replace_node(t.rhs, old, new))
    return t


def _split_inv_ref(ref: A.Ref):
    """Split an inline inventory ref at the object boundary:
    data.inventory.namespace[ns][apiv][kind][name](.residual...) — the
    first 5 (namespaced) / 4 (cluster) post-"inventory" segments address
    the object; the rest descend into it. None when the shape is off."""
    args = ref.args
    if len(args) < 2 or not isinstance(args[1], A.Scalar):
        return None
    n = {"namespace": 6, "cluster": 5}.get(args[1].value)
    if n is None or len(args) < n:
        return None
    head = A.Ref(base=ref.base, args=args[:n])
    return head, args[n:]


def _extract_inline_generators(body: list, idx: int) -> list:
    """Binding introduction for upstream-canonical clauses that use the
    inventory ref INLINE (`data.inventory.namespace[ns][_][\"Service\"]
    [name].spec.selector == sel`) instead of binding `other :=` first:
    each inline ref becomes a fresh generator binding plus a residual
    ref through the fresh var, which the side-splitter then classifies
    normally."""
    out: list = []
    n_fresh = 0
    for lit in body:
        e = lit.expr
        # a NEGATED inventory ref asserts absence — introducing a
        # positive generator binding for it would invert the semantics;
        # leave it for the generator locator to reject
        if lit.negated:
            out.append(lit)
            continue
        # the canonical binding form is left alone (the generator
        # locator owns it)
        if isinstance(e, (A.Assign, A.Unify)) and (
                _is_inventory_ref(e.rhs) is not None
                or _is_inventory_ref(e.lhs) is not None):
            out.append(lit)
            continue
        refs: list = []
        _find_inv_refs(e, refs)
        changed = False
        for ref in refs:
            split = _split_inv_ref(ref)
            if split is None:
                continue
            head, rest = split
            fresh = f"__jg{idx}_{n_fresh}"
            n_fresh += 1
            repl = A.Ref(base=A.Var(fresh), args=rest) if rest \
                else A.Var(fresh)
            e = _replace_node(e, ref, repl)
            out.append(A.Literal(expr=A.Assign(A.Var(fresh), head)))
            changed = True
        out.append(dc_replace(lit, expr=e) if changed else lit)
    return out


def _compile_clause(rule: A.Rule, rules_by_name: dict, idx: int,
                    new_rules: list, arg_pure: set) -> JoinClause:
    head_names: set = set()
    _names(rule.key, head_names)
    body = _drop_head_only(list(rule.body), head_names, rules_by_name)
    # `some ns, apiv, name` declarations scope vars the generator walk
    # names anyway — they carry no constraints of their own
    body = [lit for lit in body if not isinstance(lit.expr, A.SomeDecl)]
    body = _extract_inline_generators(body, idx)

    # locate the inventory generator
    gen_i = None
    for i, lit in enumerate(body):
        e = lit.expr
        tgt = None
        if isinstance(e, (A.Assign, A.Unify)):
            tgt = _is_inventory_ref(e.rhs) or _is_inventory_ref(e.lhs)
        else:
            tgt = _is_inventory_ref(e)
        if tgt is not None:
            if gen_i is not None:
                raise Uncompilable("join-generator", "multiple inventory generators")
            if lit.negated:
                raise Uncompilable("join-generator", "negated inventory generator")
            gen_i = i
    if gen_i is None:
        raise Uncompilable("join-generator", "no inventory generator")
    gen_lit = body[gen_i]
    ge = gen_lit.expr
    if not (isinstance(ge, (A.Assign, A.Unify)) and isinstance(ge.lhs, A.Var)
            and _is_inventory_ref(ge.rhs) is not None):
        raise Uncompilable("join-generator", "generator must bind a var")
    other_var = ge.lhs.name
    inv_ref = ge.rhs
    # name the path segments (wildcards get fresh names so the object id
    # tuple is always fully bound)
    path_vars: list[str] = []
    new_args: list = []
    for k, a in enumerate(inv_ref.args[1:]):  # skip the "inventory" segment
        if isinstance(a, A.Var):
            nm = a.name
            if nm.startswith("$wc"):
                nm = f"__jw{idx}_{k}"
            path_vars.append(nm)
            new_args.append(A.Var(nm))
        elif isinstance(a, A.Scalar):
            new_args.append(a)
        else:
            raise Uncompilable("join-generator", "complex inventory path segment")
    gen_expr = A.Assign(A.Var(other_var),
                        A.Ref(base=A.Var("data"),
                              args=(A.Scalar("inventory"),) + tuple(new_args)))
    gen_lit = A.Literal(expr=gen_expr)

    inv_vars = {other_var, *path_vars}
    rev_vars: set = set()
    rev_lits: list = []
    inv_lits: list = []
    join_pairs: list = []     # (inv_expr, rev_expr)
    ident_groups: list = []   # per identity-fn clause: [(inv, rev), ...]

    builtin1 = {fn[0] for fn in BUILTINS}
    rule_names = set(rules_by_name)
    fn_flags = _rule_flags(rules_by_name)

    def reads_of(t, out: set) -> None:
        """Var reads INCLUDING 'input'/'data' markers; calls to user
        functions and document-rule references propagate their bodies'
        transitive input/data reads (a 1-arg is_self helper reads input;
        a helper peeking at data.inventory reads data — the latter is
        rejected outside the generator, since both side evaluators run
        with only their own document mounted)."""
        if isinstance(t, A.Var):
            if t.name.startswith("$wc") or t.name in builtin1:
                return
            if t.name in rule_names:
                out |= fn_flags.get(t.name, {"input", "data"})
                return
            out.add(t.name)
            return
        if isinstance(t, A.Ref):
            reads_of(t.base, out)
            for a in t.args:
                reads_of(a, out)
            return
        if isinstance(t, A.Call):
            f = t.fn
            if len(f) == 1 and f[0] in rule_names:
                if f[0] not in arg_pure:
                    out |= fn_flags.get(f[0], {"input", "data"})
            elif f[0] == "data":
                out.add("data")
            for a in t.args:
                reads_of(a, out)
            return
        if isinstance(t, A.BinOp):
            reads_of(t.lhs, out)
            reads_of(t.rhs, out)
            return
        if isinstance(t, A.UnaryMinus):
            reads_of(t.term, out)
            return
        if isinstance(t, (A.ArrayLit, A.SetLit)):
            for x in t.items:
                reads_of(x, out)
            return
        if isinstance(t, A.ObjectLit):
            for k, v in t.items:
                reads_of(k, out)
                reads_of(v, out)
            return
        if isinstance(t, (A.ArrayCompr, A.SetCompr, A.ObjectCompr)):
            # inline comprehension: local binders over-approximate as
            # reads, which can only force a literal toward rev/mixed
            # (never silently into inv)
            for lit2 in getattr(t, "body", ()):
                if not isinstance(lit2.expr, A.SomeDecl):
                    reads_of(lit2.expr, out)
            for h in (getattr(t, "head", None), getattr(t, "key", None),
                      getattr(t, "value", None)):
                if h is not None:
                    reads_of(h, out)
            return
        if isinstance(t, (A.Assign, A.Unify)):
            reads_of(t.lhs, out)
            reads_of(t.rhs, out)
            return

    def var_reads(t) -> set:
        s: set = set()
        reads_of(t, s)
        return s

    def side_of(t) -> str:
        reads = var_reads(t)
        in_inv = bool(reads & inv_vars)
        in_rev = bool((reads - inv_vars) - {"data"})
        if in_inv and in_rev:
            return "mixed"
        if in_inv:
            return "inv"
        return "rev"

    for i, lit in enumerate(body):
        if i == gen_i:
            continue
        e = lit.expr
        if isinstance(e, A.SomeDecl):  # pragma: no cover - filtered above
            continue
        if lit.withs:
            raise Uncompilable("join-with", "with modifier")
        # exclusion: `not identical(other, input.review)` /
        # `not is_self(other)` — any arity: substitute formals with the
        # actual args, then each body equality must split into a pure
        # inventory-side and a pure review-side expression
        if lit.negated and isinstance(e, A.Call) and len(e.fn) == 1 and \
                e.fn[0] in rules_by_name and \
                rules_by_name[e.fn[0]][0].kind == "function" and \
                any(side_of(a) == "inv" for a in e.args):
            # each clause of the identity fn becomes its own GROUP of
            # (inv, rev) equality pairs — "identical" when any group's
            # tuples fully match, so the negation excludes exactly the
            # union of the clauses
            for fr in rules_by_name[e.fn[0]]:
                if fr.kind != "function":
                    raise Uncompilable("join-identity",
                                       "identity fn clause mix")
                if len(fr.args) != len(e.args) or \
                        not all(isinstance(a, A.Var) for a in fr.args):
                    raise Uncompilable("join-identity", "identity fn arg shape")
                env = {fa.name: aa for fa, aa in zip(fr.args, e.args)}
                pairs: list = []
                for bl in fr.body:
                    be = bl.expr
                    if bl.negated or not isinstance(be, (A.BinOp, A.Unify)) \
                            or (isinstance(be, A.BinOp) and be.op != "=="):
                        raise Uncompilable("join-identity", "identity fn body")
                    lhs = _subst(be.lhs, env)
                    rhs = _subst(be.rhs, env)
                    if "data" in (var_reads(lhs) | var_reads(rhs)):
                        raise Uncompilable("join-identity",
                                           "data read in identity fn")
                    ls, rs = side_of(lhs), side_of(rhs)
                    if ls == "inv" and rs == "rev":
                        pairs.append((lhs, rhs))
                    elif rs == "inv" and ls == "rev":
                        pairs.append((rhs, lhs))
                    else:
                        raise Uncompilable("join-identity", "identity eq shape")
                if not pairs:
                    raise Uncompilable("join-identity",
                                       "empty identity fn clause")
                ident_groups.append(pairs)
            continue
        if "data" in var_reads(e):
            raise Uncompilable("join-data", "data reference outside generator")
        # fresh-var assignments side with their rhs (the bound lhs is a
        # definition, not a cross-side read)
        if not lit.negated and isinstance(e, (A.Assign, A.Unify)) and \
                isinstance(e.lhs, A.Var) and \
                e.lhs.name not in (inv_vars | rev_vars):
            rhs_side = side_of(e.rhs)
            if rhs_side != "mixed":
                fresh = var_reads(e.rhs) | {e.lhs.name}
                if rhs_side == "inv":
                    inv_lits.append(lit)
                    inv_vars |= fresh
                else:
                    rev_lits.append(lit)
                    rev_vars |= fresh
                continue
        side = side_of(e)
        if side == "rev":
            rev_lits.append(lit)
            if not lit.negated:
                rev_vars |= var_reads(e)
            continue
        if side == "inv":
            inv_lits.append(lit)
            if not lit.negated:
                inv_vars |= var_reads(e)
            continue
        # mixed disequality (`name != input.review...name`, or
        # `not a == b`): an INLINE self-exclusion — exactly a
        # single-pair identity group (the pair is excluded when the
        # sides are equal). Inventory-side undefinedness over-fires
        # (missing sentinel mismatches), never under-fires.
        neq = None
        if not lit.negated and isinstance(e, A.BinOp) and e.op == "!=":
            neq = (e.lhs, e.rhs)
        elif lit.negated and (isinstance(e, A.Unify) or
                              (isinstance(e, A.BinOp) and e.op == "==")):
            neq = (e.lhs, e.rhs)
        if neq is not None:
            for a, b in (neq, neq[::-1]):
                if side_of(a) == "inv" and side_of(b) == "rev":
                    ident_groups.append([(a, b)])
                    break
            else:
                raise Uncompilable("join-mixed",
                                   "mixed disequality is not inv != rev")
            continue
        # mixed: must be a join equality with one pure side each
        if lit.negated or not isinstance(e, (A.BinOp, A.Unify)) or \
                (isinstance(e, A.BinOp) and e.op != "=="):
            raise Uncompilable("join-mixed", "unsupported mixed literal")
        for a, b in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
            if side_of(a) == "inv" and side_of(b) == "rev":
                join_pairs.append((a, b))
                break
        else:
            raise Uncompilable("join-mixed", "mixed literal is not inv==rev")

    if not join_pairs:
        raise Uncompilable("join-shape", "no join predicate")

    # ---- synthesized rules ------------------------------------------
    path_tuple = A.ArrayLit(tuple(A.Var(v) for v in path_vars))
    inv_key = A.ArrayLit(tuple(p[0] for p in join_pairs))
    rev_key = A.ArrayLit(tuple(p[1] for p in join_pairs))

    rk = f"{REV_KEYS}_{idx}"
    ie = f"{INV_ENTRIES}_{idx}"

    new_rules.append(A.Rule(name=rk, kind="partial_set", key=rev_key,
                            body=tuple(rev_lits)))
    new_rules.append(A.Rule(
        name=ie, kind="partial_set",
        key=A.ArrayLit((path_tuple, inv_key)),
        body=(gen_lit,) + tuple(inv_lits)))
    ris: list = []
    iis: list = []
    for g, pairs in enumerate(ident_groups):
        ri = f"{REV_IDENT}_{idx}_{g}"
        ii = f"{INV_IDENT}_{idx}_{g}"
        ris.append(ri)
        iis.append(ii)
        new_rules.append(A.Rule(
            name=ri, kind="complete",
            value=A.ArrayLit(tuple(p[1] for p in pairs)), body=()))
        new_rules.append(A.Rule(
            name=ii, kind="partial_set",
            key=A.ArrayLit((path_tuple,
                            A.ArrayLit(tuple(p[0] for p in pairs)))),
            body=(gen_lit,) + tuple(inv_lits)))
    return JoinClause(rev_keys=rk, rev_ident=ris, inv_entries=ie,
                      inv_ident=iis)


def compile_join(module: A.Module, kind: str) -> JoinProgram:
    """Compile a merged template module whose violation clauses are
    inventory joins. Raises Uncompilable outside the join shape."""
    rules_by_name: dict[str, list] = {}
    for r in module.rules:
        rules_by_name.setdefault(r.name, []).append(r)
    vio = rules_by_name.get("violation")
    if not vio:
        raise Uncompilable("join-shape", "no violation rule")
    _rejects_parameters(module)
    from ..rego.codegen import ModuleCompiler
    arg_pure = ModuleCompiler(module).arg_pure
    new_rules: list = [r for r in module.rules if r.name != "violation"]
    clauses = []
    for idx, r in enumerate(vio):
        if r.kind != "partial_set" or r.key is None:
            raise Uncompilable("join-shape", "violation shape")
        clauses.append(_compile_clause(r, rules_by_name, idx, new_rules,
                                       arg_pure))
    prog = JoinProgram(kind=kind,
                       module=dc_replace(module, rules=tuple(new_rules)),
                       clauses=clauses)
    return prog


# ----------------------------------------------------------------- runtime


def _pow2(n: int) -> int:
    out = 1
    while out < n:
        out *= 2
    return out


def pad_inventory(u, cnt, sik) -> tuple:
    """Inventory tables -> K4's (u_p[Kb], cnt_p[Kb], sik_p[G, Kb]) int32,
    Kb the power of two >= len(u): u_p padded with INT32_MAX, cnt_p with
    0, sik_p with IK_MULTI."""
    kb = _pow2(len(u))
    G = sik.shape[0]
    u_p = np.full(kb, np.iinfo(np.int32).max, dtype=np.int32)
    u_p[:len(u)] = u
    cnt_p = np.zeros(kb, dtype=np.int32)
    cnt_p[:len(u)] = cnt
    sik_p = np.full((G, kb), IK_MULTI, dtype=np.int32)
    sik_p[:, :len(u)] = sik
    return u_p, cnt_p, sik_p


def pad_reviews(keys: list, iks, hmax: int) -> tuple:
    """Review keys and identities -> K4's (karr[N, H], iks[N, G]) int32,
    H the power of two >= hmax, karr padded with KEY_PAD."""
    karr = np.full((len(keys), _pow2(hmax)), KEY_PAD, dtype=np.int32)
    for r, ks in enumerate(keys):
        karr[r, :len(ks)] = ks
    return karr, np.ascontiguousarray(iks, dtype=np.int32)


def _canon_sid(strtab, v) -> int:
    """Intern a frozen value as a join-key id. Strings take a fast path;
    composites go through canonical JSON, type-prefixed so e.g. the
    string '1' and the number 1 never collide."""
    if isinstance(v, str):
        return strtab.intern("k:s:" + v)
    return strtab.intern("k:j:" + json.dumps(thaw(v), sort_keys=True))


class JoinCompiled:
    """Driver-facing evaluator for one join template."""

    def __init__(self, prog: JoinProgram, strtab, device, kind: str = ""):
        from ..rego.codegen import compile_module
        from ..rego.interp import Interpreter

        self.prog = prog
        self.strtab = strtab
        # K4 runs where the driver evaluates (plain version on the CPU)
        self.device = torch.device(device)
        self.kind = kind
        self.fingerprint = program_fingerprint(prog.module,
                                               "join:" + kind)
        self._pkg = tuple(prog.module.package)
        self._interp = Interpreter({"join": prog.module})
        self._rev_fns = []
        for c in prog.clauses:
            fk = compile_module(prog.module, entry=c.rev_keys)
            fis = tuple(compile_module(prog.module, entry=ri)
                        for ri in c.rev_ident)
            self._rev_fns.append((fk, fis))
        # (data_gen, id(inventory_tree)) -> tabs; the tree identity keeps
        # two targets at the same data generation from sharing tables
        self._inv_cache: dict = {}
        # clause -> (inv_key, kb, device (u_p, cnt_p, sik_p))
        self._dev_inv_cache: dict = {}
        # clause -> (karr bytes, iks bytes, device (karr, iks)) — review
        # tensors are only reused when their CONTENT matches; keying by
        # shape alone returned stale fires when the candidate set changed
        # membership at equal size
        self._dev_rev_cache: dict = {}

    # ------------------------------------------------ inventory tables

    def inv_tables(self, inventory_tree, data_gen) -> list:
        """Per clause: (U sorted unique key sids, CNT objects per key,
        SIK [G, K] per-identity-group sid when CNT==1 else IK_MULTI,
        host dict). G >= 1 always — a template without an identity fn
        gets one group of missing sentinels, which never match."""
        cache_key = (data_gen, id(inventory_tree))
        hit = self._inv_cache.get(cache_key)
        # the entry pins the tree, so an id() hit can only be the same
        # object — the identity check guards against a tree freed and
        # re-allocated at the same address before this entry existed
        if hit is not None and hit[0] is inventory_tree:
            return hit[1]
        from ..rego.interp import UNDEF

        tabs = []
        for c in self.prog.clauses:
            entries = self._interp.eval_rule(
                self._pkg, c.inv_entries, None,
                overrides={("inventory",): inventory_tree})
            G = max(1, len(c.inv_ident))
            idents: dict = {}
            for g, ii in enumerate(c.inv_ident):
                iv = self._interp.eval_rule(
                    self._pkg, ii, None,
                    overrides={("inventory",): inventory_tree})
                if iv is not UNDEF:
                    for path, ident in iv:
                        ent = idents.setdefault(
                            path, [IK_INV_MISSING] * G)
                        ent[g] = self.strtab.intern(
                            "i:" + json.dumps(thaw(ident), sort_keys=True))
            by_key: dict[int, list] = {}
            if entries is not UNDEF:
                per_obj: dict = {}
                for path, key in entries:
                    per_obj.setdefault(path, set()).add(
                        _canon_sid(self.strtab, key))
                missing = (IK_INV_MISSING,) * G
                for path, ksids in per_obj.items():
                    ik = tuple(idents.get(path, missing))
                    for ks in ksids:
                        by_key.setdefault(ks, []).append(ik)
            u = np.array(sorted(by_key), dtype=np.int64)
            cnt = np.array([len(by_key[k]) for k in u], dtype=np.int32)
            sik = np.full((G, len(u)), IK_MULTI, dtype=np.int64)
            for j, k in enumerate(u):
                holders = by_key[k]
                if len(holders) == 1:
                    sik[:, j] = holders[0]
            host = {int(k): (int(c_), tuple(int(s) for s in sik[:, j]))
                    for j, (k, c_) in enumerate(zip(u, cnt))}
            tabs.append((u, cnt, sik, host))
        # stale generations (and their device tensors) can't be reused;
        # drop them so long-running audits don't accumulate tables
        if any(k[0] != data_gen for k in self._inv_cache):
            self._inv_cache = {k: v for k, v in self._inv_cache.items()
                               if k[0] == data_gen}
            self._dev_inv_cache.clear()
        self._inv_cache[cache_key] = (inventory_tree, tabs)
        return tabs

    # ------------------------------------------------------ review keys

    def _rev_eval(self, fn, frz_review, frozen_empty):
        from ..rego.interp import UNDEF
        from ..utils.values import FrozenDict

        if fn.__sections__:
            return fn(frz_review, FrozenDict(), frozen_empty)
        return fn(FrozenDict((("review", frz_review),)), frozen_empty)

    def review_keys(self, clause_i: int, frz_review) -> tuple:
        """(key sids list, per-group ident sid tuple) for one review;
        empty list when the review-side filters fail."""
        from ..rego.interp import UNDEF
        from ..utils.values import FrozenDict

        fk, fis = self._rev_fns[clause_i]
        G = max(1, len(fis))
        empty = FrozenDict()
        ks = self._rev_eval(fk, frz_review, empty)
        if ks is UNDEF or not ks:
            return [], (IK_REV_MISSING,) * G
        sids = sorted({_canon_sid(self.strtab, k) for k in ks})
        iks = [IK_REV_MISSING] * G
        for g, fi in enumerate(fis):
            iv = self._rev_eval(fi, frz_review, empty)
            if iv is not UNDEF:
                iks[g] = self.strtab.intern(
                    "i:" + json.dumps(thaw(iv), sort_keys=True))
        return sids, tuple(iks)

    def preload_aot(self) -> dict:
        """Ingest-time background prewarm (the JAX package's
        JoinCompiled.preload_aot): load K4's library, so that the first
        device join launches with no build on its path. The reference
        stores one executable per argument shape; K4 is one nvcc library
        for every shape, so the program store keeps no entry for it.
        Returns programs loaded, by tag."""
        if self.device.type != "cuda":
            return {}
        from ..kernels import join_member as k4

        k4.build()
        return {"join": 1}

    # ------------------------------------------------------------ fires

    # below this many reviews a host dict probe beats a device dispatch
    MIN_DEVICE_REVIEWS = 2048

    def fires(self, frz_reviews: list, inventory_tree, data_gen,
              key_cache: Optional[dict] = None) -> np.ndarray:
        """bool[N]: does some OTHER inventory object share a join key.
        key_cache (id(review) -> per-clause (keys, ident)), valid for one
        data generation, makes steady-state audits skip re-extraction."""
        tabs = self.inv_tables(inventory_tree, data_gen)
        n = len(frz_reviews)
        out = np.zeros(n, dtype=bool)
        for ci, (u, cnt, sik, host) in enumerate(tabs):
            if not len(u):
                continue
            G = sik.shape[0]
            keys = []
            iks = np.full((n, G), IK_REV_MISSING, dtype=np.int32)
            hmax = 0
            for r in range(n):
                rv = frz_reviews[r]
                hit = key_cache.get((ci, id(rv))) if key_cache is not None \
                    else None
                if hit is None:
                    hit = self.review_keys(ci, rv)
                    if key_cache is not None:
                        key_cache[(ci, id(rv))] = hit
                ks, ik = hit
                keys.append(ks)
                iks[r, :] = ik
                hmax = max(hmax, len(ks))
            if hmax == 0:
                continue
            if n >= self.MIN_DEVICE_REVIEWS:
                out |= self._fires_device(
                    ci, u, cnt, sik, keys, iks, hmax,
                    (data_gen, id(inventory_tree)))
            else:
                for r in range(n):
                    if out[r]:
                        continue
                    for k in keys[r]:
                        hit = host.get(k)
                        # fires unless the key's single holder is
                        # identical to the review under SOME group
                        if hit is not None and (
                                hit[0] >= 2
                                or not any(hs == int(ig) for hs, ig
                                           in zip(hit[1], iks[r]))):
                            out[r] = True
                            break
        return out

    def _fires_device(self, ci, u, cnt, sik, keys, iks, hmax,
                      inv_key) -> np.ndarray:
        """Device membership (K4): pad keys to [N, H], search them in the
        padded unique-key table, apply count/identity rules. Inventory
        tensors and K4's fences over them are cached per (clause, data
        generation, tree identity);
        review tensors are rebuilt on host every call and their device
        copies reused only when the BYTES match — steady-state audits
        (same candidate list) skip the H2D upload, while a changed
        candidate set of equal size never sees stale keys."""
        # int32 throughout, as the JAX package runs it (x64 off; interned
        # sids always fit)
        G = sik.shape[0]
        kb = _pow2(len(u))
        ent = self._dev_inv_cache.get(ci)
        if ent is not None and ent[0] == inv_key and ent[1] == (kb, G):
            inv_args, fences = ent[2], ent[3]
        else:
            inv_args = tuple(to_tensor(a, self.device)
                             for a in pad_inventory(u, cnt, sik))
            fences = join_fences(inv_args[0])
            self._dev_inv_cache[ci] = (inv_key, (kb, G), inv_args, fences)

        karr, iks32 = pad_reviews(keys, iks, hmax)
        kb_bytes, ik_bytes = karr.tobytes(), iks32.tobytes()
        rev = self._dev_rev_cache.get(ci)
        if rev is not None and rev[0] == kb_bytes and rev[1] == ik_bytes:
            rev_args = rev[2]
        else:
            rev_args = (to_tensor(karr, self.device),
                        to_tensor(iks32, self.device))
            self._dev_rev_cache[ci] = (kb_bytes, ik_bytes, rev_args)
        return join_member(*inv_args, *rev_args, KEY_PAD,
                           fences).cpu().numpy()
