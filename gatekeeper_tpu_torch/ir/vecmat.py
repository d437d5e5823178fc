"""Vectorized violation-message materialization.

The audit's device sweep answers "which (object, constraint) pairs fire"
in ~0.3s; turning those pairs into violation MESSAGES was ~3x slower
than the sweep itself (BENCH_r04/r05: `materialize_s` ~ 3x
`sweep_wall_s`) because every firing pair re-ran the template's codegen
evaluator in Python just to rebuild a string the clause head already
determines. This module removes that Python-per-pair work for the
common head shape:

    violation[{"msg": msg, "details": {}}] {
      ...body...
      msg := sprintf("... %v ... %v ...", [<witness>, <witness>])
    }

by compiling the head ONCE per template into a `MsgPlan` — constant
fmt segments plus typed witness fillers — and filling the witnesses for
all firing pairs at once with numpy fancy-indexing over fixed-width
unicode columns (the same technique ops/strtab.py uses for its
pattern-window caches):

  * const args render once at plan time;
  * `input.parameters...` args are constraint-constant: rendered once
    per constraint with the EXACT host sprintf verb logic;
  * `input.review...` scalar paths become per-row witness columns
    (built in one pass over the review list, cached per data revision);
  * `{v | v = input.review...[_][k]}` set comprehensions become per-row
    pre-rendered set strings (the forbidden-sysctls shape).

Assembly is then `seg0 + wit0[rows] + seg1_c[cols] + ...` over U-dtype
arrays — numpy C loops, no per-pair Python.

Correctness contract (differential-tested bit-equal against the exact
per-pair evaluator, tests/test_materialize_vec.py):

  * the plan only applies when the compiled device program is EXACT —
    `program_exactness` proves the filter can never over-fire, so a
    firing pair IS a violation (plus per-constraint runtime conditions
    for param slots whose values must be non-composite);
  * witnesses outside the representable subset VETO their pair back to
    the exact evaluator: absent / non-string row values, strings past
    the fixed-width window cap, constraints whose param path is
    undefined;
  * templates whose messages read anything else (per-axis witnesses
    like container names, helper-function msgs, non-const details)
    produce no plan at all and keep the exact path wholesale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..rego import ast as A
from ..rego.builtins import BuiltinError, bi_sprintf
from ..utils.values import freeze
from .prog import (
    And,
    Arith,
    Cmp,
    Const,
    DerivedVal,
    Exists,
    KindIs,
    MatchLookup,
    Not,
    Or,
    OrReduce,
    OVal,
    Program,
    PVal,
    SumReduce,
    Truthy,
)

# fixed-width unicode columns cost O(rows x max_len); past this length
# the padded array is a bad trade and the pair vetoes to the exact path
# (same constant family as ops.strtab.MatchTables.MAX_VECTOR_STRLEN)
MAX_WITNESS_STRLEN = 512


# ----------------------------------------------------------- exactness


def _num_exactness(e) -> Optional[tuple]:
    """-> (point, nid_free, conditions) for a numeric operand, or None
    when unsupported. Mirrors evaljax._eval_num: cell leaves are point
    values carrying a canonical-number id (tie-capable); SumReduce /
    count leaves are nid-free; Arith widens to an interval."""
    if isinstance(e, SumReduce):
        conds = _bool_exactness(e.e)
        if conds is None:
            return None
        return (True, True, conds)
    if isinstance(e, OVal) and e.f in ("count", "countz"):
        return (True, True, set())
    if isinstance(e, PVal) and e.f == "count":
        return (True, True, set())
    if isinstance(e, Arith):
        return (False, True, None)  # interval-widened: never exact
    if isinstance(e, (OVal, PVal, Const, DerivedVal)):
        return (True, False, set())  # point value, tie-capable nid
    return None


def _never_composite(e) -> bool:
    """Can this cell expr statically never hold an array/object?"""
    return isinstance(e, Const)


def _bool_exactness(e) -> Optional[set]:
    """The set of runtime conditions under which this expr's BPair is
    exact (lo == hi), or None when it can over-fire regardless.

    Conditions are ("pval_scalar", slot): every encoded value of that
    param slot must be non-composite — checked per constraint set at
    materialize time (composite "maybe"-equality is the one auto-eq
    uncertainty a param-side kind check can discharge)."""
    if isinstance(e, Cmp):
        if e.dtype == "auto":
            # _cell_eq's `maybe` needs BOTH sides composite of the same
            # kind: a side that can never be composite makes eq exact;
            # a PVal side becomes a runtime param-kind condition
            if _never_composite(e.lhs) or _never_composite(e.rhs):
                return set()
            for side in (e.lhs, e.rhs):
                if isinstance(side, PVal):
                    return {("pval_scalar", side.slot)}
            return None
        lx = _num_exactness(e.lhs)
        rx = _num_exactness(e.rhs)
        if lx is None or rx is None:
            return None
        lp, lnf, lc = lx
        rp, rnf, rc = rx
        if not lnf and not rnf:
            return None  # f32 tie between two canonical ids possible
        if not (lp and rp):
            return None  # interval operand: hi over-approximates
        return (lc or set()) | (rc or set())
    if isinstance(e, (MatchLookup, Truthy, Exists, KindIs, Const)):
        return set()
    if isinstance(e, (And, Or)):
        out: set = set()
        for x in e.items:
            c = _bool_exactness(x)
            if c is None:
                return None
            out |= c
        return out
    if isinstance(e, Not):
        return _bool_exactness(e.e)
    if isinstance(e, OrReduce):
        return _bool_exactness(e.e)
    if isinstance(e, SumReduce):
        return _bool_exactness(e.e)
    return None


def program_exactness(program: Program) -> Optional[set]:
    """Conditions under which the compiled filter is EXACT (fires ==
    interpreter truth), or None when it may over-fire. The vectorized
    message path requires exactness: it renders a message for every
    firing pair without re-running the evaluator."""
    out: set = set()
    for clause in program.clauses:
        for g in clause.guards:
            c = _bool_exactness(g.expr)
            if c is None:
                return None
            out |= c
    return out


# ------------------------------------------------------------ planning


@dataclass(frozen=True)
class Witness:
    """One fmt placeholder filler.

    kind: "const" (pre-rendered), "param" (path into spec.parameters,
    rendered per constraint), "row" (scalar path into the review dict),
    "rowset" ({v | v = path} set comprehension over the review).
    segs for row/rowset: tuple of ("f", name) | ("iter",).
    """

    kind: str
    spec: str = ""   # "%"-spec + verb, e.g. "v" or "04d"
    text: str = ""   # pre-rendered (const)
    segs: tuple = ()


@dataclass(frozen=True)
class MsgPlan:
    segments: tuple          # len(witnesses) + 1 constant fmt pieces
    witnesses: tuple         # of Witness
    details: Any             # plain constant (shared across results)
    conditions: frozenset    # program_exactness output


def _parse_fmt(fmt: str):
    """Split a sprintf fmt into (segments, [(spec, verb)]) with the
    exact scan bi_sprintf uses (%% folds into the literal segment)."""
    segs = []
    verbs = []
    cur = []
    i, n = 0, len(fmt)
    while i < n:
        c = fmt[i]
        if c != "%":
            cur.append(c)
            i += 1
            continue
        if i + 1 < n and fmt[i + 1] == "%":
            cur.append("%")
            i += 2
            continue
        j = i + 1
        while j < n and fmt[j] in "+-# 0123456789.":
            j += 1
        if j >= n:
            return None  # trailing %: let the exact path raise
        segs.append("".join(cur))
        cur = []
        verbs.append((fmt[i + 1: j], fmt[j]))
        i = j + 1
    segs.append("".join(cur))
    return segs, verbs


def _const_term_value(t):
    """Plain Python value of a constant AST literal, or _REJECT."""
    if isinstance(t, A.Scalar):
        return t.value
    if isinstance(t, A.ArrayLit):
        out = []
        for x in t.items:
            v = _const_term_value(x)
            if v is _REJECT:
                return _REJECT
            out.append(v)
        return out
    if isinstance(t, A.ObjectLit):
        out = {}
        for k, v in t.items:
            kk = _const_term_value(k)
            vv = _const_term_value(v)
            if kk is _REJECT or vv is _REJECT or not isinstance(kk, str):
                return _REJECT
            out[kk] = vv
        return out
    if isinstance(t, A.SetLit):
        return _REJECT  # sets as details never appear; keep exact
    return _REJECT


_REJECT = object()


def _input_path(t, binds, depth=0):
    """Resolve a term to ("review"|"params", segs-of-field-names) by
    following static refs and var bindings; None when not a plain
    scalar input path."""
    if depth > 16:
        return None
    if isinstance(t, A.Var):
        rhs = binds.get(t.name)
        if rhs is None:
            return None
        return _input_path(rhs, binds, depth + 1)
    if not isinstance(t, A.Ref):
        return None
    segs: list = []
    base = t.base
    for a in t.args:
        if not (isinstance(a, A.Scalar) and isinstance(a.value, str)):
            return None
        segs.append(a.value)
    if isinstance(base, A.Var):
        if base.name == "input":
            if not segs:
                return None
            if segs[0] == "review":
                return ("review", tuple(segs[1:]))
            if segs[0] == "parameters":
                return ("params", tuple(segs[1:]))
            return None
        head = _input_path(base, binds, depth + 1)
        if head is None:
            return None
        return (head[0], head[1] + tuple(segs))
    if isinstance(base, A.Ref):
        head = _input_path(base, binds, depth + 1)
        if head is None:
            return None
        return (head[0], head[1] + tuple(segs))
    return None


def _iter_path(t, binds, taken_vars, depth=0):
    """Resolve a set-comprehension element ref to ("review", segs) where
    segs mixes ("f", name) fields and ("iter",) iteration points. The
    iteration vars must be wildcards or vars unused anywhere else
    (uncorrelated — `taken_vars` holds every var the rest of the rule
    mentions)."""
    if depth > 16:
        return None
    if isinstance(t, A.Var):
        rhs = binds.get(t.name)
        if rhs is None:
            return None
        return _iter_path(rhs, binds, taken_vars, depth + 1)
    if not isinstance(t, A.Ref):
        return None
    if isinstance(t.base, A.Var) and t.base.name == "input":
        head: tuple = ()
        args = list(t.args)
        if not args or not (isinstance(args[0], A.Scalar)
                            and args[0].value == "review"):
            return None
        args = args[1:]
    else:
        base = _iter_path(t.base, binds, taken_vars, depth + 1)
        if base is None or base[0] != "review":
            return None
        head = base[1]
        args = list(t.args)
    segs: list = list(head)
    seen_iter_vars: set = set()
    for a in args:
        if isinstance(a, A.Scalar) and isinstance(a.value, str):
            segs.append(("f", a.value))
        elif isinstance(a, A.Var):
            nm = a.name
            if not nm.startswith("$wc"):
                if nm in taken_vars or nm in seen_iter_vars:
                    return None  # correlated/bound var: keep exact
                seen_iter_vars.add(nm)
            segs.append(("iter",))
        else:
            return None
    return ("review", tuple(segs))


def _total_const(t) -> bool:
    """Can this binding rhs never be undefined? (const literals only —
    anything else keeps the template on the exact path)"""
    return _const_term_value(t) is not _REJECT


def _needed_vars(rule):
    from .compile import _needed_vars as nv

    return nv(rule)


def _rule_plan(rule: A.Rule, conditions: set):
    """MsgPlan for one violation rule, or None."""
    head = rule.key
    if not isinstance(head, A.ObjectLit):
        return None
    msg_term = None
    details = {}
    for k, v in head.items:
        if not (isinstance(k, A.Scalar) and isinstance(k.value, str)):
            return None
        if k.value == "msg":
            msg_term = v
        elif k.value == "details":
            details = _const_term_value(v)
            if details is _REJECT:
                return None
        else:
            return None
    if msg_term is None:
        return None
    binds: dict[str, Any] = {}
    for lit in rule.body:
        e = lit.expr
        if lit.negated or lit.withs:
            continue
        if isinstance(e, (A.Assign, A.Unify)) and isinstance(e.lhs, A.Var):
            if e.lhs.name in binds:
                return None  # double binding: unification, keep exact
            binds[e.lhs.name] = e.rhs
    # resolve msg through bindings to a sprintf call / plain string
    msg_chain: set = set()
    t = msg_term
    for _ in range(16):
        if isinstance(t, A.Var):
            if t.name not in binds:
                return None
            msg_chain.add(t.name)
            t = binds[t.name]
            continue
        break
    if isinstance(t, A.Scalar) and isinstance(t.value, str):
        segments: tuple = (t.value,)
        verbs: list = []
        args: list = []
    elif isinstance(t, A.Call) and tuple(t.fn) == ("sprintf",) and \
            len(t.args) == 2 and isinstance(t.args[0], A.Scalar) and \
            isinstance(t.args[0].value, str) and \
            isinstance(t.args[1], A.ArrayLit):
        parsed = _parse_fmt(t.args[0].value)
        if parsed is None:
            return None
        seg_list, verbs = parsed
        args = list(t.args[1].items)
        if len(verbs) != len(args):
            return None
        segments = tuple(seg_list)
    else:
        return None
    # vars the rule mentions OUTSIDE comprehension bodies (for the
    # comprehension-correlation check): an iteration var of a witness
    # set comprehension must not be captured from the enclosing clause
    # — comprehension-LOCAL vars are locally scoped and safe
    taken: set = set()
    for lit in rule.body:
        e = lit.expr
        if isinstance(e, (A.Assign, A.Unify)) and \
                isinstance(e.lhs, A.Var) and e.lhs.name in msg_chain:
            continue
        _collect_outer_vars(e, taken)
    witnesses: list = []
    for (spec, verb), arg in zip(verbs, args):
        w = _witness_for(arg, binds, taken, msg_chain, spec, verb)
        if w is None:
            return None
        witnesses.append(w)
    # totality: every skipped (neither guard-needed nor msg-chain)
    # binding must be provably defined — an undefined head-only binding
    # fails the clause in the interpreter while the device still fires
    needed = _needed_vars(rule)
    for name, rhs in binds.items():
        if name in needed or name in msg_chain or name.startswith("$wc"):
            continue
        if not _total_const(rhs):
            return None
    return MsgPlan(segments=segments, witnesses=tuple(witnesses),
                   details=details, conditions=frozenset(conditions))


def _collect_outer_vars(t, out: set) -> None:
    """_collect_vars, but comprehensions are opaque: their heads and
    bodies bind locally and never capture an iteration var INTO the
    enclosing clause."""
    if isinstance(t, (A.ArrayCompr, A.SetCompr, A.ObjectCompr)):
        return
    if isinstance(t, A.Var):
        out.add(t.name)
    elif isinstance(t, A.Ref):
        _collect_outer_vars(t.base, out)
        for a in t.args:
            _collect_outer_vars(a, out)
    elif isinstance(t, A.Call):
        for a in t.args:
            _collect_outer_vars(a, out)
    elif isinstance(t, A.BinOp):
        _collect_outer_vars(t.lhs, out)
        _collect_outer_vars(t.rhs, out)
    elif isinstance(t, A.UnaryMinus):
        _collect_outer_vars(t.term, out)
    elif isinstance(t, (A.ArrayLit, A.SetLit)):
        for x in t.items:
            _collect_outer_vars(x, out)
    elif isinstance(t, A.ObjectLit):
        for k, v in t.items:
            _collect_outer_vars(k, out)
            _collect_outer_vars(v, out)
    elif isinstance(t, (A.Assign, A.Unify)):
        _collect_outer_vars(t.lhs, out)
        _collect_outer_vars(t.rhs, out)


def _witness_for(arg, binds, taken, msg_chain, spec, verb):
    # resolve var indirection (collect into msg_chain so totality
    # checking knows these bindings are definedness-handled here)
    t = arg
    for _ in range(16):
        if isinstance(t, A.Var) and t.name in binds:
            msg_chain.add(t.name)
            t = binds[t.name]
            continue
        break
    v = _const_term_value(t)
    if v is not _REJECT:
        try:
            return Witness(kind="const",
                           text=bi_sprintf("%" + spec + verb,
                                           (freeze(v),)))
        except BuiltinError:
            return None
    if isinstance(t, A.SetCompr):
        if verb not in ("v", "s") or spec:
            return None
        if not isinstance(t.head, A.Var):
            return None
        hv = t.head.name
        body = [lit for lit in t.body
                if not isinstance(lit.expr, A.SomeDecl)]
        if len(body) != 1 or body[0].negated or body[0].withs:
            return None
        e = body[0].expr
        if not isinstance(e, (A.Assign, A.Unify)):
            return None
        if isinstance(e.lhs, A.Var) and e.lhs.name == hv:
            ref = e.rhs
        elif isinstance(e.rhs, A.Var) and e.rhs.name == hv:
            ref = e.lhs
        else:
            return None
        p = _iter_path(ref, binds, taken)
        if p is None:
            return None
        return Witness(kind="rowset", spec=spec + verb, segs=p[1])
    p = _input_path(t, binds)
    if p is None:
        return None
    if p[0] == "params":
        return Witness(kind="param", spec=spec + verb, segs=p[1])
    if verb not in ("v", "s") or spec:
        # numeric verbs need a number witness; veto-by-kind can't
        # distinguish "%d of a string" errors — keep the exact path
        return None
    return Witness(kind="row", spec=spec + verb, segs=p[1])


def plan_messages(module: A.Module, program: Program) -> Optional[MsgPlan]:
    """The template's message plan, or None when any violation rule's
    head falls outside the vectorizable subset (per-axis witnesses,
    helper-function msgs, non-const details, inexact device filter)."""
    conditions = program_exactness(program)
    if conditions is None:
        return None
    plans = []
    for rule in module.rules:
        if rule.name != "violation":
            continue
        p = _rule_plan(rule, conditions)
        if p is None:
            return None
        plans.append(p)
    if not plans:
        return None
    # multiple clauses must share ONE plan: the device verdict is their
    # OR, so distinct messages per clause are not attributable
    first = plans[0]
    for p in plans[1:]:
        if p != first:
            return None
    return first


# ----------------------------------------------------------- witnesses


def _descend(node, segs):
    for s in segs:
        if not isinstance(node, dict):
            return _REJECT
        node = node.get(s, _REJECT)
        if node is _REJECT:
            return _REJECT
    return node


def _collect_set(node, segs, i, out: list) -> None:
    while i < len(segs) and segs[i][0] == "f":
        if not isinstance(node, dict):
            return
        node = node.get(segs[i][1], _REJECT)
        if node is _REJECT:
            return
        i += 1
    if i == len(segs):
        out.append(node)
        return
    # segs[i] is ("iter",)
    if isinstance(node, dict):
        kids = node.values()
    elif isinstance(node, (list, tuple)):
        kids = node
    else:
        return
    for v in kids:
        _collect_set(v, segs, i + 1, out)


def build_row_witness(reviews: list, w: Witness):
    """-> (U-array of rendered strings, veto bool array) for one row
    witness over the review list. Built once per (witness, data
    revision) and fancy-indexed per firing pair thereafter."""
    n = len(reviews)
    strs: list = [""] * n
    veto = np.zeros(n, dtype=bool)
    if w.kind == "row":
        segs = w.segs
        for i, review in enumerate(reviews):
            v = _descend(review, segs)
            if isinstance(v, str) and len(v) <= MAX_WITNESS_STRLEN:
                strs[i] = v
            else:
                veto[i] = True
    else:  # rowset
        fmt = "%" + w.spec
        for i, review in enumerate(reviews):
            vals: list = []
            _collect_set(review, w.segs, 0, vals)
            try:
                s = bi_sprintf(fmt, (frozenset(freeze(v) for v in vals),))
            except (BuiltinError, TypeError):
                veto[i] = True
                continue
            if len(s) <= MAX_WITNESS_STRLEN:
                strs[i] = s
            else:
                veto[i] = True
    if n:
        arr = np.array(strs, dtype=str)
    else:
        arr = np.zeros(0, dtype="U1")
    return arr, veto


def render_param_witness(w: Witness, frozen_params) -> Optional[str]:
    """Per-constraint witness string, or None when the path is
    undefined (the msg binding then fails: the constraint column emits
    no violations at all)."""
    from ..utils.values import FrozenDict

    v = frozen_params
    for s in w.segs:
        if not isinstance(v, FrozenDict):
            return None
        if s not in v:
            return None
        v = v[s]
    try:
        return bi_sprintf("%" + w.spec, (v,))
    except BuiltinError:
        return None


def check_conditions(program: Program, conditions, cons: list) -> bool:
    """Evaluate the plan's runtime exactness conditions against the
    actual constraint set."""
    if not conditions:
        return True
    by_slot = {s.slot: s for s in program.param_slots}
    for kind, slot in conditions:
        if kind != "pval_scalar":
            return False
        spec = by_slot.get(slot)
        if spec is None:
            return False
        for c in cons:
            cspec = c.get("spec")
            cspec = cspec if isinstance(cspec, dict) else {}
            params = cspec.get("parameters") or {}
            nodes = [params]
            for seg in spec.segs:
                nxt = []
                for nd in nodes:
                    if seg.kind == "field":
                        if isinstance(nd, dict) and seg.name in nd:
                            nxt.append(nd[seg.name])
                    else:
                        if isinstance(nd, (list, tuple)):
                            nxt.extend(nd)
                        elif isinstance(nd, dict):
                            nxt.extend(nd.values())
                nodes = nxt
            if any(isinstance(v, (dict, list, tuple)) for v in nodes):
                return False
    return True
