"""Template compiler: Rego AST → vectorized Program.

Compiles the guard structure of each violation clause into the tensor IR
(ir/prog.py). Bindings that only feed the violation head (msg/details
construction — sprintf, get_message-style helpers) are NOT compiled: the
device program decides which (object, constraint) pairs fire, and the host
interpreter materializes exact messages for those pairs. The compiled
filter may over-fire (host re-check is authoritative) but must never
under-fire; anything outside the subset raises Uncompilable and the
template runs on the interpreter driver instead.

Supported subset (grown corpus-first, SURVEY.md §7 P0):
  * scalar guards over input.review.* / input.parameters.* paths
  * iteration over object lists/maps and parameter lists (up to 2 axes
    per slot), including `v := obj.labels[k]` map-entry iteration and
    path segments indexed by const-bound vars (`spec[field][_]`)
  * local partial-set rules (`input_containers`) and path-valued helper
    functions, flattened by ir/specialize.py before compilation
  * set comprehensions (multi-literal filter bodies over the generator
    element, non-var heads via binding introduction, object AND
    parameter key-sets, const-head existence sets), set
    difference/intersection, membership against constants or computed
    values, and count comparisons that reduce to emptiness tests
  * string predicates startswith/endswith/contains/re_match/glob with
    patterns from parameters or constants (match-table rows), including
    pattern transforms (trim) applied at encode time
  * pure unary helper functions (canonify_cpu/mem) and unary builtins
    (to_number/lower/upper/trim_space) as vocab-indexed derived
    columns, and binary string helpers (path_matches) as
    interpreter-backed match-table rows (ops/derived.py)
  * pure builtins over all-constant arguments folded at compile time
    (concat/sprintf/... — computed bracket keys reduce to static paths)
  * boolean/value helper functions inlined with constant-formal
    unification; `not` with locally-bound axes reduced inside the negation

Anything outside raises Uncompilable(code, detail) with a code from the
stable bounded REASON_CODES taxonomy; the driver records it, /debug/
templates and gatekeeper_tpu_compile_fallback_total{reason} surface it.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional, Union

from ..rego import ast as A
from .prog import (
    And,
    Arith,
    Axis,
    Clause,
    Cmp,
    Const,
    DerivedSpec,
    DerivedVal,
    Exists,
    Expr,
    Guard,
    K_ABSENT,
    K_ARR,
    K_STR,
    KindIs,
    MatchLookup,
    Not,
    Or,
    OrReduce,
    OVal,
    ObjSlotSpec,
    ParamSlotSpec,
    Program,
    PVal,
    Seg,
    SumReduce,
    Truthy,
)
from .specialize import specialize_module

_MATCH_OPS = {"startswith": "startswith", "endswith": "endswith",
              "contains": "contains", "re_match": "re_match"}
# pattern-side transforms applied at encode time (rego fn name -> tag)
_PATTERN_TRANSFORMS = {"trim": "trim", "lower": "lower", "upper": "upper",
                       "trim_prefix": "trim_prefix",
                       "trim_suffix": "trim_suffix"}
_CMP_OPS = {"==": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt",
            ">=": "ge"}
_ARITH_OPS = {"+": "add", "-": "sub", "*": "mul"}
# unary builtins lowered to vocab-indexed derived columns (ops/derived.py
# builtin_unary): evaluated once per interned vocab entry on the host,
# a single gather inside the [N, C] sweep
_BUILTIN_DERIVED = {"to_number", "lower", "upper", "trim_space"}
# pure builtins folded at compile time when every argument is constant
# (computed bracket keys like concat("/", ["apps", "v1"]) reduce to the
# static-field path the walker already handles)
_CONST_FOLDABLE = {"concat", "sprintf", "lower", "upper", "trim",
                   "trim_space", "trim_prefix", "trim_suffix", "replace",
                   "to_number", "format_int"}
_NOFOLD = object()
_MAX_INLINE_DEPTH = 8
_MAX_SLOT_AXES = 2


# Stable fallback-reason taxonomy. The metric
# `gatekeeper_tpu_compile_fallback_total{reason}` labels on these codes
# (bounded label set) and tests assert on codes, not prose — the detail
# string is free to change, the codes are an interface.
REASON_CODES = frozenset({
    # dense (elementwise) compiler
    "rule-shape",     # violation rule missing / not a partial set
    "axes",           # axis scoping: nesting depth, reduce-in-scope, keys
    "with-modifier",  # `with` is not vectorizable
    "binding",        # unsupported binding / destructure pattern
    "call",           # builtin or helper call outside the subset
    "unbound-var",    # reference to a var the compiler never bound
    "input-root",     # input.* path outside review/parameters
    "path",           # ref/bracket shape the path walker can't follow
    "set-op",         # set bracket/difference/intersection misuse
    "const",          # non-scalar constant
    "comprehension",  # comprehension form outside the subset
    "guard",          # guard/comparison expression outside the subset
    "count",          # count() misuse (incl. non-emptiness set counts)
    "pattern",        # match pattern not from parameters/constants
    "helper",         # helper function inlining failed
    "module-shape",   # template lib/entry module merge failed (driver)
    # inventory-join compiler
    "join-input",     # input reference outside input.review
    "join-generator", # inventory generator missing or malformed
    "join-with",      # `with` inside a join clause
    "join-identity",  # identity (not identical(...)) fn outside the shape
    "join-data",      # data read outside the inventory generator
    "join-mixed",     # mixed inv/rev literal that is not a join equality
    "join-shape",     # violation clause not recognizable as a join
    "internal",       # taxonomy drift guard — never raised deliberately
})


class Uncompilable(Exception):
    """A template (or clause) outside the device-compilable subset.

    `code` is one of REASON_CODES; `detail` carries the site-specific
    prose. str() renders "code: detail" — operators see both, metrics
    and tests key on the code alone."""

    def __init__(self, code: str, detail: str = ""):
        if code not in REASON_CODES:
            # taxonomy drift must not crash the compile path (the caller
            # treats Uncompilable as a routine fallback signal) — fold
            # the stray code into the detail under a stable label
            code, detail = "internal", f"{code}: {detail}" if detail else code
        self.code = code
        self.detail = detail
        super().__init__(f"{code}: {detail}" if detail else code)


# ---------------------------------------------------------------- symbolics


@dataclass(frozen=True)
class SPath:
    """A path into the review ("object"/"oldObject"/"review" roots) or the
    parameters document ("params" root). segs is a tuple of Seg."""

    root: str
    segs: tuple


@dataclass(frozen=True)
class SKey:
    """The key bound by a map-iteration bracket."""

    axis: str
    kind: str  # "obj" | "param"


@dataclass(frozen=True)
class SSet:
    """A set of scalars with optional element filter. source:
    "objkeys" | "objvals" | "paramvals" | "exists" (const-head compr whose
    elements don't matter, only non-emptiness). axes are the set-local
    iteration axes created during the comprehension walk; filter (over
    those axes) gates which elements belong."""

    source: str
    path: Optional[SPath]
    axes: tuple = ()
    filter: Optional[Expr] = None


@dataclass(frozen=True)
class SSetDiff:
    left: Union[SSet, "SSetDiff"]
    right: SSet


@dataclass(frozen=True)
class SSetInter:
    left: SSet
    right: SSet


@dataclass(frozen=True)
class SBoolList:
    """[b | <param iteration>; b = pred] — axes local to the comprehension."""

    axes: tuple
    expr: Expr


@dataclass(frozen=True)
class SSprintf:
    """sprintf("prefix%v", [arg]) held symbolically: device strings are
    interned ids, so the concatenation itself is not representable, but
    equality against it IS — strip the constant prefix from the other
    side via a derived column and compare the remainder (the apparmor
    annotation-key pattern, pod-security-policy/apparmor/src.rego)."""

    prefix: str
    arg: "Symbolic"


@dataclass(frozen=True)
class SConst:
    value: Any


@dataclass(frozen=True)
class SExpr:
    expr: Expr
    # set-derived counts may double-count duplicates; they are only valid in
    # comparisons that reduce to emptiness tests (see _check_zero_only)
    zero_only: bool = False


Symbolic = Union[SPath, SKey, SSet, SSetDiff, SSetInter, SBoolList, SConst,
                 SExpr]

# cell-producing device exprs (vs boolean / numeric-computed)
_CELL_EXPRS = (OVal, PVal, Const, DerivedVal)
_BOOL_EXPRS = (Cmp, MatchLookup, Truthy, Exists, And, Or, Not, OrReduce,
               KindIs)


class _Ctx:
    """Mutable compile state shared across a template's clauses."""

    def __init__(self, module: A.Module, kind: str):
        self.module = module
        self.kind = kind
        self.rules: dict[str, list[A.Rule]] = {}
        for r in module.rules:
            self.rules.setdefault(r.name, []).append(r)
        self.obj_slots: dict[tuple, ObjSlotRec] = {}
        self.param_slots: dict[tuple, ParamSlotRec] = {}
        self.axis_n = 0
        self.axes: dict[str, Axis] = {}
        self.derived: dict[tuple, int] = {}  # spec key -> col
        self.derived_specs: list[DerivedSpec] = []
        self.pred_ops: dict[str, str] = {}  # op name -> fn name

    def new_axis(self, kind: str) -> str:
        name = f"a{self.axis_n}"
        self.axis_n += 1
        return name

    def derived_col(self, kind: str, arg: str) -> int:
        key = (kind, arg)
        col = self.derived.get(key)
        if col is None:
            col = len(self.derived_specs)
            self.derived[key] = col
            self.derived_specs.append(DerivedSpec(col=col, kind=kind,
                                                  arg=arg))
        return col

    def rec_for_slot(self, slot: int):
        for rec in self.obj_slots.values():
            if rec.slot == slot:
                return rec
        for rec in self.param_slots.values():
            if rec.slot == slot:
                return rec
        return None


@dataclass
class ObjSlotRec:
    slot: int
    root: str
    segs: tuple
    mode: str


@dataclass
class ParamSlotRec:
    slot: int
    segs: tuple
    mode: str
    pattern_ops: set = field(default_factory=set)


def compile_template(module: A.Module, kind: str) -> Program:
    """Compile the (already rewritten) entry module of a template."""
    module = specialize_module(module)
    ctx = _Ctx(module, kind)
    vio = ctx.rules.get("violation")
    if not vio:
        raise Uncompilable("rule-shape", "no violation rule")
    clauses = []
    for rule in vio:
        clause = _compile_clause(ctx, rule)
        for g in clause.guards:
            _check_no_nested_axis(g.expr, set())
        clauses.append(clause)
    obj_slots = tuple(
        ObjSlotSpec(slot=r.slot, root=r.root, segs=r.segs, mode=r.mode)
        for r in sorted(ctx.obj_slots.values(), key=lambda r: r.slot)
    )
    param_slots = tuple(
        ParamSlotSpec(slot=r.slot, segs=r.segs, mode=r.mode,
                      pattern_ops=tuple(sorted(r.pattern_ops)))
        for r in sorted(ctx.param_slots.values(), key=lambda r: r.slot)
    )
    return Program(kind=kind, obj_slots=obj_slots, param_slots=param_slots,
                   clauses=tuple(clauses),
                   axes=tuple(ctx.axes.values()),
                   derived=tuple(ctx.derived_specs),
                   pred_ops=tuple(sorted(ctx.pred_ops.items())))


def _check_no_nested_axis(e: Expr, active: set) -> None:
    """An axis reduced inside its own reduction scope would silently
    collapse to a size-1 reduce — reject (sibling reuse is fine)."""
    if isinstance(e, (OrReduce, SumReduce)):
        if e.axis in active:
            raise Uncompilable("axes", f"axis {e.axis} reduced within its own scope")
        _check_no_nested_axis(e.e, active | {e.axis})
    elif isinstance(e, (And, Or)):
        for x in e.items:
            _check_no_nested_axis(x, active)
    elif isinstance(e, Not):
        _check_no_nested_axis(e.e, active | set(e.local_axes))
    elif isinstance(e, Cmp):
        _check_no_nested_axis(e.lhs, active)
        _check_no_nested_axis(e.rhs, active)
    elif isinstance(e, MatchLookup):
        _check_no_nested_axis(e.row, active)
        _check_no_nested_axis(e.sid, active)
    elif isinstance(e, (Truthy, Exists, KindIs)):
        _check_no_nested_axis(e.e, active)
    elif isinstance(e, DerivedVal):
        _check_no_nested_axis(e.base, active)
    elif isinstance(e, Arith):
        _check_no_nested_axis(e.lhs, active)
        _check_no_nested_axis(e.rhs, active)


# ------------------------------------------------------------------ clauses


def _collect_vars(t, out: set) -> None:
    if isinstance(t, A.Var):
        out.add(t.name)
    elif isinstance(t, A.Ref):
        _collect_vars(t.base, out)
        for a in t.args:
            _collect_vars(a, out)
    elif isinstance(t, A.Call):
        for a in t.args:
            _collect_vars(a, out)
    elif isinstance(t, A.BinOp):
        _collect_vars(t.lhs, out)
        _collect_vars(t.rhs, out)
    elif isinstance(t, A.UnaryMinus):
        _collect_vars(t.term, out)
    elif isinstance(t, A.ArrayLit) or isinstance(t, A.SetLit):
        for x in t.items:
            _collect_vars(x, out)
    elif isinstance(t, A.ObjectLit):
        for k, v in t.items:
            _collect_vars(k, out)
            _collect_vars(v, out)
    elif isinstance(t, (A.ArrayCompr, A.SetCompr)):
        _collect_vars(t.head, out)
        for l in t.body:
            _collect_vars(l.expr, out)
    elif isinstance(t, A.ObjectCompr):
        _collect_vars(t.key, out)
        _collect_vars(t.value, out)
        for l in t.body:
            _collect_vars(l.expr, out)
    elif isinstance(t, (A.Assign, A.Unify)):
        _collect_vars(t.lhs, out)
        _collect_vars(t.rhs, out)


def _needed_vars(rule: A.Rule) -> set:
    """Vars needed by guard literals (directly or through needed bindings).
    Head-only bindings are skipped — the host re-derives them."""
    binds: list[tuple[str, set]] = []  # (bound var, refs)
    guard_refs: set = set()
    for lit in rule.body:
        e = lit.expr
        if isinstance(e, (A.Assign, A.Unify)) and isinstance(e.lhs, A.Var):
            refs: set = set()
            _collect_vars(e.rhs, refs)
            binds.append((e.lhs.name, refs))
        elif isinstance(e, A.SomeDecl):
            continue
        else:
            _collect_vars(e, guard_refs)
    needed = set(guard_refs)
    changed = True
    while changed:
        changed = False
        for var, refs in binds:
            if var in needed and not refs <= needed:
                needed |= refs
                changed = True
    return needed


def _compile_clause(ctx: _Ctx, rule: A.Rule) -> Clause:
    if rule.kind != "partial_set":
        raise Uncompilable("rule-shape", "violation must be a partial-set rule")
    comp = _ClauseCompiler(ctx, _needed_vars(rule))
    for lit in rule.body:
        comp.literal(lit)
    return Clause(axes=tuple(comp.clause_axes), guards=tuple(comp.guards))


class _ClauseCompiler:
    def __init__(self, ctx: _Ctx, needed: set, env: Optional[dict] = None,
                 depth: int = 0):
        self.ctx = ctx
        self.needed = needed
        self.env: dict[str, Symbolic] = env if env is not None else {}
        self.clause_axes: list[Axis] = []
        self.guards: list[Guard] = []
        self.depth = depth
        # (axes, filter) scopes opened by in-guard set iteration; consumed
        # by the enclosing literal (existential wrap)
        self.pending_scopes: list[tuple[tuple, Optional[Expr]]] = []

    # -------------------------------------------------------------- literals

    def literal(self, lit: A.Literal) -> None:
        if lit.withs:
            raise Uncompilable("with-modifier", "with modifiers are not vectorizable")
        e = lit.expr
        if isinstance(e, A.SomeDecl):
            return
        if not lit.negated and isinstance(e, (A.Assign, A.Unify)) and \
                isinstance(e.lhs, A.Var):
            name = e.lhs.name
            if name not in self.needed and not name.startswith("$wc"):
                return  # head-only binding: host materializes
            self.env[name] = self.bind_rhs(e.rhs)
            if self.pending_scopes:
                raise Uncompilable("binding", "set iteration in binding position")
            return
        if not lit.negated and isinstance(e, (A.Assign, A.Unify)) and \
                isinstance(e.lhs, A.ArrayLit) and isinstance(e.rhs, A.Call) \
                and tuple(e.rhs.fn) == ("split",):
            self.split_destructure(e.lhs, e.rhs)
            return
        if not lit.negated and isinstance(e, (A.Assign, A.Unify)):
            raise Uncompilable("binding", f"unsupported binding pattern {e!r}")
        # guard literal
        new_axes_start = len(self.clause_axes)
        expr = self.bool_expr(e)
        expr = self._wrap_pending(expr)
        if lit.negated:
            local = tuple(a.name for a in self.clause_axes[new_axes_start:])
            del self.clause_axes[new_axes_start:]
            self.guards.append(Guard(expr=Not(expr, local_axes=local)))
        else:
            self.guards.append(Guard(expr=expr))

    def _wrap_pending(self, expr: Expr) -> Expr:
        """Existentially close set-iteration scopes opened inside a guard."""
        while self.pending_scopes:
            axes, filt = self.pending_scopes.pop()
            if filt is not None:
                expr = And((filt, expr))
            for ax in reversed(axes):
                expr = OrReduce(ax, expr)
        return expr

    def split_destructure(self, lhs: A.ArrayLit, call: A.Call) -> None:
        """[a, b] := split(x, "/") — parts as derived columns; the clause
        is undefined unless the split yields exactly len(lhs) parts."""
        if len(call.args) != 2 or not isinstance(call.args[1], A.Scalar) \
                or not isinstance(call.args[1].value, str):
            raise Uncompilable("binding", "split destructure needs a constant separator")
        sep = call.args[1].value
        base = self.value_expr(self.to_symbolic(call.args[0]))
        k = len(lhs.items)
        col0 = None
        for i, v in enumerate(lhs.items):
            if not isinstance(v, A.Var):
                raise Uncompilable("binding", "split destructure into non-vars")
            col = self.ctx.derived_col("split", f"{sep}|{i}|{k}")
            if i == 0:
                col0 = col
            if v.name in self.needed and not v.name.startswith("$wc"):
                self.env[v.name] = SExpr(DerivedVal(col, base))
        # arity guard: part 0 is defined iff the split has exactly k parts
        self.guards.append(Guard(expr=Exists(DerivedVal(col0, base))))

    # -------------------------------------------------------------- bindings

    def bind_rhs(self, t) -> Symbolic:
        if isinstance(t, A.Scalar):
            return SConst(t.value)
        if isinstance(t, A.ArrayLit) and not t.items:
            return SConst(())
        if isinstance(t, A.Ref) or isinstance(t, A.Var):
            return self.resolve_ref(t)
        if isinstance(t, A.SetCompr):
            return self.set_compr(t)
        if isinstance(t, A.ArrayCompr):
            return self.bool_list_compr(t)
        if isinstance(t, A.BinOp):
            if t.op in _CMP_OPS:
                return SExpr(self.cmp_expr(t))
            l = self.to_symbolic(t.lhs)
            r = self.to_symbolic(t.rhs)
            if t.op == "-" and isinstance(l, (SSet, SSetDiff)) and \
                    isinstance(r, SSet):
                return SSetDiff(l, r)
            if t.op == "&" and isinstance(l, SSet) and isinstance(r, SSet):
                return SSetInter(l, r)
            if t.op in _ARITH_OPS:
                return SExpr(Arith(_ARITH_OPS[t.op], self.num_expr(l),
                                   self.num_expr(r)))
            raise Uncompilable("binding", f"unsupported binary op {t.op} in binding")
        if isinstance(t, A.Call):
            if tuple(t.fn) == ("count",):
                return self.count_symbolic(t.args[0])
            return self.call_value(t)
        raise Uncompilable("binding", f"unsupported binding rhs {type(t).__name__}")

    def _const_term(self, a) -> Any:
        """The constant value of a term, or _NOFOLD."""
        if isinstance(a, A.Scalar):
            return a.value
        if isinstance(a, A.ArrayLit):
            items = [self._const_term(x) for x in a.items]
            return _NOFOLD if any(x is _NOFOLD for x in items) \
                else tuple(items)
        if isinstance(a, A.Var):
            bound = self.env.get(a.name)
            if isinstance(bound, SConst) and not isinstance(
                    bound.value, tuple):
                return bound.value
        return _NOFOLD

    def _const_fold(self, t: A.Call) -> Optional[SConst]:
        """Evaluate a pure builtin over all-constant arguments at compile
        time (via the exact host builtin, so folding can never diverge
        from the interpreter)."""
        fn = tuple(t.fn)
        if len(fn) != 1 or fn[0] not in _CONST_FOLDABLE:
            return None
        vals = [self._const_term(a) for a in t.args]
        if any(v is _NOFOLD for v in vals):
            return None
        from ..rego.builtins import BUILTINS

        b = BUILTINS.get(fn)
        if b is None:
            return None
        try:
            r = b(*vals)
        except Exception:
            return None  # undefined at compile time: normal paths decide
        if isinstance(r, (str, int, float, bool)):
            return SConst(r)
        return None

    def call_value(self, t: A.Call) -> Symbolic:
        """A call in value (binding) position."""
        folded = self._const_fold(t)
        if folded is not None:
            return folded
        fn = tuple(t.fn)
        if fn == ("sprintf",) and len(t.args) == 2 and \
                isinstance(t.args[0], A.Scalar) and \
                isinstance(t.args[0].value, str) and \
                isinstance(t.args[1], A.ArrayLit) and \
                len(t.args[1].items) == 1:
            fmt = t.args[0].value
            if fmt.endswith("%v") and fmt.count("%") == 1:
                return SSprintf(fmt[:-2],
                                self.to_symbolic(t.args[1].items[0]))
        if len(fn) == 1 and fn[0] in _BUILTIN_DERIVED and len(t.args) == 1:
            base = self.value_expr(self.to_symbolic(t.args[0]))
            if isinstance(base, _CELL_EXPRS):
                col = self.ctx.derived_col("builtin", fn[0])
                return SExpr(DerivedVal(col, base))
            raise Uncompilable("call", f"{fn[0]} over non-cell value")
        if len(fn) == 1 and fn[0] in self.ctx.rules:
            sym = self._unary_derived(fn[0], t.args)
            if sym is not None:
                return sym
        return SExpr(self.call_expr(t))

    # ------------------------------------------------------------------ refs

    def resolve_ref(self, t) -> Symbolic:
        """Resolve a Var/Ref term to a symbolic path/element."""
        if isinstance(t, A.Var):
            if t.name == "input":
                raise Uncompilable("input-root", "bare input reference")
            if t.name in self.env:
                return self.env[t.name]
            raise Uncompilable("unbound-var", f"unbound var {t.name}")
        if not isinstance(t, A.Ref):
            raise Uncompilable("path", f"not a ref: {type(t).__name__}")
        if isinstance(t.base, A.Var) and t.base.name == "input":
            sym = None
            args = t.args
            if not args or not isinstance(args[0], A.Scalar):
                raise Uncompilable("input-root", "dynamic input root")
            root0 = args[0].value
            if root0 == "review":
                if len(args) > 1 and isinstance(args[1], A.Scalar) and \
                        args[1].value in ("object", "oldObject"):
                    sym = SPath(root=args[1].value, segs=())
                    rest = args[2:]
                else:
                    sym = SPath(root="review", segs=())
                    rest = args[1:]
            elif root0 == "parameters":
                sym = SPath(root="params", segs=())
                rest = args[1:]
            else:
                raise Uncompilable("input-root", f"unsupported input root {root0!r}")
        else:
            sym = self.resolve_ref(t.base) if isinstance(t.base, A.Ref) else \
                self.resolve_var_base(t.base)
            rest = t.args
        return self.walk_segments(sym, rest)

    def resolve_var_base(self, base) -> Symbolic:
        if isinstance(base, A.Var):
            if base.name in self.env:
                return self.env[base.name]
            raise Uncompilable("unbound-var", f"unbound base var {base.name}")
        raise Uncompilable("path", f"unsupported ref base {type(base).__name__}")

    def walk_segments(self, sym: Symbolic, args: tuple) -> Symbolic:
        for ai, arg in enumerate(args):
            if isinstance(sym, SSet):
                return self.set_bracket(sym, arg, args[ai + 1:])
            if not isinstance(sym, SPath):
                raise Uncompilable("path", "cannot descend into non-path symbolic")
            if isinstance(arg, A.Scalar):
                if not isinstance(arg.value, str):
                    raise Uncompilable("path", "non-string static bracket")
                sym = replace(sym, segs=sym.segs + (Seg("field", name=arg.value),))
            elif isinstance(arg, A.Var):
                name = arg.name
                if name in self.env:
                    bound = self.env[name]
                    if isinstance(bound, SConst) and \
                            isinstance(bound.value, str):
                        # const-bound var: spec[field][_] with field from
                        # an object-head expansion or helper formal
                        sym = replace(sym, segs=sym.segs +
                                      (Seg("field", name=bound.value),))
                        continue
                    if isinstance(bound, SKey):
                        # re-indexing the SAME collection by the same key
                        # var (ranges[j].min … ranges[j].max) aliases the
                        # existing axis; correlated indexing across
                        # different collections is not vectorizable
                        ax = self.ctx.axes.get(bound.axis)
                        owner = self.ctx.rec_for_slot(ax.slot) if ax else None
                        here = sym.segs + (Seg("iter", axis=bound.axis),)
                        same_root = owner is not None and (
                            getattr(owner, "root", "params") ==
                            ("params" if sym.root == "params" else sym.root))
                        if same_root and tuple(owner.segs) == here:
                            sym = replace(sym, segs=here)
                            continue
                        # different collection: desugar to a fresh axis
                        # with a key(new) == key(bound) guard — the joint
                        # ∃-reduction is exactly the correlated lookup
                        sym = self._computed_key_bracket(sym, bound)
                        continue
                    # var bound to a scalar value: coll[k] with k computed
                    # elsewhere — desugar like any computed key
                    sym = self._computed_key_bracket(sym, bound)
                    continue
                # fresh var or wildcard -> iteration axis
                axis = self.ctx.new_axis("obj")
                is_param = sym.root == "params"
                kind = "param" if is_param else "obj"
                sym = replace(sym, segs=sym.segs + (Seg("iter", axis=axis),))
                self._register_axis(axis, kind, sym)
                if not name.startswith("$wc"):
                    self.env[name] = SKey(axis=axis, kind=kind)
            elif isinstance(arg, (A.Ref, A.Call)):
                # coll[<computed key>] (labels[spec.key], ...): desugar to
                # iteration over the collection plus a key == value guard
                sym = self._computed_key_bracket(sym, self.to_symbolic(arg))
            else:
                raise Uncompilable("path", "composite bracket pattern")
        return sym

    def _computed_key_bracket(self, sym: SPath, key_sym) -> SPath:
        """m[<computed>] -> iterate m's entries on a fresh axis, guarded by
        key(axis) == <computed>. The ∃-reduction over the axis then yields
        exactly the map-lookup semantics (absent key -> no binding)."""
        if isinstance(key_sym, SSprintf):
            # m[sprintf("prefix%v", [x])]: guard on
            # strip_prefix(key(axis)) == x. Exact iff when x is a string
            # (strip_prefix is UNDEF for non-prefixed keys); a numeric x
            # would render as its decimal string, which the sid equality
            # cannot see — those rows OVER-fire instead (host re-check
            # is authoritative), never under-fire
            arg_expr = self.value_expr(key_sym.arg)
            if not isinstance(arg_expr, _CELL_EXPRS):
                raise Uncompilable("call", "unsupported sprintf key argument")
            col = self.ctx.derived_col("strip_prefix", key_sym.prefix)
            axis = self.ctx.new_axis("obj")
            kind = "param" if sym.root == "params" else "obj"
            out = replace(sym, segs=sym.segs + (Seg("iter", axis=axis),))
            self._register_axis(axis, kind, out)
            key_of_axis = self.value_expr(SKey(axis=axis, kind=kind))
            self.guards.append(Guard(expr=Or((
                Cmp("eq", DerivedVal(col, key_of_axis), arg_expr,
                    dtype="auto"),
                Not(KindIs(arg_expr, (K_ABSENT, K_STR)), ()),
            ))))
            return out
        key_expr = self.value_expr(key_sym)
        if not isinstance(key_expr, _CELL_EXPRS):
            raise Uncompilable("path", "unsupported computed bracket key")
        axis = self.ctx.new_axis("obj")
        kind = "param" if sym.root == "params" else "obj"
        out = replace(sym, segs=sym.segs + (Seg("iter", axis=axis),))
        self._register_axis(axis, kind, out)
        key_of_axis = self.value_expr(SKey(axis=axis, kind=kind))
        self.guards.append(Guard(expr=Cmp("eq", key_of_axis, key_expr,
                                          dtype="auto")))
        return out

    def set_bracket(self, s: SSet, arg, rest: tuple) -> Symbolic:
        """boundset[x]: membership test (const) or element iteration
        (fresh var / wildcard)."""
        if rest:
            raise Uncompilable("set-op", "descending into set elements")
        if s.source == "exists":
            raise Uncompilable("set-op", "bracket on existence-only set")
        if isinstance(arg, A.Scalar):
            elem = self._set_elem_expr(s)
            test = Cmp("eq", elem, self._const_expr(arg.value), dtype="auto")
            if s.filter is not None:
                test = And((s.filter, test))
            for ax in reversed(s.axes):
                test = OrReduce(ax, test)
            return SExpr(test)
        if isinstance(arg, A.Var) and (arg.name.startswith("$wc")
                                       or arg.name not in self.env):
            # iteration: open an existential scope closed by the literal
            elem = self._set_elem_expr(s)
            self.pending_scopes.append((s.axes, s.filter))
            if not arg.name.startswith("$wc"):
                self.env[arg.name] = SExpr(elem)
            return SExpr(elem)
        if isinstance(arg, (A.Ref, A.Call, A.Var)):
            # membership test against a computed value:
            # boundset[input.review.object.metadata.name]
            val = self.value_expr(self.to_symbolic(arg))
            if isinstance(val, _CELL_EXPRS):
                elem = self._set_elem_expr(s)
                test = Cmp("eq", elem, val, dtype="auto")
                if s.filter is not None:
                    test = And((s.filter, test))
                for ax in reversed(s.axes):
                    test = OrReduce(ax, test)
                return SExpr(test)
        raise Uncompilable("set-op", "unsupported set bracket")

    def _const_expr(self, v) -> Expr:
        if isinstance(v, bool):
            return Const("bool", v)
        if isinstance(v, (int, float)):
            return Const("num", float(v))
        if isinstance(v, str):
            return Const("str", v)
        raise Uncompilable("const", f"unsupported constant {v!r}")

    def _register_axis(self, axis: str, kind: str, sym: SPath) -> None:
        """Axis presence is owned by the slot of the iterated collection."""
        if kind == "obj":
            rec = self._obj_slot(sym, mode="entries")
        else:
            rec = self._param_slot(sym, mode="list")
        ax = Axis(name=axis, kind=kind, slot=rec.slot)
        self.ctx.axes[axis] = ax
        self.clause_axes.append(ax)

    # ----------------------------------------------------------------- slots

    def _obj_slot(self, sym: SPath, mode: str) -> ObjSlotRec:
        n_axes = sum(1 for s in sym.segs if s.kind == "iter")
        if n_axes > _MAX_SLOT_AXES:
            raise Uncompilable("axes", "too many iteration axes in one path")
        key = (sym.root, sym.segs, mode)
        rec = self.ctx.obj_slots.get(key)
        if rec is None:
            rec = ObjSlotRec(slot=len(self.ctx.obj_slots) +
                             len(self.ctx.param_slots),
                             root=sym.root, segs=sym.segs, mode=mode)
            self.ctx.obj_slots[key] = rec
        return rec

    def _param_slot(self, sym: SPath, mode: str) -> ParamSlotRec:
        key = (sym.segs, mode)
        rec = self.ctx.param_slots.get(key)
        if rec is None:
            rec = ParamSlotRec(slot=len(self.ctx.obj_slots) +
                               len(self.ctx.param_slots),
                               segs=sym.segs, mode=mode)
            self.ctx.param_slots[key] = rec
        return rec

    # -------------------------------------------------------- comprehensions

    def set_compr(self, t: A.SetCompr) -> SSet:
        """{head | generator; ...filters...}. Forms:
          {x | x := path[_]}        — value set
          {x.f | x := path[_]}      — value set with a non-var head (the
                                      head path extends the generator's)
          {k | path[k]}             — key set, over OBJECT or PARAMETER
                                      maps
          {x | x = path[_][k]; ...} — nested value set
          {1 | guards}              — existence set (const head)
        Body literals may bind intermediate vars (the bindings land in
        the comprehension-local env, so multi-literal filter bodies can
        reference the generator element); remaining literals become the
        element filter."""
        sub = _ClauseCompiler(self.ctx, self.needed | _body_vars(t.body),
                              env=dict(self.env), depth=self.depth)
        head = t.head
        head_name = head.name if isinstance(head, A.Var) else None
        head_vars: set = set()
        _collect_vars(head, head_vars)
        sub.needed = sub.needed | head_vars
        # a head var already bound in the enclosing scope can never be a
        # key-iteration binder here (it would unify, not generate)
        head_preknown = head_name is not None and head_name in sub.env
        start_axes = len(sub.clause_axes)
        key_gen: Optional[tuple] = None  # (SKey binder, iterated SPath)
        filters: list[Expr] = []
        for lit in t.body:
            e = lit.expr
            if isinstance(e, A.SomeDecl):
                continue
            if not lit.negated and isinstance(e, (A.Assign, A.Unify)) and \
                    isinstance(e.lhs, A.Var) and e.lhs.name not in sub.env:
                # fresh-var binding; a unify against an ALREADY-bound var
                # falls through to the filter path as an equality (a
                # rebind would widen the set — an under-fire risk)
                sub.env[e.lhs.name] = sub.bind_rhs(e.rhs)
                if sub.pending_scopes:
                    raise Uncompilable("binding",
                                       "set iteration in binding position")
                continue
            if not lit.negated and isinstance(e, A.Ref) and \
                    key_gen is None and not head_preknown:
                # possible key-iteration generator: path[k] binding the
                # head var as a fresh map key
                sym = sub.resolve_ref(e)
                bound = sub.env.get(head_name) if head_name else None
                if isinstance(bound, SKey) and isinstance(sym, SPath):
                    key_gen = (bound, sym)
                    continue
                # plain ref guard: reuse the resolved symbolic (resolving
                # again via bool_expr would mint duplicate axes)
                if isinstance(sym, SExpr) and isinstance(sym.expr,
                                                         _BOOL_EXPRS):
                    expr = sym.expr
                else:
                    expr = Truthy(sub.value_expr(sym))
                filters.append(sub._wrap_pending(expr))
                continue
            # filter literal
            ax_mark = len(sub.clause_axes)
            expr = sub.bool_expr(e)
            expr = sub._wrap_pending(expr)
            if lit.negated:
                local = tuple(a.name for a in sub.clause_axes[ax_mark:])
                del sub.clause_axes[ax_mark:]
                expr = Not(expr, local_axes=local)
            filters.append(expr)
        axes = tuple(a.name for a in sub.clause_axes[start_axes:])
        filt = And(tuple(filters)) if len(filters) > 1 else (
            filters[0] if filters else None)
        if key_gen is not None:
            binder, sym = key_gen
            source = "paramkeys" if binder.kind == "param" else "objkeys"
            return SSet(source=source, path=sym, axes=axes, filter=filt)
        # value set: the head term resolved against the comprehension env
        # (a bound var, or a non-var head like c.image extending the
        # generator element's path)
        if head_name is not None or isinstance(head, (A.Ref, A.Call)):
            sym = sub.env.get(head_name) if head_name is not None else None
            if sym is None:
                try:
                    sym = sub.to_symbolic(head)
                except Uncompilable as e:
                    raise Uncompilable(
                        "comprehension",
                        f"unsupported comprehension head ({e.detail or e.code})")
            if isinstance(sym, SPath) and any(
                    s.kind == "iter" for s in sym.segs):
                source = "paramvals" if sym.root == "params" else "objvals"
                return SSet(source=source, path=sym, axes=axes, filter=filt)
            if isinstance(sym, SKey):
                # head is a key var bound through a v := m[k] literal
                ax = self.ctx.axes[sym.axis]
                rec = self.ctx.rec_for_slot(ax.slot)
                if rec is not None:
                    path = SPath(root=getattr(rec, "root", "params"),
                                 segs=tuple(rec.segs))
                    source = ("paramkeys" if sym.kind == "param"
                              else "objkeys")
                    return SSet(source=source, path=path, axes=axes,
                                filter=filt)
            raise Uncompilable("comprehension",
                               "comprehension generator must iterate")
        if isinstance(head, A.Scalar):
            # existence set: {1 | guards}
            return SSet(source="exists", path=None, axes=axes,
                        filter=filt)
        raise Uncompilable("comprehension",
                           "unrecognized set comprehension form")

    def bool_list_compr(self, t: A.ArrayCompr) -> SBoolList:
        """[b | x = params.list[_]; ...guards...; b = pred(x)]"""
        if not isinstance(t.head, A.Var):
            raise Uncompilable("comprehension", "array comprehension head must be a var")
        head = t.head.name
        sub = _ClauseCompiler(self.ctx, self.needed | {head} | _body_vars(t.body),
                              env=dict(self.env), depth=self.depth)
        start_axes = len(sub.clause_axes)
        pred: Optional[Expr] = None
        for lit in t.body:
            e = lit.expr
            if not lit.negated and isinstance(e, (A.Assign, A.Unify)) and \
                    isinstance(e.lhs, A.Var) and e.lhs.name == head:
                pred = sub.bool_expr(e.rhs)
                pred = sub._wrap_pending(pred)
            else:
                sub.literal(lit)
        if pred is None:
            raise Uncompilable("comprehension", "array comprehension without boolean head binding")
        axes = tuple(a.name for a in sub.clause_axes[start_axes:])
        guards = [g.expr if not g.negated else Not(g.expr)
                  for g in sub.guards]
        expr = And(tuple(guards + [pred])) if guards else pred
        return SBoolList(axes=axes, expr=expr)

    # ----------------------------------------------------------- guard exprs

    def bool_expr(self, e) -> Expr:
        if isinstance(e, A.BinOp):
            return self.cmp_expr(e)
        if isinstance(e, A.Call):
            return self.call_expr(e)
        if isinstance(e, (A.Ref, A.Var)):
            sym = self.to_symbolic(e)
            if isinstance(sym, SExpr) and isinstance(sym.expr, _BOOL_EXPRS):
                return sym.expr
            return Truthy(self.value_expr(sym))
        if isinstance(e, A.Scalar):
            # any scalar except `false` succeeds as a body literal (null too)
            return Const("bool", e.value is not False)
        if isinstance(e, (A.Assign, A.Unify)):
            # expression-position unification under `not`; only equality of
            # two compilable values is supported
            lhs = self.to_symbolic(e.lhs)
            rhs = self.to_symbolic(e.rhs)
            _check_zero_only(lhs, rhs, "eq")
            return self.eq_expr(lhs, rhs)
        raise Uncompilable("guard", f"unsupported guard {type(e).__name__}")

    def to_symbolic(self, t) -> Symbolic:
        if isinstance(t, A.Var) and t.name in self.env:
            return self.env[t.name]
        if isinstance(t, A.Call):
            if tuple(t.fn) == ("count",):
                return self.count_symbolic(t.args[0])
            return self.call_value(t)
        return self.bind_rhs(t)

    def cmp_expr(self, e: A.BinOp) -> Expr:
        if e.op not in _CMP_OPS:
            raise Uncompilable("guard", f"unsupported operator {e.op}")
        op = _CMP_OPS[e.op]
        # X == sprintf("prefix%v", [t]) — equality against a prefixed
        # string (apparmor annotation keys): strip the prefix via a derived
        # column and compare the remainder
        if op in ("eq", "ne"):
            for a, b in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
                desugar = self._sprintf_eq(a, b, op)
                if desugar is not None:
                    return desugar
        lhs = self.term_for_cmp(e.lhs)
        rhs = self.term_for_cmp(e.rhs)
        _check_zero_only(lhs, rhs, op)
        if op in ("eq", "ne"):
            # `a != b` is undefined (not true) when a side is undefined, so
            # it is its own comparison op rather than Not(eq)
            return self.eq_expr(lhs, rhs, op)
        lexpr = self.num_expr(lhs)
        rexpr = self.num_expr(rhs)
        return Cmp(op, lexpr, rexpr, dtype="num")

    def _sprintf_eq(self, value_t, call_t, op: str) -> Optional[Expr]:
        if not (isinstance(call_t, A.Call)
                and tuple(call_t.fn) == ("sprintf",)
                and len(call_t.args) == 2
                and isinstance(call_t.args[0], A.Scalar)
                and isinstance(call_t.args[0].value, str)
                and isinstance(call_t.args[1], A.ArrayLit)
                and len(call_t.args[1].items) == 1):
            return None
        fmt = call_t.args[0].value
        if not fmt.endswith("%v") or fmt.count("%") != 1:
            return None
        if op != "eq":
            raise Uncompilable("guard", "sprintf equality only supports ==")
        prefix = fmt[:-2]
        col = self.ctx.derived_col("strip_prefix", prefix)
        base = self.value_expr(self.to_symbolic(value_t))
        arg = self.value_expr(self.to_symbolic(call_t.args[1].items[0]))
        return Cmp("eq", DerivedVal(col, base), arg, dtype="auto")

    def term_for_cmp(self, t) -> Symbolic:
        if isinstance(t, A.Call) and tuple(t.fn) == ("count",):
            return self.count_symbolic(t.args[0])
        return self.to_symbolic(t)

    def count_symbolic(self, arg) -> SExpr:
        sym = self.to_symbolic(arg)
        zero_only = isinstance(sym, (SSet, SSetDiff, SSetInter))
        return SExpr(self.count_of(sym), zero_only=zero_only)

    def eq_expr(self, lhs: Symbolic, rhs: Symbolic, op: str = "eq") -> Expr:
        for a, b in ((lhs, rhs), (rhs, lhs)):
            if isinstance(a, SSprintf):
                if op != "eq":
                    raise Uncompilable("guard", "sprintf equality only supports ==")
                col = self.ctx.derived_col("strip_prefix", a.prefix)
                other = self.value_expr(b)
                arg = self.value_expr(a.arg)
                # non-string args render to strings the sid equality
                # cannot see: over-fire those rows (host re-check)
                return Or((
                    Cmp("eq", DerivedVal(col, other), arg, dtype="auto"),
                    Not(KindIs(arg, (K_ABSENT, K_STR)), ()),
                ))
        # equality against the empty array: kind test + zero count
        for a, b in ((lhs, rhs), (rhs, lhs)):
            if isinstance(a, SConst) and a.value == ():
                if op != "eq":
                    raise Uncompilable("guard", "!= [] is not supported")
                if not isinstance(b, SPath):
                    raise Uncompilable("guard", "[] comparison needs a path")
                return And((KindIs(self.value_expr(b), (K_ARR,)),
                            Cmp("eq", self.count_of(b), Const("num", 0.0),
                                dtype="num")))
        l_num = isinstance(lhs, SExpr) and not isinstance(lhs.expr,
                                                          _CELL_EXPRS)
        r_num = isinstance(rhs, SExpr) and not isinstance(rhs.expr,
                                                          _CELL_EXPRS)
        if l_num or r_num:
            l = self.num_expr(lhs)
            r = self.num_expr(rhs)
            return Cmp(op, l, r, dtype="num")
        return Cmp(op, self.value_expr(lhs), self.value_expr(rhs),
                   dtype="auto")

    def num_expr(self, sym: Symbolic) -> Expr:
        if isinstance(sym, SExpr):
            return sym.expr
        if isinstance(sym, SConst):
            if isinstance(sym.value, bool) or not isinstance(sym.value, (int, float)):
                raise Uncompilable("guard", "numeric comparison with non-number")
            return Const("num", float(sym.value))
        return self.value_expr(sym)

    def value_expr(self, sym: Symbolic) -> Expr:
        """Leaf device expr for a scalar symbolic value."""
        if isinstance(sym, SConst):
            return self._const_expr(sym.value)
        if isinstance(sym, SKey):
            ax = self.ctx.axes[sym.axis]
            self._check_key_innermost(sym, ax)
            if sym.kind == "param":
                return PVal(ax.slot, f="key", axis=sym.axis)
            return OVal(ax.slot, f="key", axis=sym.axis)
        if isinstance(sym, SExpr):
            return sym.expr
        if isinstance(sym, SPath):
            axes = [s.axis for s in sym.segs if s.kind == "iter"]
            axis = axes[-1] if axes else None
            if sym.root == "params":
                mode = "list" if axes else "scalar"
                rec = self._param_slot(sym, mode=mode)
                return PVal(rec.slot, f="val", axis=axis)
            mode = "entries" if axes else "scalar"
            rec = self._obj_slot(sym, mode=mode)
            return OVal(rec.slot, f="val", axis=axis)
        raise Uncompilable("guard", f"cannot make a scalar of {type(sym).__name__}")

    def _check_key_innermost(self, sym: SKey, ax: Axis) -> None:
        """Extraction records keys for a slot's innermost axis only."""
        rec = self.ctx.rec_for_slot(ax.slot)
        if rec is None:
            return
        iters = [s.axis for s in rec.segs if s.kind == "iter"]
        if iters and iters[-1] != sym.axis:
            raise Uncompilable("axes", "key binding on a non-innermost axis")

    # ----------------------------------------------------------------- calls

    def call_expr(self, e: A.Call) -> Expr:
        fn = tuple(e.fn)
        if fn == ("any",):
            sym = self.to_symbolic(e.args[0])
            if isinstance(sym, SBoolList):
                out = sym.expr
                for ax in reversed(sym.axes):
                    out = OrReduce(ax, out)
                return out
            raise Uncompilable("call", "any() over non-comprehension")
        if fn == ("count",):
            raise Uncompilable("count", "bare count() guard")
        if len(fn) == 1 and fn[0] in _MATCH_OPS:
            return self.match_call(_MATCH_OPS[fn[0]], e.args)
        if fn == ("glob", "match"):
            # glob.match(pattern, delimiters, value)
            if len(e.args) != 3:
                raise Uncompilable("call", "glob.match arity")
            return self.match_call("glob", (e.args[0], e.args[2]))
        if len(fn) == 1 and fn[0] in self.ctx.rules:
            try:
                return self.inline_helper(fn[0], e.args)
            except Uncompilable:
                alt = self._fn_fallback(fn[0], e.args)
                if alt is not None:
                    return alt
                raise
        raise Uncompilable("call", f"unsupported call {'.'.join(fn)}")

    def _fn_fallback(self, name: str, args: tuple) -> Optional[Expr]:
        """Helper calls the inliner can't vectorize: unary fns become
        vocab-indexed derived columns; binary (value, param-pattern) fns
        become interpreter-backed match-table rows."""
        if len(args) == 1:
            sym = self._unary_derived(name, args)
            if sym is not None:
                return Truthy(sym.expr)
            return None
        if len(args) == 2:
            return self._binary_predicate(name, args)
        return None

    def _unary_derived(self, name: str, args: tuple) -> Optional[SExpr]:
        if len(args) != 1:
            return None
        rules = self.ctx.rules.get(name) or []
        if not rules or any(r.kind != "function" for r in rules):
            return None
        if any(_refs_input(r) for r in rules):
            return None  # not pure in its argument
        try:
            sym = self.to_symbolic(args[0])
            base = self.value_expr(sym)
        except Uncompilable:
            return None
        if not isinstance(base, _CELL_EXPRS):
            return None
        col = self.ctx.derived_col("fn", name)
        return SExpr(DerivedVal(col, base))

    def _binary_predicate(self, name: str, args: tuple) -> Optional[Expr]:
        rules = self.ctx.rules.get(name) or []
        if not rules or any(r.kind != "function" for r in rules):
            return None
        if any(_refs_input(r) for r in rules):
            return None
        syms = []
        try:
            syms = [self.to_symbolic(a) for a in args]
        except Uncompilable:
            return None
        # find the parameter-side (pattern) argument
        pat_i = None
        for i, s in enumerate(syms):
            if isinstance(s, SPath) and s.root == "params":
                pat_i = i
        if pat_i is None:
            return None
        val_i = 1 - pat_i
        pat_sym = syms[pat_i]
        # op encodes argument order so the host closure applies the fn
        # with the pattern in the right position
        op = f"pred:{self.ctx.kind}:{name}:{pat_i}"
        self.ctx.pred_ops[op] = name
        try:
            vexpr = self.value_expr(syms[val_i])
        except Uncompilable:
            return None
        row = self._pattern_row(op, pat_sym)
        return MatchLookup(row=row, sid=vexpr)

    def match_call(self, op: str, args: tuple) -> Expr:
        """startswith(value, pattern) / re_match(pattern, value) etc."""
        if op in ("re_match", "glob"):
            pattern_t, value_t = args[0], args[1]
        else:
            value_t, pattern_t = args[0], args[1]
        value = self.to_symbolic(value_t)
        vexpr = self.value_expr(value)
        # pattern-side transform: startswith(x, trim(params.p[_], "*"))
        while isinstance(pattern_t, A.Call) and len(pattern_t.fn) == 1 and \
                pattern_t.fn[0] in _PATTERN_TRANSFORMS:
            targs = pattern_t.args
            if len(targs) == 2 and isinstance(targs[1], A.Scalar) and \
                    isinstance(targs[1].value, str):
                from ..ops.strtab import escape_transform_arg
                op = (f"{op}@{_PATTERN_TRANSFORMS[pattern_t.fn[0]]}:"
                      f"{escape_transform_arg(targs[1].value)}")
                pattern_t = targs[0]
            elif len(targs) == 1:
                op = f"{op}@{_PATTERN_TRANSFORMS[pattern_t.fn[0]]}:"
                pattern_t = targs[0]
            else:
                raise Uncompilable("pattern", "unsupported pattern transform")
        pattern = self.to_symbolic(pattern_t)
        row = self._pattern_row(op, pattern)
        return MatchLookup(row=row, sid=vexpr)

    def _pattern_row(self, op: str, pattern: Symbolic) -> Expr:
        if isinstance(pattern, SConst):
            if not isinstance(pattern.value, str):
                raise Uncompilable("pattern", "pattern must be a string")
            return Const("row", (op, pattern.value))
        if isinstance(pattern, SPath) and pattern.root == "params":
            axes = [s.axis for s in pattern.segs if s.kind == "iter"]
            mode = "list" if axes else "scalar"
            rec = self._param_slot(pattern, mode=mode)
            rec.pattern_ops.add(op)
            return PVal(rec.slot, f=f"row:{op}",
                        axis=axes[-1] if axes else None)
        if isinstance(pattern, SKey) and pattern.kind == "param":
            raise Uncompilable("pattern", "param key as pattern")
        raise Uncompilable("pattern", "pattern must come from parameters or constants")

    # ------------------------------------------------------------------ sets

    def _set_elem_expr(self, s: SSet) -> Expr:
        slot = self._set_slot(s)
        axes = [seg.axis for seg in s.path.segs if seg.kind == "iter"]
        axis = axes[-1] if axes else None
        if s.source == "paramvals":
            return PVal(slot, f="val", axis=axis)
        if s.source == "paramkeys":
            return PVal(slot, f="key", axis=axis)
        if s.source == "objkeys":
            return OVal(slot, f="key", axis=axis)
        return OVal(slot, f="val", axis=axis)

    def _set_slot(self, s: SSet) -> int:
        if s.source in ("paramvals", "paramkeys"):
            return self._param_slot(s.path, mode="list").slot
        return self._obj_slot(s.path, mode="entries").slot

    def count_of(self, sym: Symbolic) -> Expr:
        if isinstance(sym, SSetDiff):
            return self.setdiff_count(sym)
        if isinstance(sym, SSetInter):
            return self.setinter_count(sym)
        if isinstance(sym, SSet):
            # |set| as an existence sum — dedup makes this valid only for
            # emptiness comparisons (zero_only enforced by count_symbolic)
            if sym.source == "exists":
                inner = sym.filter if sym.filter is not None else \
                    Const("bool", True)
                out = inner
                for ax in reversed(sym.axes):
                    out = SumReduce(ax, out)
                if not sym.axes:
                    raise Uncompilable("set-op", "existence set without iteration")
                return out
            if sym.source in ("paramvals", "paramkeys") and \
                    sym.filter is None:
                return PVal(self._set_slot(sym), f="count")
            elem = self._set_elem_expr(sym)
            inner: Expr = Exists(elem)
            if sym.filter is not None:
                inner = And((sym.filter, inner))
            out = inner
            for ax in reversed(sym.axes):
                out = SumReduce(ax, out)
            return out
        if isinstance(sym, SPath):
            # count(path): defined only when the collection exists
            if sym.root == "params":
                rec = self._param_slot(sym, mode="count")
                return PVal(rec.slot, f="count")
            rec = self._obj_slot(sym, mode="count")
            return OVal(rec.slot, f="count")
        raise Uncompilable("count", "unsupported count() argument")

    def _member_test(self, elem: Expr, s: SSet) -> Expr:
        """∃ element of s equal to elem."""
        other = self._set_elem_expr(s)
        test: Expr = Cmp("eq", elem, other, dtype="auto")
        if s.filter is not None:
            test = And((s.filter, test))
        for ax in reversed(s.axes):
            test = OrReduce(ax, test)
        return test

    def setdiff_count(self, sd: SSetDiff) -> Expr:
        """|A - B| as a device expr, valid for comparisons against 0 (set
        dedup does not change emptiness)."""
        if not isinstance(sd.left, SSet):
            raise Uncompilable("set-op", "nested set difference")
        left, right = sd.left, sd.right
        if left.source == "exists" or right.source == "exists":
            raise Uncompilable("set-op", "set difference over existence set")
        lv = self._set_elem_expr(left)
        inner: Expr = Not(self._member_test(lv, right))
        if left.filter is not None:
            inner = And((left.filter, inner))
        out = inner
        for ax in reversed(left.axes):
            out = SumReduce(ax, out)
        if not left.axes:
            raise Uncompilable("set-op", "set difference without iteration")
        return out

    def setinter_count(self, si: SSetInter) -> Expr:
        left, right = si.left, si.right
        if left.source == "exists" or right.source == "exists":
            raise Uncompilable("set-op", "set intersection over existence set")
        lv = self._set_elem_expr(left)
        inner: Expr = self._member_test(lv, right)
        if left.filter is not None:
            inner = And((left.filter, inner))
        out = inner
        for ax in reversed(left.axes):
            out = SumReduce(ax, out)
        if not left.axes:
            raise Uncompilable("set-op", "set intersection without iteration")
        return out

    # --------------------------------------------------------------- helpers

    def inline_helper(self, name: str, args: tuple) -> Expr:
        if self.depth >= _MAX_INLINE_DEPTH:
            raise Uncompilable("helper", f"helper inline depth exceeded at {name}")
        rules = self.ctx.rules[name]
        actuals = [self.to_symbolic(a) for a in args]
        alts: list[Expr] = []
        for r in rules:
            if r.kind != "function":
                raise Uncompilable("helper", f"{name} is not a function")
            if len(r.args) != len(actuals):
                continue
            env = {}
            const_guards: list[Expr] = []
            ok = True
            for formal, actual in zip(r.args, actuals):
                if isinstance(formal, A.Var):
                    env[formal.name] = actual
                elif isinstance(formal, A.Scalar):
                    # constant formal: unify against the actual value
                    if isinstance(actual, SConst):
                        if actual.value != formal.value:
                            ok = False
                            break
                    else:
                        const_guards.append(Cmp(
                            "eq", self.value_expr(actual),
                            self._const_expr(formal.value), dtype="auto"))
                else:
                    ok = False
                    break
            if not ok:
                continue
            sub = _ClauseCompiler(self.ctx, _body_vars(r.body) | self.needed,
                                  env=env, depth=self.depth + 1)
            for lit in r.body:
                sub.literal(lit)
            exprs = const_guards + [
                g.expr if not g.negated else Not(g.expr)
                for g in sub.guards]
            # head value: None/true => boolean helper; a var bound to a
            # boolean expr (res := u != 0) contributes that expr; any other
            # value contributes its truthiness
            val_expr = self._helper_value(r, sub)
            if val_expr is not None:
                exprs.append(val_expr)
            body = And(tuple(exprs)) if len(exprs) != 1 else exprs[0]
            # axes bound inside the helper are existential at its boundary
            for ax in sub.clause_axes:
                body = OrReduce(ax.name, body)
            alts.append(body)
        if not alts:
            raise Uncompilable("helper", f"{name}: no applicable clauses")
        return Or(tuple(alts)) if len(alts) > 1 else alts[0]

    def _helper_value(self, r: A.Rule, sub: "_ClauseCompiler"
                      ) -> Optional[Expr]:
        v = r.value
        if v is None:
            return None
        if isinstance(v, A.Scalar):
            if v.value is True:
                return None
            # falsy head constant can never succeed in boolean position
            return Const("bool", v.value is not False and v.value is not None)
        if isinstance(v, A.Var) and v.name in sub.env:
            sym = sub.env[v.name]
            if isinstance(sym, SExpr) and isinstance(sym.expr, _BOOL_EXPRS):
                return sym.expr
            return Truthy(sub.value_expr(sym))
        if isinstance(v, (A.Ref, A.Var)):
            return Truthy(sub.value_expr(sub.to_symbolic(v)))
        raise Uncompilable("helper", f"{r.name}: unsupported head value")


def _refs_input(r: A.Rule) -> bool:
    """Does the rule body reference input/data (i.e. not pure in args)?"""
    found = [False]

    def walk(t):
        if isinstance(t, A.Var) and t.name in ("input", "data"):
            found[0] = True
        elif isinstance(t, A.Ref):
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
        elif isinstance(t, (A.ArrayCompr, A.SetCompr)):
            walk(t.head)
            for l in t.body:
                walk(l.expr)
        elif isinstance(t, A.ObjectCompr):
            walk(t.key)
            walk(t.value)
            for l in t.body:
                walk(l.expr)
        elif isinstance(t, (A.Assign, A.Unify)):
            walk(t.lhs)
            walk(t.rhs)

    for lit in r.body:
        walk(lit.expr)
    if r.value is not None:
        walk(r.value)
    return found[0]


# comparisons whose truth is unchanged by duplicate counting (emptiness
# tests); (op, const) with the count on the LEFT side
_ZERO_SAFE = {("gt", 0), ("ne", 0), ("eq", 0), ("le", 0), ("ge", 1), ("lt", 1)}
_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


def _check_zero_only(lhs: "Symbolic", rhs: "Symbolic", op: str) -> None:
    """Reject comparisons where a dedup-sensitive count could change the
    outcome (the never-under-fire invariant)."""
    for count_side, other, eff_op in ((lhs, rhs, op), (rhs, lhs, _FLIP[op])):
        if isinstance(count_side, SExpr) and count_side.zero_only:
            if not (isinstance(other, SConst) and
                    isinstance(other.value, (int, float)) and
                    not isinstance(other.value, bool) and
                    (eff_op, other.value) in _ZERO_SAFE):
                raise Uncompilable(
                    "count",
                    "set-derived counts may only be compared for "
                    "emptiness (e.g. count(x) > 0)")


def _body_vars(body: tuple) -> set:
    out: set = set()
    for lit in body:
        _collect_vars(lit.expr, out)
    return out
