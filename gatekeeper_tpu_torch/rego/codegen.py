"""Per-template Python code generation — the host materialization JIT.

The tree-walking interpreter (interp.py) spends ~4-5k function calls per
violation evaluation on generic unification/backtracking machinery. For the
audit tail — materializing exact messages for every (object, constraint)
pair the device filter fired — that generic cost dominates the end-to-end
wall clock (the reference's analogous cost center is the topdown evaluator
behind pkg/audit/manager.go:250-271).

This module partially evaluates the interpreter for one template: each rule
body becomes straight-line Python (nested loops for iteration, `if` chains
for guards), sharing the interpreter's value model (frozen values from
utils/values.py), its builtins (builtins.py — identical sprintf/number
formatting), and its undefined semantics (an UNDEF sentinel threaded
through helper calls). Outputs are therefore bit-identical to the
interpreter's wherever compilation succeeds; anything outside the subset
raises Unsupported at compile time and the caller keeps the interpreter
path (the same fallback discipline as the device compiler, ir/compile.py).

Differential coverage: tests/test_codegen.py runs every reference library
template's harvested corpus through both paths and asserts equality.
"""

from __future__ import annotations

import operator as _operator
from typing import Any, Callable, Optional

from . import ast as A
from .builtins import BUILTINS, NONDETERMINISTIC, BuiltinError
from .interp import UNDEF, RegoError, _binop
from .safety import reorder_module
from ..utils.values import FrozenDict, rego_eq, sort_key


class Unsupported(Exception):
    pass


_MISS = object()  # fmemo miss sentinel (UNDEF is a legitimate result)


# ----------------------------------------------------------- runtime helpers


_SORTED_SETS: dict[int, tuple] = {}  # id(frozenset) -> (set, sorted tuple)


def _enum(base):
    """Value-only _enumerate (interp.py:696): (key, value) children."""
    if isinstance(base, dict):  # FrozenDict included
        return base.items()
    if isinstance(base, tuple):
        return enumerate(base)
    if isinstance(base, frozenset):
        # canonical order is hot (parameter sets re-enumerate per pair);
        # identity-keyed cache with a liveness check, bounded
        ent = _SORTED_SETS.get(id(base))
        if ent is not None and ent[0] is base:
            srt = ent[1]
        else:
            if len(_SORTED_SETS) > 4096:
                _SORTED_SETS.clear()
            srt = tuple(sorted(base, key=sort_key))
            _SORTED_SETS[id(base)] = (base, srt)
        return ((m, m) for m in srt)
    return ()


def _stepv(base, key):
    """Value-only _step (interp.py:743) with UNDEF propagation."""
    if isinstance(base, dict):
        v = base.get(key, UNDEF)
        return v
    if isinstance(base, tuple):
        if isinstance(key, bool) or not isinstance(key, int):
            return UNDEF
        if 0 <= key < len(base):
            return base[key]
        return UNDEF
    if isinstance(base, frozenset):
        return key if key in base else UNDEF
    return UNDEF


def _lookupk(base, k):
    """Keyed lookup with EXACTLY the semantics of enumerating `base` and
    filtering keys by rego_eq(k, key) — the join-reorder transform's
    contract (it replaces that enumeration). Differs from _stepv on
    bool-vs-number keys: rego_eq is type-aware while Python dict lookup
    aliases True with 1, so numeric/bool keys take the scan path."""
    if isinstance(base, dict):
        if isinstance(k, (bool, int, float)):
            for kk, vv in base.items():
                if rego_eq(k, kk):
                    return vv
            return UNDEF
        return base.get(k, UNDEF)
    if isinstance(base, tuple):
        if isinstance(k, bool):
            return UNDEF
        if isinstance(k, float):
            # builtins can produce integral floats at runtime (results
            # are not re-frozen); rego_eq(2.0, 2) matches index 2
            if not k.is_integer():
                return UNDEF
            k = int(k)
        if isinstance(k, int) and 0 <= k < len(base):
            return base[k]
        return UNDEF
    if isinstance(base, frozenset):
        if isinstance(k, (bool, int, float)):
            for m in base:
                if rego_eq(k, m):
                    return m
            return UNDEF
        return k if k in base else UNDEF
    return UNDEF


def _call(fn, *args):
    """Builtin call: undefined args / builtin errors -> undefined
    (mirrors _iter_call's except clauses, interp.py:822-830)."""
    for a in args:
        if a is UNDEF:
            return UNDEF
    try:
        return fn(*args)
    except BuiltinError:
        return UNDEF
    except (TypeError, ValueError, KeyError, ZeroDivisionError):
        return UNDEF


def _callu(fn, J, *args):
    """User-function call with undefined-argument propagation."""
    for a in args:
        if a is UNDEF:
            return UNDEF
    return fn(J, *args)


def _bin(op, a, b):
    if a is UNDEF or b is UNDEF:
        return UNDEF
    return _binop(op, a, b)


def _bin_eq(a, b):
    if a is UNDEF or b is UNDEF:
        return UNDEF
    return rego_eq(a, b)


def _bin_neq(a, b):
    if a is UNDEF or b is UNDEF:
        return UNDEF
    return not rego_eq(a, b)


def _bin_minus(a, b):
    """Mirrors _binop("-"): numeric difference or set difference."""
    if a is UNDEF or b is UNDEF:
        return UNDEF
    if isinstance(a, (int, float)) and not isinstance(a, bool) and \
            isinstance(b, (int, float)) and not isinstance(b, bool):
        return a - b
    if isinstance(a, frozenset) and isinstance(b, frozenset):
        return a - b
    return UNDEF


def _mk_bin_cmp(py_op):
    def f(a, b, _cmp=py_op):
        if a is UNDEF or b is UNDEF:
            return UNDEF
        return _cmp(sort_key(a), sort_key(b))
    return f


# codegen-time specialization of the hottest comparison/difference ops:
# one closure call instead of the generic op-string dispatch chain
# (identical semantics to _binop; everything else falls through to _bin)
_BIN_SPECIAL = {
    "==": _bin_eq,
    "!=": _bin_neq,
    "-": _bin_minus,
    "<": _mk_bin_cmp(_operator.lt),
    "<=": _mk_bin_cmp(_operator.le),
    ">": _mk_bin_cmp(_operator.gt),
    ">=": _mk_bin_cmp(_operator.ge),
}


def _neg(a):
    if isinstance(a, (int, float)) and not isinstance(a, bool):
        return -a
    return UNDEF


def _arr(*xs):
    for x in xs:
        if x is UNDEF:
            return UNDEF
    return xs


def _setl(*xs):
    for x in xs:
        if x is UNDEF:
            return UNDEF
    return frozenset(xs)


def _obj(*kv):
    for x in kv:
        if x is UNDEF:
            return UNDEF
    return FrozenDict(zip(kv[0::2], kv[1::2]))


# ----------------------------------------------------------------- compiler


def _hint_term_safe(t) -> bool:
    """True when a join-reorder pin expression cannot RAISE at runtime:
    vars, scalars, path refs with safe steps, and literal containers of
    the same. Calls (user functions can raise RegoError on multi-output
    conflicts), arithmetic (divide-by-zero), and comprehensions are
    excluded — path steps merely go UNDEF, which the guard handles."""
    if isinstance(t, (A.Var, A.Scalar)):
        return True
    if isinstance(t, A.Ref):
        return _hint_term_safe(t.base) and all(
            _hint_term_safe(a) for a in t.args)
    if isinstance(t, (A.ArrayLit, A.SetLit)):
        return all(_hint_term_safe(x) for x in t.items)
    if isinstance(t, A.ObjectLit):
        return all(_hint_term_safe(k) and _hint_term_safe(v)
                   for k, v in t.items)
    return False


class _NotDeterministic(Exception):
    """Internal: term needs loop emission (unbound ref args)."""


class _Emit:
    def __init__(self):
        self.lines: list[str] = []
        self._n = 0

    def w(self, ind: int, s: str) -> None:
        self.lines.append("    " * ind + s)

    def tmp(self) -> str:
        self._n += 1
        return f"_t{self._n}"

    def src(self) -> str:
        return "\n".join(self.lines)


class _Scope:
    """Static var -> python-name map; mirrors the runtime env exactly
    because literals are compiled in the safety-reordered evaluation
    order the interpreter uses."""

    def __init__(self, names: Optional[dict] = None):
        self.names = dict(names or {})
        self.fresh: set[str] = set()

    def child(self) -> "_Scope":
        c = _Scope(self.names)
        c.fresh = set(self.fresh)
        return c

    def bound(self, name: str) -> bool:
        return name in self.names


def _calls_nondeterministic(r: A.Rule) -> bool:
    found = False

    def walk(t) -> None:
        nonlocal found
        if found:
            return
        if isinstance(t, A.Call):
            if tuple(t.fn) in NONDETERMINISTIC:
                found = True
                return
            for a in t.args:
                walk(a)
        elif isinstance(t, A.Ref):
            walk(t.base)
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

    for lit in r.body:
        if not isinstance(lit.expr, A.SomeDecl):
            walk(lit.expr)
    for h in (r.key, r.value):
        if h is not None:
            walk(h)
    return found


def _collect_arg_vars(t, into: set) -> None:
    if isinstance(t, A.Var):
        if not t.name.startswith("$wc"):
            into.add(t.name)
    elif isinstance(t, (A.ArrayLit, A.SetLit)):
        for x in t.items:
            _collect_arg_vars(x, into)
    elif isinstance(t, A.ObjectLit):
        for _k, v in t.items:
            _collect_arg_vars(v, into)


def _term_vars(t, into: set) -> None:
    """All Var names + called function names appearing in a term."""
    if isinstance(t, A.Var):
        into.add(t.name)
    elif isinstance(t, A.Ref):
        _term_vars(t.base, into)
        for a in t.args:
            _term_vars(a, into)
    elif isinstance(t, A.Call):
        if len(t.fn) == 1:
            into.add(t.fn[0])
        else:
            into.add(t.fn[0])  # e.g. "data" roots mark impurity
        for a in t.args:
            _term_vars(a, into)
    elif isinstance(t, A.BinOp):
        _term_vars(t.lhs, into)
        _term_vars(t.rhs, into)
    elif isinstance(t, A.UnaryMinus):
        _term_vars(t.term, into)
    elif isinstance(t, (A.ArrayLit, A.SetLit)):
        for x in t.items:
            _term_vars(x, into)
    elif isinstance(t, A.ObjectLit):
        for k, v in t.items:
            _term_vars(k, into)
            _term_vars(v, into)
    elif isinstance(t, (A.ArrayCompr, A.SetCompr)):
        _term_vars(t.head, into)
        for lit in t.body:
            _term_vars(lit.expr, into)
    elif isinstance(t, A.ObjectCompr):
        _term_vars(t.key, into)
        _term_vars(t.value, into)
        for lit in t.body:
            _term_vars(lit.expr, into)
    elif isinstance(t, (A.Assign, A.Unify)):
        _term_vars(t.lhs, into)
        _term_vars(t.rhs, into)


def _sections_ok(module: A.Module) -> bool:
    """True when every `input` reference steps through a static
    "review"/"parameters" first segment (the hook contract), so the
    compiled evaluator can take the two sections as direct arguments —
    no per-call input-wrapper construction. A bare `input` anywhere
    (including as a pattern var) disables the optimization."""
    ok = True

    def walk(t) -> None:
        nonlocal ok
        if not ok:
            return
        if isinstance(t, A.Var):
            if t.name == "input":
                ok = False
            return
        if isinstance(t, A.Ref):
            if isinstance(t.base, A.Var) and t.base.name == "input":
                if not (t.args and isinstance(t.args[0], A.Scalar)
                        and t.args[0].value in ("review", "parameters")):
                    ok = False
                for a in t.args:
                    walk(a)
                return
            walk(t.base)
            for a in t.args:
                walk(a)
            return
        if isinstance(t, A.Call):
            for a in t.args:
                walk(a)
            return
        if isinstance(t, A.BinOp):
            walk(t.lhs)
            walk(t.rhs)
            return
        if isinstance(t, A.UnaryMinus):
            walk(t.term)
            return
        if isinstance(t, (A.ArrayLit, A.SetLit)):
            for x in t.items:
                walk(x)
            return
        if isinstance(t, A.ObjectLit):
            for k, v in t.items:
                walk(k)
                walk(v)
            return
        if isinstance(t, (A.ArrayCompr, A.SetCompr)):
            walk(t.head)
            for lit in t.body:
                if not isinstance(lit.expr, A.SomeDecl):
                    walk(lit.expr)
            return
        if isinstance(t, A.ObjectCompr):
            walk(t.key)
            walk(t.value)
            for lit in t.body:
                if not isinstance(lit.expr, A.SomeDecl):
                    walk(lit.expr)
            return
        if isinstance(t, (A.Assign, A.Unify)):
            walk(t.lhs)
            walk(t.rhs)
            return

    for r in module.rules:
        for lit in r.body:
            if not isinstance(lit.expr, A.SomeDecl):
                walk(lit.expr)
        for h in (r.key, r.value):
            if h is not None:
                walk(h)
        for a in r.args:
            walk(a)
        if not ok:
            break
    return ok


def _is_const_term(t) -> bool:
    if isinstance(t, A.Scalar):
        return True
    if isinstance(t, (A.ArrayLit, A.SetLit)):
        return all(_is_const_term(x) for x in t.items)
    if isinstance(t, A.ObjectLit):
        return all(_is_const_term(k) and _is_const_term(v)
                   for k, v in t.items)
    return False


class ModuleCompiler:
    def __init__(self, module: A.Module):
        module = reorder_module(module)
        self.module = module
        self._sections = _sections_ok(module)
        self.rules: dict[str, list[A.Rule]] = {}
        for r in module.rules:
            self.rules.setdefault(r.name, []).append(r)
        # constant rules (pure literal values, e.g. unit tables like
        # containerlimits' unit_scale): folded to one module-level value
        # at compile time instead of re-materializing per evaluation,
        # and transparent to the arg-purity analysis so quantity-parsing
        # helpers that read them still memoize on their arguments
        self.const_rules = {
            name for name, rs in self.rules.items()
            if len(rs) == 1 and rs[0].kind == "complete"
            and not rs[0].body and not rs[0].is_default
            and rs[0].value is not None and _is_const_term(rs[0].value)}
        self.arg_pure = self._arg_pure_fns()
        self.em = _Emit()
        self.builtin_bindings: dict[tuple, str] = {}
        self.bin_bindings: dict[str, str] = {}
        self._pat_n = 0
        self._rmemo_n = 0  # review-pure comprehension memo slots
        self._pmemo_n = 0  # params-pure comprehension memo slots
        self._hmemo_n = 0  # head-witness memo slots
        # join-reorder bookkeeping: id(literal) -> (key var, pin expr);
        # _hint_refs pins the literal objects so ids stay valid
        self._key_hints: dict[int, tuple] = {}
        self._hint_refs: list = []
        self._hint_bind: dict[str, str] = {}
        # static input-path CSE: path tuple -> hoisted temp name, emitted
        # once at rule entry (pure _stepv chains, so unconditional
        # evaluation is safe — UNDEF just propagates)
        self._path_cache: Optional[dict] = None

    def _arg_pure_fns(self) -> set:
        """Functions whose result depends ONLY on their arguments: no
        input/data references, no calls to non-arg-pure user rules.
        Their calls memoize on the (frozen, hashable) argument tuple —
        the inventory-join hot loops re-apply the same projection
        function to the same inventory objects once per review, so a
        memo turns O(reviews × inventory) evaluations into O(inventory).
        """
        fns = {name: rules for name, rules in self.rules.items()
               if rules[0].kind == "function"}
        deps: dict[str, set] = {}
        for name, rules in fns.items():
            names: set = set()
            for r in rules:
                if any(lit.withs for lit in r.body):
                    names.add("input")  # `with`: treat as impure
                if _calls_nondeterministic(r):
                    names.add("input")  # time.now_ns etc: never memoize
                for lit in r.body:
                    _term_vars(lit.expr, names)
                if r.value is not None:
                    _term_vars(r.value, names)
                for a in r.args:
                    _term_vars(a, names)
            deps[name] = names
        pure = set(fns)
        changed = True
        while changed:
            changed = False
            for name in list(pure):
                names = deps[name]
                if "input" in names or "data" in names:
                    pure.discard(name)
                    changed = True
                    continue
                for n in names:
                    if n in self.rules and n not in fns:
                        if n in self.const_rules:
                            continue  # constants are pure by definition
                        pure.discard(name)  # reads a document rule
                        changed = True
                        break
                    if n in fns and n not in pure:
                        pure.discard(name)
                        changed = True
                        break
        return pure

    # ------------------------------------------------------------- naming

    def _py(self, scope: _Scope, name: str) -> str:
        pn = "v_" + name.replace("$", "_w_")
        scope.names[name] = pn
        scope.fresh.discard(name)
        return pn

    def _builtin(self, fn: tuple) -> str:
        b = self.builtin_bindings.get(fn)
        if b is None:
            b = "_b" + str(len(self.builtin_bindings))
            self.builtin_bindings[fn] = b
        return b

    def _bin_expr(self, op: str, a: str, b: str) -> str:
        """Binary-op call, specialized for the hot ops (_BIN_SPECIAL)."""
        if op not in _BIN_SPECIAL:
            return f"_bin({op!r}, {a}, {b})"
        bound = self.bin_bindings.get(op)
        if bound is None:
            bound = "_c" + str(len(self.bin_bindings))
            self.bin_bindings[op] = bound
        return f"{bound}({a}, {b})"

    # -------------------------------------------------------- deterministic

    def value(self, t, scope: _Scope, ind: int) -> str:
        """Python expression for a single-valued term; may pre-emit
        statements (comprehensions). Raises _NotDeterministic when the
        term iterates (unbound ref brackets)."""
        if isinstance(t, A.Scalar):
            return repr(t.value)
        if isinstance(t, A.Var):
            return self._var_value(t.name, scope)
        if isinstance(t, A.Ref):
            return self._ref_value(t, scope, ind)
        if isinstance(t, A.Call):
            return self._call_value(t, scope, ind)
        if isinstance(t, A.BinOp):
            a = self.value(t.lhs, scope, ind)
            b = self.value(t.rhs, scope, ind)
            return self._bin_expr(t.op, a, b)
        if isinstance(t, A.UnaryMinus):
            return f"_neg({self.value(t.term, scope, ind)})"
        if isinstance(t, A.ArrayLit):
            items = [self.value(x, scope, ind) for x in t.items]
            return f"_arr({', '.join(items)})"
        if isinstance(t, A.SetLit):
            items = [self.value(x, scope, ind) for x in t.items]
            return f"_setl({', '.join(items)})"
        if isinstance(t, A.ObjectLit):
            kv = []
            for k, v in t.items:
                kv.append(self.value(k, scope, ind))
                kv.append(self.value(v, scope, ind))
            return f"_obj({', '.join(kv)})"
        if isinstance(t, (A.SetCompr, A.ArrayCompr, A.ObjectCompr)):
            return self._compr(t, scope, ind)
        raise Unsupported(f"term {type(t).__name__}")

    def _var_value(self, name: str, scope: _Scope) -> str:
        if scope.bound(name):
            return scope.names[name]
        if name == "input":
            return "_J['input']"
        if name == "data":
            raise Unsupported("bare data reference")
        rules = self.rules.get(name)
        if rules:
            if rules[0].kind == "function":
                raise Unsupported(f"function {name} in value position")
            return f"rule_{name}(_J)"
        if name.startswith("$wc") or name in scope.fresh:
            raise _NotDeterministic()
        raise Unsupported(f"unbound var {name} in value position")

    def _ref_value(self, t: A.Ref, scope: _Scope, ind: int) -> str:
        args = list(t.args)
        cached = self._cached_input_prefix(t, scope)
        if cached is not None:
            base, args = cached
        elif isinstance(t.base, A.Var) and t.base.name == "data" and \
                not scope.bound("data"):
            if args and isinstance(args[0], A.Scalar) and \
                    args[0].value == "inventory":
                base = "_J['inv']"
                args = args[1:]
            else:
                raise Unsupported("data reference beyond inventory")
        else:
            base = self.value(t.base, scope, ind)
        for a in args:
            if isinstance(a, A.Var) and not scope.bound(a.name) and \
                    a.name not in ("input", "data"):
                raise _NotDeterministic()
            if self._is_static_pattern(a, scope):
                raise _NotDeterministic()
            base = f"_stepv({base}, {self.value(a, scope, ind)})"
        return base

    def _call_value(self, t: A.Call, scope: _Scope, ind: int) -> str:
        fn = tuple(t.fn)
        args = [self.value(a, scope, ind) for a in t.args]
        if len(fn) == 1 and fn[0] in self.rules:
            rules = self.rules[fn[0]]
            if rules[0].kind != "function":
                raise Unsupported(f"{fn[0]} is not a function")
            return f"_callu(fn_{fn[0]}, _J, {', '.join(args)})"
        if fn[0] == "data":
            raise Unsupported(f"data function call {fn}")
        if fn not in BUILTINS:
            raise Unsupported(f"unknown function {'.'.join(fn)}")
        b = self._builtin(fn)
        return f"_call({b}, {', '.join(args)})"

    # ------------------------------------------------- review-pure analysis

    def _review_pure(self, t, scope: _Scope) -> bool:
        return self._input_pure(t, scope, "review")

    def _params_pure(self, t, scope: _Scope) -> bool:
        return self._input_pure(t, scope, "parameters")

    def _input_pure(self, t, scope: _Scope, section: str) -> bool:
        """True when a comprehension's value depends ONLY on
        input.<section>: no outer-scope variable reads, no data/inventory
        refs, no user rule/function calls (they may read other input
        sections), and every input reference steps through <section>
        first. section="review" comprehensions are identical across the
        many constraints one review is evaluated against in an audit and
        memoize per review; section="parameters" comprehensions are
        identical across the many reviews one constraint sweeps and
        memoize per constraint."""
        outer = set(scope.names)

        def ok(x, bound: set) -> bool:
            if isinstance(x, A.Scalar):
                return True
            if isinstance(x, A.Var):
                if x.name in bound or x.name.startswith("$wc"):
                    return True
                # outer-scope binding (or a rule reference): impure
                return False
            if isinstance(x, A.Ref):
                if isinstance(x.base, A.Var) and x.base.name == "input" \
                        and "input" not in bound and "input" not in outer:
                    if not x.args or not (isinstance(x.args[0], A.Scalar)
                                          and x.args[0].value == section):
                        return False
                    return all(ok(a, bound) for a in x.args[1:])
                return ok(x.base, bound) and \
                    all(ok(a, bound) for a in x.args)
            if isinstance(x, A.Call):
                fn = tuple(x.fn)
                if fn not in BUILTINS or fn in NONDETERMINISTIC:
                    return False  # user/data fn or impure builtin
                return all(ok(a, bound) for a in x.args)
            if isinstance(x, A.BinOp):
                return ok(x.lhs, bound) and ok(x.rhs, bound)
            if isinstance(x, A.UnaryMinus):
                return ok(x.term, bound)
            if isinstance(x, (A.ArrayLit, A.SetLit)):
                return all(ok(i, bound) for i in x.items)
            if isinstance(x, A.ObjectLit):
                return all(ok(k, bound) and ok(v, bound)
                           for k, v in x.items)
            return False  # nested comprehensions etc.: be conservative

        def collect_vars(x, into: set) -> None:
            """All vars a pattern-position term could bind."""
            if isinstance(x, A.Var):
                into.add(x.name)
            elif isinstance(x, (A.ArrayLit, A.SetLit)):
                for i in x.items:
                    collect_vars(i, into)
            elif isinstance(x, A.ObjectLit):
                for _k, v in x.items:
                    collect_vars(v, into)
            elif isinstance(x, A.Ref):
                for a in x.args:
                    collect_vars(a, into)

        bound: set = set()
        body = getattr(t, "body", ())
        # first pass: everything the body can bind (iteration vars,
        # unification targets, some-decls) counts as locally bound
        for lit in body:
            if lit.withs:
                return False
            e = lit.expr
            if isinstance(e, A.SomeDecl):
                bound.update(e.names)
            elif isinstance(e, (A.Assign, A.Unify)):
                collect_vars(e.lhs, bound)
                collect_vars(e.rhs, bound)
            else:
                collect_vars(e, bound)
        bound -= outer  # outer bindings shadow nothing here: reads of them
        # are what makes the comprehension constraint-dependent
        for lit in body:
            e = lit.expr
            if isinstance(e, A.SomeDecl):
                continue
            if isinstance(e, (A.Assign, A.Unify)):
                if not (ok(e.lhs, bound) and ok(e.rhs, bound)):
                    return False
            elif not ok(e, bound):
                return False
        heads = [h for h in (getattr(t, "head", None),
                             getattr(t, "key", None),
                             getattr(t, "value", None)) if h is not None]
        return all(ok(h, bound) for h in heads)

    def _compr(self, t, scope: _Scope, ind: int) -> str:
        if self._review_pure(t, scope):
            slot = self._rmemo_n
            self._rmemo_n += 1
            out = self.em.tmp()
            self.em.w(ind, f"{out} = _J['rmemo'].get({slot})")
            self.em.w(ind, f"if {out} is None:")
            out2 = self._compr_emit(t, scope, ind + 1)
            self.em.w(ind + 1, f"{out} = {out2}")
            self.em.w(ind + 1, f"_J['rmemo'][{slot}] = {out}")
            return out
        if self._params_pure(t, scope):
            slot = self._pmemo_n
            self._pmemo_n += 1
            out = self.em.tmp()
            self.em.w(ind, f"{out} = _J['pmemo'].get({slot})")
            self.em.w(ind, f"if {out} is None:")
            out2 = self._compr_emit(t, scope, ind + 1)
            self.em.w(ind + 1, f"{out} = {out2}")
            self.em.w(ind + 1, f"_J['pmemo'][{slot}] = {out}")
            return out
        return self._compr_emit(t, scope, ind)

    def _compr_emit(self, t, scope: _Scope, ind: int) -> str:
        acc = self.em.tmp()
        sub = scope.child()
        body = self._schedule_body(t.body, set(scope.names))
        if isinstance(t, A.ObjectCompr):
            self.em.w(ind, f"{acc} = {{}}")

            def done(i):
                def kcont(j, kname):
                    def vcont(l, vname):
                        self.em.w(l, f"if {kname} in {acc} and not rego_eq("
                                     f"{acc}[{kname}], {vname}):")
                        self.em.w(l + 1,
                                  "raise RegoError('object comprehension: "
                                  "conflicting key')")
                        self.em.w(l, f"{acc}[{kname}] = {vname}")
                    self.iter_emit(t.value, sub, j, vcont)
                self.iter_emit(t.key, sub, i, kcont)
            self.solve(body, 0, sub, ind, done)
            out = self.em.tmp()
            self.em.w(ind, f"{out} = FrozenDict({acc})")
            return out
        ctor = "frozenset" if isinstance(t, A.SetCompr) else "tuple"
        self.em.w(ind, f"{acc} = []" if ctor == "tuple" else f"{acc} = set()")
        add = f"{acc}.append" if ctor == "tuple" else f"{acc}.add"

        def done2(i):
            self.iter_emit(t.head, sub, i,
                           lambda j, v: self.em.w(j, f"{add}({v})"))
        self.solve(body, 0, sub, ind, done2)
        out = self.em.tmp()
        self.em.w(ind, f"{out} = {ctor}({acc})")
        return out

    # ---------------------------------------------------------- iteration

    def iter_emit(self, t, scope: _Scope, ind: int,
                  cont: Callable[[int, str], None]) -> None:
        """Emit code yielding each value of term t; cont(ind, pyname) emits
        the per-value continuation. Values passed to cont are never UNDEF
        (mirrors _iter_term: undefined terms yield nothing)."""
        try:
            expr = self.value(t, scope, ind)
        except _NotDeterministic:
            self._iter_structural(t, scope, ind, cont)
            return
        v = self.em.tmp()
        self.em.w(ind, f"{v} = {expr}")
        if isinstance(t, A.Scalar):
            cont(ind, v)
            return
        self.em.w(ind, f"if {v} is not UNDEF:")
        cont(ind + 1, v)

    def _iter_structural(self, t, scope: _Scope, ind: int, cont) -> None:
        if isinstance(t, A.Ref):
            self._iter_ref(t, scope, ind, cont)
            return
        if isinstance(t, A.Call):
            self._iter_args(list(t.args), [], scope, ind,
                            lambda i, names: self._finish_call(
                                t, names, scope, i, cont))
            return
        if isinstance(t, A.BinOp):
            def fin(i, names):
                v = self.em.tmp()
                self.em.w(i, f"{v} = "
                             f"{self._bin_expr(t.op, names[0], names[1])}")
                self.em.w(i, f"if {v} is not UNDEF:")
                cont(i + 1, v)
            self._iter_args([t.lhs, t.rhs], [], scope, ind, fin)
            return
        if isinstance(t, (A.ArrayLit, A.SetLit)):
            ctor = "_arr" if isinstance(t, A.ArrayLit) else "_setl"

            def fin2(i, names):
                v = self.em.tmp()
                self.em.w(i, f"{v} = {ctor}({', '.join(names)})")
                cont(i, v)
            self._iter_args(list(t.items), [], scope, ind, fin2)
            return
        if isinstance(t, A.ObjectLit):
            terms = [k for k, _ in t.items] + [v for _, v in t.items]

            def fin3(i, names):
                n = len(t.items)
                kv = []
                for j in range(n):
                    kv.append(names[j])
                    kv.append(names[n + j])
                v = self.em.tmp()
                self.em.w(i, f"{v} = _obj({', '.join(kv)})")
                cont(i, v)
            self._iter_args(terms, [], scope, ind, fin3)
            return
        raise Unsupported(f"iterating term {type(t).__name__}")

    def _finish_call(self, t: A.Call, argnames, scope, ind, cont):
        fn = tuple(t.fn)
        if len(fn) == 1 and fn[0] in self.rules:
            if self.rules[fn[0]][0].kind != "function":
                raise Unsupported(f"{fn[0]} is not a function")
            expr = f"_callu(fn_{fn[0]}, _J, {', '.join(argnames)})"
        elif fn in BUILTINS:
            expr = f"_call({self._builtin(fn)}, {', '.join(argnames)})"
        else:
            raise Unsupported(f"unknown function {'.'.join(fn)}")
        v = self.em.tmp()
        self.em.w(ind, f"{v} = {expr}")
        self.em.w(ind, f"if {v} is not UNDEF:")
        cont(ind + 1, v)

    def _iter_args(self, terms, names, scope, ind, fin) -> None:
        """Cross-product iteration of argument terms (interp _iter_product)."""
        if not terms:
            fin(ind, names)
            return
        self.iter_emit(terms[0], scope, ind,
                       lambda i, v: self._iter_args(
                           terms[1:], names + [v], scope, i, fin))

    def _iter_ref(self, t: A.Ref, scope: _Scope, ind: int, cont) -> None:
        args = list(t.args)
        cached = self._cached_input_prefix(t, scope)
        if cached is not None:
            base, args = cached
            if not args:
                # whole ref is the hoisted path: keep iter_emit's
                # UNDEF-yields-nothing contract
                self.em.w(ind, f"if {base} is not UNDEF:")
                cont(ind + 1, base)
                return
            self._walk(base, args, scope, ind, cont)
            return
        if isinstance(t.base, A.Var) and t.base.name == "data" and \
                not scope.bound("data"):
            if args and isinstance(args[0], A.Scalar) and \
                    args[0].value == "inventory":
                base = self.em.tmp()
                self.em.w(ind, f"{base} = _J['inv']")
                self._walk(base, args[1:], scope, ind, cont)
                return
            raise Unsupported("data reference beyond inventory")
        self.iter_emit(t.base, scope, ind,
                       lambda i, b: self._walk(b, args, scope, i, cont))

    def _walk(self, base: str, args, scope: _Scope, ind: int, cont) -> None:
        if not args:
            cont(ind, base)
            return
        a = args[0]
        unbound_var = (isinstance(a, A.Var)
                       and not scope.bound(a.name)
                       and a.name not in ("input", "data"))
        if unbound_var and a.name in self._hint_bind:
            # join-reorder hint: a later equality pins this key var, so
            # replace the enumeration with one keyed lookup
            te = self._hint_bind.pop(a.name)
            pn = self._py(scope, a.name)
            self.em.w(ind, f"{pn} = {te}")
            v = self.em.tmp()
            self.em.w(ind, f"{v} = _lookupk({base}, {pn})")
            self.em.w(ind, f"if {v} is not UNDEF:")
            self._walk(v, args[1:], scope, ind + 1, cont)
            return
        if unbound_var:
            k = self.em.tmp()
            v = self.em.tmp()
            self.em.w(ind, f"for {k}, {v} in _enum({base}):")
            sub_ind = ind + 1
            if not a.name.startswith("$wc"):
                pn = self._py(scope, a.name)
                self.em.w(sub_ind, f"{pn} = {k}")
            self._walk(v, args[1:], scope, sub_ind, cont)
            return
        if self._is_static_pattern(a, scope):
            k = self.em.tmp()
            v = self.em.tmp()
            self.em.w(ind, f"for {k}, {v} in _enum({base}):")
            self.pattern(a, k, scope, ind + 1,
                         lambda i: self._walk(v, args[1:], scope, i, cont))
            return
        key = self.value(a, scope, ind)
        nxt = self.em.tmp()
        self.em.w(ind, f"{nxt} = _stepv({base}, {key})")
        self.em.w(ind, f"if {nxt} is not UNDEF:")
        self._walk(nxt, args[1:], scope, ind + 1, cont)

    # ------------------------------------------------------------ patterns

    def _is_static_pattern(self, t, scope: _Scope) -> bool:
        """Static mirror of interp._is_pattern over the tracked scope."""
        if isinstance(t, A.Var):
            if t.name in ("input", "data") and not scope.bound(t.name):
                return False
            return not scope.bound(t.name)
        if isinstance(t, A.ArrayLit):
            return any(self._is_static_pattern(x, scope) for x in t.items)
        if isinstance(t, A.ObjectLit):
            return any(self._is_static_pattern(v, scope)
                       for _, v in t.items)
        return False

    def pattern(self, t, val: str, scope: _Scope, ind: int, cont) -> None:
        """Emit unification of pattern t against value `val`
        (mirrors _unify_pattern, interp.py:487)."""
        if isinstance(t, A.Var):
            if not scope.bound(t.name):
                if t.name.startswith("$wc"):
                    cont(ind)
                    return
                pn = self._py(scope, t.name)
                self.em.w(ind, f"{pn} = {val}")
                cont(ind)
                return
            self.em.w(ind, f"if rego_eq({scope.names[t.name]}, {val}):")
            cont(ind + 1)
            return
        if isinstance(t, A.ArrayLit):
            n = len(t.items)
            self.em.w(ind, f"if isinstance({val}, tuple) and "
                           f"len({val}) == {n}:")
            def chain(i, idx):
                if idx == n:
                    cont(i)
                    return
                el = self.em.tmp()
                self.em.w(i, f"{el} = {val}[{idx}]")
                self.pattern(t.items[idx], el, scope, i,
                             lambda j: chain(j, idx + 1))
            chain(ind + 1, 0)
            return
        if isinstance(t, A.ObjectLit):
            n = len(t.items)
            self.em.w(ind, f"if isinstance({val}, FrozenDict) and "
                           f"len({val}) == {n}:")
            items = list(t.items)

            def ochain(i, idx):
                if idx == n:
                    cont(i)
                    return
                k_t, v_t = items[idx]
                kx = self.value(k_t, scope, i)
                kv = self.em.tmp()
                self.em.w(i, f"{kv} = {kx}")
                self.em.w(i, f"if {kv} in {val}:")
                el = self.em.tmp()
                self.em.w(i + 1, f"{el} = {val}[{kv}]")
                self.pattern(v_t, el, scope, i + 1,
                             lambda j: ochain(j, idx + 1))
            ochain(ind + 1, 0)
            return
        # ground term: compare (final case of _unify_pattern)
        expr = self.value(t, scope, ind)
        self.em.w(ind, f"if rego_eq({expr}, {val}):")
        cont(ind + 1)

    # ------------------------------------------------------------- literals

    def solve(self, lits, i: int, scope: _Scope, ind: int, done) -> None:
        """Emit body literals [i:], then done(ind) at full success."""
        if i == len(lits):
            done(ind)
            return
        lit = lits[i]
        nxt = lambda j: self.solve(lits, i + 1, scope, j, done)
        if lit.withs:
            raise Unsupported("with modifier")
        expr = lit.expr
        hint = self._key_hints.get(id(lit))
        if hint is not None and not lit.negated:
            k_name, e_term = hint
            # the pin expression evaluates BEFORE (and regardless of)
            # the enumeration producing bindings, so it must be unable
            # to raise: a user-function call erroring here would
            # surface where the interpreter, evaluating the (possibly
            # empty) enumeration first, produces no violation at all
            if not scope.bound(k_name) and _hint_term_safe(e_term):
                try:
                    e_expr = self.value(e_term, scope, ind)
                except (_NotDeterministic, Unsupported):
                    e_expr = None
                if e_expr is not None:
                    te = self.em.tmp()
                    self.em.w(ind, f"{te} = {e_expr}")
                    self.em.w(ind, f"if {te} is not UNDEF:")
                    ind += 1
                    self._hint_bind[k_name] = te
        if lit.negated:
            self._emit_negation(expr, scope, ind, nxt)
            return
        if isinstance(expr, A.SomeDecl):
            for n in expr.names:
                scope.fresh.add(n)
                scope.names.pop(n, None)
            nxt(ind)
            return
        if isinstance(expr, (A.Assign, A.Unify)):
            self._emit_unify(expr, scope, ind, nxt)
            return
        # plain expression literal: succeeds per non-false value
        self.iter_emit(expr, scope, ind, lambda j, v: (
            self.em.w(j, f"if {v} is not False:"), nxt(j + 1)))

    def _emit_negation(self, expr, scope: _Scope, ind: int, nxt) -> None:
        fn = self.em.tmp()
        self.em.w(ind, f"def _ng{fn}():")
        sub = scope.child()
        body_ind = ind + 1
        wrote = len(self.em.lines)
        if isinstance(expr, (A.Assign, A.Unify)):
            # expression position: unify success -> exists
            self._emit_unify(expr, sub, body_ind,
                             lambda j: self.em.w(j, "return True"))
        else:
            self.iter_emit(expr, sub, body_ind, lambda j, v: (
                self.em.w(j, f"if {v} is not False:"),
                self.em.w(j + 1, "return True")))
        if len(self.em.lines) == wrote:
            self.em.w(body_ind, "pass")
        self.em.w(body_ind, "return False")
        self.em.w(ind, f"if not _ng{fn}():")
        nxt(ind + 1)

    def _emit_unify(self, expr, scope: _Scope, ind: int, nxt) -> None:
        assign = isinstance(expr, A.Assign)
        lhs, rhs = expr.lhs, expr.rhs
        lp = assign or self._is_static_pattern(lhs, scope)
        rp = (not assign) and self._is_static_pattern(rhs, scope)
        if lp and rp:
            raise Unsupported("unifying two non-ground terms")
        if lp:
            self.iter_emit(rhs, scope, ind, lambda i, v:
                           self.pattern(lhs, v, scope, i, nxt))
            return
        if rp:
            self.iter_emit(lhs, scope, ind, lambda i, v:
                           self.pattern(rhs, v, scope, i, nxt))
            return
        def both(i, a):
            self.iter_emit(rhs, scope, i, lambda j, b: (
                self.em.w(j, f"if rego_eq({a}, {b}):"), nxt(j + 1)))
        self.iter_emit(lhs, scope, ind, both)

    # ------------------------------------------------ input-path hoisting

    def _collect_input_paths(self, rules) -> list[tuple]:
        """All maximal static input.<scalars...> prefixes referenced by
        the given clauses (including inside comprehensions and negation),
        for hoisting to one _stepv chain at rule entry. The chains are
        pure and total (UNDEF propagates through _stepv), so evaluating
        them unconditionally preserves semantics exactly."""
        found: set = set()

        def ref(t) -> None:
            if isinstance(t.base, A.Var) and t.base.name == "input":
                pre = []
                for a in t.args:
                    if isinstance(a, A.Scalar) and isinstance(
                            a.value, (str, int, bool)):
                        pre.append(a.value)
                    else:
                        break
                if pre:
                    found.add(tuple(pre))
            walk(t.base)
            for a in t.args:
                walk(a)

        def walk(t) -> None:
            if isinstance(t, A.Ref):
                ref(t)
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
                for lit in t.body:
                    walk_lit(lit)
            elif isinstance(t, A.ObjectCompr):
                walk(t.key)
                walk(t.value)
                for lit in t.body:
                    walk_lit(lit)
            elif isinstance(t, (A.Assign, A.Unify)):
                walk(t.lhs)
                walk(t.rhs)

        def walk_lit(lit) -> None:
            if isinstance(lit.expr, A.SomeDecl):
                return
            walk(lit.expr)

        for r in rules:
            for lit in r.body:
                walk_lit(lit)
            for h in (r.key, r.value):
                if h is not None:
                    walk(h)
            for a in r.args:
                walk(a)
        # type-aware order: int and str segments may share a position
        return sorted(found, key=lambda p: [repr(s) for s in p])

    def _emit_path_cache(self, rules, ind: int) -> None:
        """Emit the hoisted _stepv chains. Maximal review-/parameters-
        rooted paths are additionally memoized in rmemo/pmemo — the
        audit fan-out calls the evaluator ~|constraints| times per
        review, so a per-review (resp. per-constraint) dict get replaces
        the whole chain on every call after the first."""
        self._path_cache = {}
        if self._sections:
            self._path_cache[("review",)] = "_J['rev']"
            self._path_cache[("parameters",)] = "_J['par']"
        for path in self._collect_input_paths(rules):
            if path in self._path_cache:
                continue
            memo = None
            if len(path) >= 2 and path[0] == "review":
                memo = "rmemo"
            elif len(path) >= 2 and path[0] == "parameters":
                memo = "pmemo"
            if memo is not None:
                t = self.em.tmp()
                key = ("p",) + path  # typed tuple: 1 and "1" stay distinct
                self.em.w(ind, f"{t} = _J[{memo!r}].get({key!r}, _MISS)")
                self.em.w(ind, f"if {t} is _MISS:")
                root = self._path_cache.get((path[0],), None)
                chain = (root if root is not None
                         else f"_stepv(_J['input'], {path[0]!r})")
                for seg in path[1:]:
                    chain = f"_stepv({chain}, {seg!r})"
                self.em.w(ind + 1, f"{t} = {chain}")
                self.em.w(ind + 1, f"_J[{memo!r}][{key!r}] = {t}")
                self._path_cache[path] = t
                continue
            for ln in range(1, len(path) + 1):
                pre = path[:ln]
                if pre in self._path_cache:
                    continue
                parent = ("_J['input']" if ln == 1
                          else self._path_cache[pre[:-1]])
                t = self.em.tmp()
                self.em.w(ind, f"{t} = _stepv({parent}, {pre[-1]!r})")
                self._path_cache[pre] = t

    def _cached_input_prefix(self, t: A.Ref, scope: _Scope):
        """(temp name, remaining args) when this ref starts with a
        hoisted static input path (longest cached prefix wins); None
        otherwise."""
        if self._path_cache is None or scope.bound("input"):
            return None
        if not (isinstance(t.base, A.Var) and t.base.name == "input"):
            return None
        run: list = []
        for a in t.args:
            if isinstance(a, A.Scalar) and isinstance(a.value,
                                                      (str, int, bool)):
                run.append(a.value)
            else:
                break
        for ln in range(len(run), 0, -1):
            hit = self._path_cache.get(tuple(run[:ln]))
            if hit is not None:
                return hit, list(t.args[ln:])
        return None

    # ----------------------------------------------------- join reorder

    def _names_unbound(self, t, bound: set) -> set:
        """Over-approximated new names a term could bind (every unbound
        non-root, non-rule, non-wildcard name appearing anywhere)."""
        allv: set = set()
        _term_vars(t, allv)
        return {v for v in allv
                if v not in bound and not v.startswith("$wc")
                and v not in ("input", "data") and v not in self.rules}

    def _expr_read_vars(self, t) -> set:
        allv: set = set()
        _term_vars(t, allv)
        builtin1 = {fn[0] for fn in BUILTINS}
        return {v for v in allv
                if not v.startswith("$wc") and v not in ("input", "data")
                and v not in self.rules and v not in builtin1}

    def _enum_key_var(self, lit, bound: set) -> Optional[str]:
        """Leftmost unbound non-wildcard Var bracket arg of the literal's
        generator ref — the candidate join key."""
        if lit.negated or lit.withs:
            return None
        e = lit.expr
        refs = []
        if isinstance(e, (A.Assign, A.Unify)):
            for side in (e.rhs, e.lhs):
                if isinstance(side, A.Ref):
                    refs.append(side)
        elif isinstance(e, A.Ref):
            refs.append(e)
        for r in refs:
            for a in r.args:
                if isinstance(a, A.Var) and not a.name.startswith("$wc") \
                        and a.name not in bound \
                        and a.name not in ("input", "data"):
                    return a.name
        return None

    def _movable_generator(self, lit, bound: set) -> Optional[set]:
        """EXACT bind set of a self-contained hoistable generator —
        Assign/Unify of a fresh var (or flat var tuple) against a Ref
        rooted at input/data whose bracket args are scalars, already-
        bound vars, wildcards, or fresh vars — else None."""
        if lit.negated or lit.withs:
            return None
        e = lit.expr
        if not isinstance(e, (A.Assign, A.Unify)):
            return None
        for pat, refside in ((e.lhs, e.rhs), (e.rhs, e.lhs)):
            if not isinstance(refside, A.Ref):
                continue
            base = refside.base
            if not (isinstance(base, A.Var) and base.name in ("input",
                                                              "data")):
                continue
            if isinstance(pat, A.Var):
                pv = [pat.name]
            elif isinstance(pat, A.ArrayLit) and \
                    all(isinstance(x, A.Var) for x in pat.items):
                pv = [x.name for x in pat.items]
            else:
                continue
            if any(n in bound for n in pv):
                continue
            binds = {n for n in pv if not n.startswith("$wc")}
            ok = True
            for a in refside.args:
                if isinstance(a, A.Scalar):
                    continue
                if isinstance(a, A.Var):
                    if a.name.startswith("$wc") or a.name in bound:
                        continue
                    binds.add(a.name)
                    continue
                ok = False
                break
            if ok:
                return binds
        return None

    def _schedule_body(self, lits, bound0=()) -> list:
        """Equality-driven join reorder (sideways information passing):
        when a generator enumerates base[k] only for a later equality to
        pin k to an expression E, hoist the one self-contained generator
        that makes E computable and mark the enumeration for conversion
        to a keyed lookup (_lookupk keeps enumeration-filter typing; the
        pin literal stays in place as a now-trivial check). The classic
        shape is the review-dict x parameters join

            value := input.review...labels[key]
            expected := input.parameters.labels[_]
            expected.key == key

        which drops from O(|labels| x |params|) iterations per pair to
        O(|params|) lookups. Solution sets are order-independent
        (conjunctive body), so the transform is semantics-preserving."""
        out = list(lits)
        bound: set = set(bound0)
        g = 0
        guard = 0
        while g < len(out):
            guard += 1
            if guard > 10 * len(out) + 10:
                return list(lits)  # paranoid: never loop forever
            lit = out[g]
            e = lit.expr
            if isinstance(e, A.SomeDecl):
                bound -= set(e.names)
                g += 1
                continue
            k = None
            if id(lit) not in self._key_hints:
                k = self._enum_key_var(lit, bound)
            if k is None:
                if not lit.negated:
                    bound |= self._names_unbound(e, bound)
                g += 1
                continue
            # find a pin: a later equality between Var(k) and a k-free E
            pin = None
            for j in range(g + 1, len(out)):
                lj = out[j]
                if lj.negated or lj.withs:
                    continue
                ej = lj.expr
                sides = None
                if isinstance(ej, A.BinOp) and ej.op == "==":
                    sides = (ej.lhs, ej.rhs)
                elif isinstance(ej, A.Unify):
                    sides = (ej.lhs, ej.rhs)
                if not sides:
                    continue
                for a, b in (sides, sides[::-1]):
                    if isinstance(a, A.Var) and a.name == k and \
                            k not in self._expr_read_vars(b):
                        pin = (j, b)
                        break
                if pin:
                    break
            if pin is None:
                bound |= self._names_unbound(e, bound)
                g += 1
                continue
            e_idx, E = pin
            need = self._expr_read_vars(E) - bound
            if not need:
                # E already computable here: mark the keyed lookup
                self._key_hints[id(lit)] = (k, E)
                self._hint_refs.append(lit)
                bound |= self._names_unbound(e, bound)
                g += 1
                continue
            # find ONE hoistable generator in (g, e_idx) covering `need`,
            # whose binds don't collide with anything in between
            moved = False
            for s in range(g + 1, e_idx):
                binds = self._movable_generator(out[s], bound)
                if binds is None or not need <= binds:
                    continue
                between_binds: set = set()
                for m in range(g, s):
                    if not out[m].negated and \
                            not isinstance(out[m].expr, A.SomeDecl):
                        between_binds |= self._names_unbound(
                            out[m].expr, bound)
                if binds & between_binds:
                    continue
                mv = out.pop(s)
                out.insert(g, mv)
                moved = True
                break
            if not moved:
                bound |= self._names_unbound(e, bound)
                g += 1
            # when moved: reprocess position g (now the hoisted
            # generator); the enumeration gets its hint on the revisit

        return out

    # ------------------------------------------------- head-witness memo

    def _scan_lit(self, lit, bound: set) -> dict:
        """Static facts about one body literal for the head-memo planner:
        ok     — var-only: no direct input/data/document-rule reads, no
                 non-arg-pure user calls (so its value is a pure function
                 of the variables it reads);
        enum   — needs loop emission (enumerates; can't sit in the
                 memoized suffix);
        reads  — already-bound vars it consumes;
        binds  — vars it binds (for the forward bound-set simulation).
        Conservative: anything unrecognized clears ok — the planner then
        simply declines to memoize, never miscompiles."""
        s = {"ok": True, "enum": False, "reads": set(), "binds": set()}
        if lit.withs:
            s["ok"] = False
            return s
        e = lit.expr
        if isinstance(e, A.SomeDecl):
            s["ok"] = False  # scope boundary; forward sim unbinds names
            return s

        def pat_vars(t, into: set) -> None:
            if isinstance(t, A.Var):
                into.add(t.name)
            elif isinstance(t, (A.ArrayLit, A.SetLit)):
                for i in t.items:
                    pat_vars(i, into)
            elif isinstance(t, A.ObjectLit):
                for _k, v in t.items:
                    pat_vars(v, into)
            elif isinstance(t, A.Ref):
                for a in t.args:
                    pat_vars(a, into)

        def val(t, local: frozenset, quiet: bool) -> None:
            # `quiet`: inside a deterministic sub-value (comprehension or
            # negation) whose internal enumeration doesn't make the
            # literal itself enumerate
            if not s["ok"]:
                return
            if isinstance(t, A.Scalar):
                return
            if isinstance(t, A.Var):
                n = t.name
                if n in local:
                    return
                if n in ("input", "data"):
                    s["ok"] = False
                    return
                if n in bound:
                    s["reads"].add(n)
                    return
                if n in self.rules:
                    s["ok"] = False  # document rule / fn value reference
                    return
                if quiet:
                    return  # locally-bound inside compr/negation
                s["enum"] = True
                if not n.startswith("$wc"):
                    s["binds"].add(n)
                return
            if isinstance(t, A.Ref):
                if isinstance(t.base, A.Var) and \
                        t.base.name in ("input", "data") and \
                        t.base.name not in local and t.base.name not in bound:
                    s["ok"] = False
                    return
                val(t.base, local, quiet)
                for a in t.args:
                    if isinstance(a, A.Var) and a.name not in local and \
                            a.name not in bound and \
                            a.name not in ("input", "data"):
                        if not quiet:
                            s["enum"] = True
                            if not a.name.startswith("$wc"):
                                s["binds"].add(a.name)
                        local = local | {a.name}
                        continue
                    pv: set = set()
                    pat_vars(a, pv)
                    unb = {v for v in pv if v not in local and v not in bound}
                    if unb and not isinstance(a, A.Var):
                        # static pattern bracket: enumerates + binds
                        if not quiet:
                            s["enum"] = True
                            s["binds"] |= {v for v in unb
                                           if not v.startswith("$wc")}
                        local = local | unb
                        continue
                    val(a, local, quiet)
                return
            if isinstance(t, A.Call):
                fn = tuple(t.fn)
                if len(fn) == 1 and fn[0] in self.rules:
                    if fn[0] not in self.arg_pure:
                        s["ok"] = False
                        return
                elif fn[0] == "data" or fn not in BUILTINS or \
                        fn in NONDETERMINISTIC:
                    s["ok"] = False
                    return
                for a in t.args:
                    val(a, local, quiet)
                return
            if isinstance(t, A.BinOp):
                val(t.lhs, local, quiet)
                val(t.rhs, local, quiet)
                return
            if isinstance(t, A.UnaryMinus):
                val(t.term, local, quiet)
                return
            if isinstance(t, (A.ArrayLit, A.SetLit)):
                for x in t.items:
                    val(x, local, quiet)
                return
            if isinstance(t, A.ObjectLit):
                for k, v in t.items:
                    val(k, local, quiet)
                    val(v, local, quiet)
                return
            if isinstance(t, (A.ArrayCompr, A.SetCompr, A.ObjectCompr)):
                # a comprehension is a deterministic value; its body may
                # enumerate internally over locally-bound vars
                lb: set = set()
                for l2 in t.body:
                    if l2.withs:
                        s["ok"] = False
                        return
                    e2 = l2.expr
                    if isinstance(e2, A.SomeDecl):
                        lb.update(e2.names)
                        continue
                    if isinstance(e2, (A.Assign, A.Unify)):
                        pat_vars(e2.lhs, lb)
                        pat_vars(e2.rhs, lb)
                    else:
                        pat_vars(e2, lb)
                lb -= bound  # outer-bound names are reads, not locals
                inner = local | frozenset(lb)
                for l2 in t.body:
                    e2 = l2.expr
                    if isinstance(e2, A.SomeDecl):
                        continue
                    if isinstance(e2, (A.Assign, A.Unify)):
                        val(e2.lhs, inner, True)
                        val(e2.rhs, inner, True)
                    else:
                        val(e2, inner, True)
                for h in (getattr(t, "head", None), getattr(t, "key", None),
                          getattr(t, "value", None)):
                    if h is not None:
                        val(h, inner, True)
                return
            s["ok"] = False

        if lit.negated:
            # negation exports no bindings and is deterministic overall
            if isinstance(e, (A.Assign, A.Unify)):
                val(e.lhs, frozenset(), True)
                val(e.rhs, frozenset(), True)
            else:
                val(e, frozenset(), True)
            s["binds"] = set()
            return s

        def complete_binds() -> None:
            # the forward bound-set simulation must never UNDER-report
            # binds (a var the emitter binds but the simulation missed
            # could silently drop out of a memo key). Over-reporting is
            # safe: it only widens the key or trips the emission
            # fallback. So fold in every previously-unbound name
            # appearing anywhere in the literal.
            allv: set = set()
            _term_vars(e, allv)
            s["binds"] |= {v for v in allv
                           if v not in bound and not v.startswith("$wc")
                           and v not in ("input", "data")
                           and v not in self.rules}
        if isinstance(e, (A.Assign, A.Unify)):
            lv: set = set()
            pat_vars(e.lhs, lv)
            rv: set = set()
            pat_vars(e.rhs, rv)
            lhs_unb = {v for v in lv if v not in bound}
            rhs_unb = {v for v in rv if v not in bound}
            if isinstance(e, A.Assign) or not lhs_unb or not rhs_unb:
                patside, valside = (e.lhs, e.rhs)
                if not isinstance(e, A.Assign) and rhs_unb and not lhs_unb:
                    patside, valside = (e.rhs, e.lhs)
                val(valside, frozenset(), False)
                pv: set = set()
                pat_vars(patside, pv)
                unb = {v for v in pv if v not in bound}
                if isinstance(patside, A.Var) or not unb:
                    # plain binder (or ground-ground compare): deterministic
                    s["binds"] |= {v for v in unb if not v.startswith("$wc")}
                    s["reads"] |= pv & bound
                    if not isinstance(patside, A.Var):
                        val(patside, frozenset(unb), False)
                else:
                    # destructuring pattern: conservative, exclude
                    s["ok"] = False
            else:
                s["ok"] = False  # two non-ground sides
            complete_binds()
            return s
        val(e, frozenset(), False)
        complete_binds()
        return s

    def _head_memo_plan(self, body_lits, head_key):
        """Plan the head-witness memo for a partial-set rule: find the
        maximal suffix of body literals that is deterministic and
        var-only (see _scan_lit), so (suffix + head) is a pure function
        of the outer vars V flowing into it. The emitted code then keys
        (suffix+head) outputs on V's values in a cross-review,
        cross-constraint memo — the audit fan-out materializes each
        distinct witness once. Returns (cut_index, V_sorted) or None."""
        body = list(body_lits)
        if not body:
            return None
        bound: set = set()
        scans = []
        for lit in body:
            sc = self._scan_lit(lit, bound)
            scans.append(sc)
            e = lit.expr
            if isinstance(e, A.SomeDecl):
                bound -= set(e.names)
            else:
                bound |= sc["binds"]
        head_sc = self._scan_lit(
            A.Literal(expr=head_key, negated=False, withs=()), bound)
        if not head_sc["ok"] or head_sc["enum"]:
            return None
        cut = len(body)
        while cut > 0 and scans[cut - 1]["ok"] and not scans[cut - 1]["enum"]:
            cut -= 1
        if cut >= len(body):
            return None  # no usable suffix
        suffix_binds: set = set()
        reads: set = set(head_sc["reads"])
        for sc in scans[cut:]:
            reads |= sc["reads"]
            suffix_binds |= sc["binds"]
        v = sorted(reads - suffix_binds)
        if len(v) > 6:
            return None  # wide key: unlikely to collapse, skip
        return cut, v

    # --------------------------------------------------------------- rules

    def _emit_rule(self, name: str) -> None:
        rules = self.rules[name]
        kind = rules[0].kind
        if kind == "function":
            self._emit_function(name, rules)
            return
        self.em.w(0, f"def rule_{name}(_J):")
        self.em.w(1, "_m = _J['memo']")
        self.em.w(1, f"if {name!r} in _m: return _m[{name!r}]")
        self._emit_path_cache(rules, 1)
        if kind == "complete":
            self.em.w(1, "_outs = []")
            default_expr = "UNDEF"
            for r in rules:
                scope = _Scope()
                if r.is_default:
                    default_expr = self.value(
                        r.value if r.value is not None else A.Scalar(True),
                        scope, 1)
                    continue
                val_t = r.value if r.value is not None else A.Scalar(True)

                def acc(i, v):
                    self.em.w(i, f"if not any(rego_eq({v}, _o) "
                                 f"for _o in _outs): _outs.append({v})")
                self.solve(self._schedule_body(r.body), 0, scope, 1,
                           lambda i, _v=val_t, _s=scope: self.iter_emit(
                               _v, _s, i, acc))
            self.em.w(1, "if len(_outs) > 1: raise RegoError("
                         f"'complete rule {name}: multiple outputs')")
            self.em.w(1, f"_r = _outs[0] if _outs else {default_expr}")
        elif kind == "partial_set":
            self.em.w(1, "_acc = set()")
            for r in rules:
                scope = _Scope()
                body = self._schedule_body(r.body)
                plan = self._head_memo_plan(body, r.key)
                if plan is None:
                    self.solve(body, 0, scope, 1,
                               lambda i, _k=r.key, _s=scope: self.iter_emit(
                                   _k, _s, i,
                                   lambda j, v: self.em.w(j,
                                                          f"_acc.add({v})")))
                    continue
                cut, v_names = plan
                slot = self._hmemo_n
                self._hmemo_n += 1

                def suffix(i, _r=r, _s=scope, _cut=cut, _b=body):
                    self.solve(list(_b[_cut:]), 0, _s, i,
                               lambda j: self.iter_emit(
                                   _r.key, _s, j,
                                   lambda l, v: self.em.w(
                                       l, f"_hacc.append({v})")))

                def mid(i, _r=r, _s=scope, _cut=cut, _V=v_names, _sl=slot,
                        _suffix=suffix, _b=body):
                    pys = [_s.names.get(v) for v in _V]
                    if any(p is None for p in pys):
                        # planner/emitter scope mismatch: emit unmemoized
                        self.solve(list(_b[_cut:]), 0, _s, i,
                                   lambda j: self.iter_emit(
                                       _r.key, _s, j,
                                       lambda l, v: self.em.w(
                                           l, f"_acc.add({v})")))
                        return
                    hk = self.em.tmp()
                    hv = self.em.tmp()
                    key = ", ".join([str(_sl)] + pys)
                    self.em.w(i, f"{hk} = ({key},)")
                    self.em.w(i, f"{hv} = _J['hmemo'].get({hk}, _MISS)")
                    self.em.w(i, f"if {hv} is _MISS:")
                    self.em.w(i + 1, "_hacc = []")
                    _suffix(i + 1)
                    self.em.w(i + 1, f"{hv} = tuple(_hacc)")
                    self.em.w(i + 1, f"_J['hmemo'][{hk}] = {hv}")
                    fx = self.em.tmp()
                    self.em.w(i, f"for {fx} in {hv}: _acc.add({fx})")

                self.solve(list(body[:cut]), 0, scope, 1, mid)
            self.em.w(1, "_r = frozenset(_acc)")
        elif kind == "partial_object":
            self.em.w(1, "_accd = {}")
            for r in rules:
                scope = _Scope()

                def put(i, _r=r, _s=None):
                    s = _s

                    def kcont(j, kv):
                        def vcont(l, vv):
                            self.em.w(l, f"if {kv} in _accd and not "
                                         f"rego_eq(_accd[{kv}], {vv}):")
                            self.em.w(l + 1, "raise RegoError("
                                      f"'object rule {name}: conflict')")
                            self.em.w(l, f"_accd[{kv}] = {vv}")
                        self.iter_emit(_r.value, s, j, vcont)
                    self.iter_emit(_r.key, s, i, kcont)
                self.solve(self._schedule_body(r.body), 0, scope, 1,
                           lambda i, _r=r, _s=scope: put(i, _r, _s))
            self.em.w(1, "_r = FrozenDict(_accd)")
        else:
            raise Unsupported(f"rule kind {kind}")
        self.em.w(1, f"_m[{name!r}] = _r")
        self.em.w(1, "return _r")
        self.em.w(0, "")
        self._path_cache = None

    def _emit_function(self, name: str, rules) -> None:
        arity = len(rules[0].args)
        formals = [f"_a{i}" for i in range(arity)]
        self.em.w(0, f"def fn_{name}(_J, {', '.join(formals)}):")
        argnames: set = set()
        for r in rules:
            for a in r.args:
                _collect_arg_vars(a, argnames)
        if "input" in argnames:
            self._path_cache = None  # shadowed: skip hoisting
        else:
            self._emit_path_cache(rules, 1)
        memo = name in self.arg_pure
        if memo:
            self.em.w(1, f"_mk = ({name!r}, {', '.join(formals)})")
            self.em.w(1, "try:")
            self.em.w(2, "_mv = _J['fmemo'].get(_mk, _MISS)")
            self.em.w(1, "except TypeError:")  # unhashable arg: skip memo
            self.em.w(2, "_mk = None")
            self.em.w(2, "_mv = _MISS")
            self.em.w(1, "if _mv is not _MISS: return _mv")
        self.em.w(1, "_outs = []")
        for r in rules:
            if len(r.args) != arity:
                raise Unsupported(f"function {name}: mixed arity")
            scope = _Scope()
            val_t = r.value if r.value is not None else A.Scalar(True)

            def acc(i, v):
                self.em.w(i, f"if not any(rego_eq({v}, _o) "
                             f"for _o in _outs): _outs.append({v})")

            argv: set = set()
            for a in r.args:
                _collect_arg_vars(a, argv)

            def body(i, _r=r, _s=scope, _v=val_t, _argv=argv):
                self.solve(self._schedule_body(_r.body, _argv), 0, _s, i,
                           lambda j: self.iter_emit(_v, _s, j, acc))

            def chain(i, idx, _r=r, _s=scope, _body=body):
                if idx == arity:
                    _body(i)
                    return
                self.pattern(_r.args[idx], formals[idx], _s, i,
                             lambda j: chain(j, idx + 1, _r, _s, _body))
            chain(1, 0)
        self.em.w(1, f"if len(_outs) > 1: raise RegoError("
                     f"'function {name}: conflicting outputs')")
        if memo:
            self.em.w(1, "_mv = _outs[0] if _outs else UNDEF")
            self.em.w(1, "if _mk is not None: _J['fmemo'][_mk] = _mv")
            self.em.w(1, "return _mv")
        else:
            self.em.w(1, "return _outs[0] if _outs else UNDEF")
        self.em.w(0, "")
        self._path_cache = None

    # ----------------------------------------------------------- top level

    def compile(self, entry: str = "violation") -> Callable[[Any, Any], Any]:
        if entry not in self.rules:
            raise Unsupported(f"no {entry} rule")
        for name in self.rules:
            self._emit_rule(name)
        for name in sorted(self.const_rules):
            # fold: evaluate once at module build, rebind to a closure
            self.em.w(0, f"_const_{name} = rule_{name}({{'memo': {{}}}})")
            self.em.w(0, f"def rule_{name}(_J, _v=_const_{name}):")
            self.em.w(1, "return _v")
            self.em.w(0, "")
        if self._sections:
            # sections mode: review/parameters come in as direct args —
            # callers skip the per-call input-wrapper construction
            self.em.w(0, "def __evaluate__(_rev, _par, _inv, _rmemo=None, "
                         "_fmemo=None, _pmemo=None, _hmemo=None):")
            self.em.w(1, "_J = {'rev': _rev, 'par': _par, 'inv': _inv, "
                         "'memo': {}, "
                         "'rmemo': _rmemo if _rmemo is not None else {}, "
                         "'fmemo': _fmemo if _fmemo is not None else {}, "
                         "'pmemo': _pmemo if _pmemo is not None else {}, "
                         "'hmemo': _hmemo if _hmemo is not None else {}}")
        else:
            self.em.w(0, "def __evaluate__(_input, _inv, _rmemo=None, "
                         "_fmemo=None, _pmemo=None, _hmemo=None):")
            self.em.w(1, "_J = {'input': _input, 'inv': _inv, 'memo': {}, "
                         "'rmemo': _rmemo if _rmemo is not None else {}, "
                         "'fmemo': _fmemo if _fmemo is not None else {}, "
                         "'pmemo': _pmemo if _pmemo is not None else {}, "
                         "'hmemo': _hmemo if _hmemo is not None else {}}")
        if self.rules[entry][0].kind == "function":
            raise Unsupported(f"{entry} is a function")
        self.em.w(1, f"return rule_{entry}(_J)")

        params = ["UNDEF", "FrozenDict", "RegoError", "rego_eq", "_enum",
                  "_stepv", "_lookupk", "_call", "_callu", "_bin", "_neg",
                  "_arr", "_setl", "_obj", "_MISS"]
        bparams = list(self.builtin_bindings.values())
        cparams = list(self.bin_bindings.values())
        src = (f"def __make__({', '.join(params + bparams + cparams)}):\n"
               + "\n".join("    " + l for l in self.em.lines)
               + "\n    return __evaluate__\n")
        g: dict = {}
        exec(compile(src, f"<codegen:{'.'.join(self.module.package)}>",
                     "exec"), g)
        bvals = [BUILTINS[fn] for fn in self.builtin_bindings]
        cvals = [_BIN_SPECIAL[op] for op in self.bin_bindings]
        fn = g["__make__"](UNDEF, FrozenDict, RegoError, rego_eq, _enum,
                           _stepv, _lookupk, _call, _callu, _bin, _neg,
                           _arr, _setl, _obj, _MISS, *bvals, *cvals)
        fn.__source__ = src  # for debugging
        fn.__sections__ = self._sections
        if self._sections:
            def input_call(_input, _inv, *memos, _fn=fn):
                return _fn(_stepv(_input, "review"),
                           _stepv(_input, "parameters"), _inv, *memos)
            fn.__input_call__ = input_call
        else:
            fn.__input_call__ = fn
        return fn


def compile_module(module: A.Module,
                   entry: str = "violation") -> Callable[[Any, Any], Any]:
    """Compile a (merged, single-package) template module to a Python
    evaluator fn(input_frozen, inventory_frozen) -> frozen document of
    `entry`. Raises Unsupported when the module falls outside the
    compilable subset."""
    return ModuleCompiler(module).compile(entry)
