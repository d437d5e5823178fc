"""Tree-walking reference interpreter for the Rego subset.

This is the framework's semantic oracle and fallback driver — the analog of
the reference's vendored OPA topdown evaluator
(vendor/github.com/open-policy-agent/opa/topdown, ~12k LoC Go). The
vectorizing TPU compiler (ir/) is validated against it, and templates whose
Rego falls outside the vectorizable subset run here.

Evaluation model: generator-based top-down query evaluation with
backtracking. Bindings live in per-rule-scope dicts and are undone through a
trail (mark/undo), so generators can yield mid-solution. Semantics mirrored
from OPA:

  * undefined vs false tri-state: only `false` and undefined fail a body
    literal; 0, "", [] and {} are truthy.
  * `not e` succeeds when e is undefined or false; bindings never escape.
  * unification literals succeed on successful unification regardless of the
    unified value's truthiness (e.g. `good = startswith(img, repo)` binds
    good=false and succeeds — library/general/allowedrepos/src.rego).
  * builtin errors make expressions undefined (non-strict mode).
  * complete/function rules with multiple clauses must agree on the output
    (conflict error otherwise); partial rules union their outputs.
  * refs with unbound bracket vars enumerate (objects by key, arrays by
    index, sets by member, `data` by tree children including virtual docs).
  * `with input as X` / `with data.p as X` scoped overrides, including
    cache isolation (used by src_test.rego suites and the target matcher's
    matching_reviews_and_constraints).
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

from ..utils.values import FrozenDict, freeze, rego_eq, sort_key
from . import ast as A
from .builtins import BUILTINS, BuiltinError
from .safety import reorder_module


class RegoError(Exception):
    """Evaluation error (conflict, unsafe var, recursion limit...)."""


class _Undef:
    __slots__ = ()

    def __repr__(self):
        return "<undefined>"


UNDEF = _Undef()

class _Fresh:
    __slots__ = ()


FRESH = _Fresh()  # marks `some`-declared locals as explicitly unbound

_MISSING = object()
_MAX_DEPTH = 200


class DataNode:
    """Cursor into the data document = base data tree + mounted packages."""

    __slots__ = ("path", "base")

    def __init__(self, path: tuple, base: Any):
        self.path = path
        self.base = base  # plain dict tree / frozen value / _MISSING


class Ctx:
    __slots__ = (
        "interp",
        "input_stack",
        "data_overrides",
        "pkg_stack",
        "trail",
        "cache",
        "frame",
        "next_frame",
        "depth",
    )

    def __init__(self, interp: "Interpreter", input_value: Any):
        self.interp = interp
        self.input_stack = [input_value]
        self.data_overrides: list[dict[tuple, Any]] = [{}]
        self.pkg_stack: list[tuple] = []
        self.trail: list = []
        self.cache: dict = {}
        self.frame = 0
        self.next_frame = 1
        self.depth = 0

    @property
    def input(self):
        return self.input_stack[-1]

    def mark(self) -> int:
        return len(self.trail)

    def bind(self, env: dict, name: str, value: Any):
        old = env.get(name, _MISSING)
        self.trail.append((env, name, old))
        env[name] = value

    def undo(self, mark: int):
        t = self.trail
        while len(t) > mark:
            env, name, old = t.pop()
            if old is _MISSING:
                env.pop(name, None)
            else:
                env[name] = old


def _is_unbound(env: dict, name: str) -> bool:
    v = env.get(name, _MISSING)
    return v is _MISSING or v is FRESH


class Interpreter:
    def __init__(self, modules: Optional[dict[str, A.Module]] = None,
                 data: Optional[dict] = None):
        # modules keyed by an owner id so the Client can replace/remove them
        self.modules: dict[str, A.Module] = {}
        self.data = data if data is not None else {}
        self.packages: dict[tuple, dict[str, list[A.Rule]]] = {}
        self._pkg_prefixes: set[tuple] = set()
        if modules:
            for k, m in modules.items():
                self.modules[k] = reorder_module(m)
            self._reindex()

    # ------------------------------------------------------------ modules

    def put_module(self, name: str, module: A.Module):
        self.modules[name] = reorder_module(module)
        self._reindex()

    def delete_module(self, name: str):
        self.modules.pop(name, None)
        self._reindex()

    def _reindex(self):
        self.packages = {}
        self._pkg_prefixes = set()
        for m in self.modules.values():
            pkg = self.packages.setdefault(m.package, {})
            for r in m.rules:
                pkg.setdefault(r.name, []).append(r)
            for i in range(1, len(m.package) + 1):
                self._pkg_prefixes.add(m.package[:i])

    # ------------------------------------------------------------ data API

    def put_data(self, path: tuple, value: Any):
        """Install a frozen copy of `value` at `path` in base data."""
        node = self.data
        for seg in path[:-1]:
            nxt = node.get(seg)
            if not isinstance(nxt, dict):
                nxt = {}
                node[seg] = nxt
            node = nxt
        node[path[-1]] = freeze(value)

    def delete_data(self, path: tuple) -> bool:
        node = self.data
        for seg in path[:-1]:
            node = node.get(seg)
            if not isinstance(node, dict):
                return False
        return node.pop(path[-1], _MISSING) is not _MISSING

    def get_data(self, path: tuple):
        node: Any = self.data
        for seg in path:
            if isinstance(node, dict):
                node = node.get(seg, _MISSING)
            elif isinstance(node, FrozenDict):
                node = node.get(seg, _MISSING)
            else:
                return UNDEF
            if node is _MISSING:
                return UNDEF
        return node

    # ------------------------------------------------------------ queries

    def eval_rule(self, pkg: tuple, name: str, input_value: Any = None,
                  overrides: Optional[dict] = None):
        """Evaluate a rule to its document. Returns a frozen value or UNDEF.

        `overrides` mounts values into the data document for the duration of
        the query, keyed by path tuple — the driver uses it to bind
        `data.inventory` the way the reference hook does with
        `with data.inventory as inv` (regolib/src.go:30-31)."""
        ctx = Ctx(self, freeze(input_value))
        if overrides:
            ctx.data_overrides[0] = {
                tuple(path): freeze(v) for path, v in overrides.items()
            }
        return self._rule_value(pkg, name, ctx)

    def run_tests(self, pkg: tuple) -> dict[str, bool]:
        """Run all test_* rules of a package (the opa-test analog used for
        conformance against the reference's src_test.rego suites)."""
        out = {}
        rules = self.packages.get(pkg, {})
        for name in rules:
            if name.startswith("test_"):
                ctx = Ctx(self, None)
                v = self._rule_value(pkg, name, ctx)
                out[name] = v is not UNDEF and v is not False
        return out

    # ------------------------------------------------------------ rules

    def _rules(self, pkg: tuple, name: str) -> Optional[list]:
        return self.packages.get(pkg, {}).get(name)

    def _rule_value(self, pkg: tuple, name: str, ctx: Ctx):
        key = (pkg, name, ctx.frame)
        if key in ctx.cache:
            return ctx.cache[key]
        rules = self._rules(pkg, name)
        if not rules:
            return UNDEF
        kind = rules[0].kind
        ctx.depth += 1
        if ctx.depth > _MAX_DEPTH:
            raise RegoError(f"max eval depth exceeded in {'.'.join(pkg)}.{name}")
        ctx.pkg_stack.append(pkg)
        try:
            if kind == "complete":
                result = self._eval_complete(rules, ctx)
            elif kind == "partial_set":
                acc = set()
                for r in rules:
                    env: dict = {}
                    mark = ctx.mark()
                    try:
                        for _ in self._solve(r.body, 0, env, ctx):
                            for kv in self._iter_term(r.key, env, ctx):
                                acc.add(kv)
                    finally:
                        ctx.undo(mark)
                result = frozenset(acc)
            elif kind == "partial_object":
                obj: dict = {}
                for r in rules:
                    env = {}
                    mark = ctx.mark()
                    try:
                        for _ in self._solve(r.body, 0, env, ctx):
                            for kv in self._iter_term(r.key, env, ctx):
                                for vv in self._iter_term(r.value, env, ctx):
                                    if kv in obj and not rego_eq(obj[kv], vv):
                                        raise RegoError(
                                            f"object rule {name}: conflicting values for key {kv!r}"
                                        )
                                    obj[kv] = vv
                    finally:
                        ctx.undo(mark)
                result = FrozenDict(obj)
            else:
                raise RegoError(f"{'.'.join(pkg)}.{name} is a function, not a document")
        finally:
            ctx.pkg_stack.pop()
            ctx.depth -= 1
        ctx.cache[key] = result
        return result

    def _eval_complete(self, rules: list, ctx: Ctx):
        outputs: list = []
        default_val = UNDEF
        for r in rules:
            if r.is_default:
                env: dict = {}
                for v in self._iter_term(r.value, env, ctx):
                    default_val = v
                continue
            env = {}
            mark = ctx.mark()
            try:
                for _ in self._solve(r.body, 0, env, ctx):
                    for v in self._iter_term(r.value, env, ctx):
                        if not any(rego_eq(v, o) for o in outputs):
                            outputs.append(v)
            finally:
                ctx.undo(mark)
        if len(outputs) > 1:
            raise RegoError(
                f"complete rule {rules[0].name}: produced multiple outputs {outputs!r}"
            )
        if outputs:
            return outputs[0]
        return default_val

    def _call_function(self, pkg: tuple, name: str, argvals: tuple, ctx: Ctx):
        rules = self._rules(pkg, name)
        if not rules:
            return UNDEF
        outputs: list = []
        ctx.depth += 1
        if ctx.depth > _MAX_DEPTH:
            raise RegoError(f"max eval depth exceeded calling {name}")
        ctx.pkg_stack.append(pkg)
        try:
            for r in rules:
                if len(r.args) != len(argvals):
                    continue
                env: dict = {}
                mark = ctx.mark()
                try:
                    if not self._unify_pattern_all(r.args, argvals, env, ctx):
                        continue
                    for _ in self._solve(r.body, 0, env, ctx):
                        for v in self._iter_term(r.value, env, ctx):
                            if not any(rego_eq(v, o) for o in outputs):
                                outputs.append(v)
                finally:
                    ctx.undo(mark)
        finally:
            ctx.pkg_stack.pop()
            ctx.depth -= 1
        if len(outputs) > 1:
            raise RegoError(f"function {name}: conflicting outputs {outputs!r}")
        return outputs[0] if outputs else UNDEF

    # ------------------------------------------------------------ body solving

    def _solve(self, lits: tuple, i: int, env: dict, ctx: Ctx) -> Iterator[None]:
        if i == len(lits):
            yield
            return
        for _ in self._solve_literal(lits[i], env, ctx):
            yield from self._solve(lits, i + 1, env, ctx)

    def _solve_literal(self, lit: A.Literal, env: dict, ctx: Ctx) -> Iterator[None]:
        if lit.withs:
            # The override must cover ONLY this literal's evaluation. A lazy
            # `yield from` would leave the override active while subsequent
            # literals run (generator suspended inside the with scope), so
            # solutions are materialized eagerly — state restored — then
            # their bindings replayed.
            saved_frame = ctx.frame
            pushed_input = 0
            pushed_data = 0
            mark = ctx.mark()
            solutions: list[dict] = []
            try:
                for w in lit.withs:
                    vals = list(self._iter_term(w.value, env, ctx))
                    if not vals:
                        return  # override value undefined => literal undefined
                    if w.target == ("input",) or (
                        len(w.target) > 1 and w.target[0] == "input"
                    ):
                        if w.target == ("input",):
                            ctx.input_stack.append(vals[0])
                        else:
                            base = ctx.input
                            ctx.input_stack.append(
                                _set_in(base, w.target[1:], vals[0])
                            )
                        pushed_input += 1
                    elif w.target[0] == "data":
                        ov = dict(ctx.data_overrides[-1])
                        ov[tuple(w.target[1:])] = vals[0]
                        ctx.data_overrides.append(ov)
                        pushed_data += 1
                    else:
                        raise RegoError(f"with target {w.target!r} unsupported")
                ctx.frame = ctx.next_frame
                ctx.next_frame += 1
                for _ in self._solve_literal(
                    A.Literal(expr=lit.expr, negated=lit.negated, line=lit.line),
                    env,
                    ctx,
                ):
                    solutions.append(dict(env))
            finally:
                ctx.undo(mark)
                ctx.frame = saved_frame
                for _ in range(pushed_input):
                    ctx.input_stack.pop()
                for _ in range(pushed_data):
                    ctx.data_overrides.pop()
            for snap in solutions:
                mark2 = ctx.mark()
                try:
                    for k, v in snap.items():
                        if k not in env or env[k] is not v:
                            ctx.bind(env, k, v)
                    yield
                finally:
                    ctx.undo(mark2)
            return

        expr = lit.expr
        if lit.negated:
            mark = ctx.mark()
            found = False
            try:
                for v in self._iter_expr(expr, env, ctx):
                    if v is not False:
                        found = True
                        break
            finally:
                ctx.undo(mark)
            if not found:
                yield
            return

        if isinstance(expr, A.SomeDecl):
            mark = ctx.mark()
            try:
                for n in expr.names:
                    ctx.bind(env, n, FRESH)
                yield
            finally:
                ctx.undo(mark)
            return

        if isinstance(expr, (A.Assign, A.Unify)):
            yield from self._solve_unify(
                expr.lhs, expr.rhs, env, ctx, assign=isinstance(expr, A.Assign)
            )
            return

        # plain expression literal: succeeds per binding with non-false value
        for v in self._iter_expr(expr, env, ctx):
            if v is not False:
                yield

    # ------------------------------------------------------------ unification

    def _solve_unify(
        self, lhs, rhs, env: dict, ctx: Ctx, assign: bool = False
    ) -> Iterator[None]:
        # `:=` always treats the lhs as a binding pattern — this is what lets
        # the reference's src_test.rego files shadow `input` with a local
        # (`input := {...}; ... with input as input`).
        lp = assign or self._is_pattern(lhs, env)
        rp = False if assign else self._is_pattern(rhs, env)
        if lp and not rp:
            for v in self._iter_term(rhs, env, ctx):
                mark = ctx.mark()
                try:
                    if self._unify_pattern(lhs, v, env, ctx):
                        yield
                finally:
                    ctx.undo(mark)
            return
        if rp and not lp:
            for v in self._iter_term(lhs, env, ctx):
                mark = ctx.mark()
                try:
                    if self._unify_pattern(rhs, v, env, ctx):
                        yield
                finally:
                    ctx.undo(mark)
            return
        if lp and rp:
            raise RegoError("cannot unify two non-ground terms")
        for a in self._iter_term(lhs, env, ctx):
            for b in self._iter_term(rhs, env, ctx):
                if rego_eq(a, b):
                    yield

    def _is_pattern(self, t, env: dict) -> bool:
        """True if t contains unbound vars bindable by pattern unification."""
        if isinstance(t, A.Var):
            if t.name in ("input", "data") and _is_unbound(env, t.name):
                return False
            return _is_unbound(env, t.name)
        if isinstance(t, A.ArrayLit):
            return any(self._is_pattern(x, env) for x in t.items)
        if isinstance(t, A.ObjectLit):
            return any(self._is_pattern(v, env) for _, v in t.items)
        return False

    def _unify_pattern(self, t, value, env: dict, ctx: Ctx) -> bool:
        if isinstance(t, A.Var):
            if _is_unbound(env, t.name):
                if not t.name.startswith("$wc"):
                    ctx.bind(env, t.name, value)
                return True
            return rego_eq(env[t.name], value)
        if isinstance(t, A.ArrayLit):
            if not isinstance(value, tuple) or len(value) != len(t.items):
                return False
            return all(
                self._unify_pattern(x, v, env, ctx)
                for x, v in zip(t.items, value)
            )
        if isinstance(t, A.ObjectLit):
            if not isinstance(value, FrozenDict) or len(value) != len(t.items):
                return False
            for k_t, v_t in t.items:
                ks = list(self._iter_term(k_t, env, ctx))
                if len(ks) != 1:
                    return False
                if ks[0] not in value:
                    return False
                if not self._unify_pattern(v_t, value[ks[0]], env, ctx):
                    return False
            return True
        for v in self._iter_term(t, env, ctx):
            return rego_eq(v, value)
        return False

    def _unify_pattern_all(self, terms, values, env: dict, ctx: Ctx) -> bool:
        return all(
            self._unify_pattern(t, v, env, ctx) for t, v in zip(terms, values)
        )

    # ------------------------------------------------------------ expressions

    def _iter_expr(self, expr, env: dict, ctx: Ctx) -> Iterator[Any]:
        if isinstance(expr, (A.Assign, A.Unify)):
            # expression position (e.g. inside `not`): succeed -> true
            for _ in self._solve_unify(expr.lhs, expr.rhs, env, ctx):
                yield True
            return
        yield from self._iter_term(expr, env, ctx)

    # ------------------------------------------------------------ terms

    def _iter_term(self, t, env: dict, ctx: Ctx) -> Iterator[Any]:
        if isinstance(t, A.Scalar):
            yield t.value
            return
        if isinstance(t, A.Var):
            yield from self._iter_var(t.name, env, ctx)
            return
        if isinstance(t, A.Ref):
            for base in self._iter_term(t.base, env, ctx):
                yield from self._walk_ref(base, t.args, 0, env, ctx)
            return
        if isinstance(t, A.Call):
            yield from self._iter_call(t, env, ctx)
            return
        if isinstance(t, A.BinOp):
            for a in self._iter_term(t.lhs, env, ctx):
                for b in self._iter_term(t.rhs, env, ctx):
                    v = _binop(t.op, a, b)
                    if v is not UNDEF:
                        yield v
            return
        if isinstance(t, A.UnaryMinus):
            for v in self._iter_term(t.term, env, ctx):
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    yield -v
            return
        if isinstance(t, A.ArrayLit):
            yield from self._iter_product(t.items, env, ctx, tuple)
            return
        if isinstance(t, A.SetLit):
            yield from self._iter_product(t.items, env, ctx, frozenset)
            return
        if isinstance(t, A.ObjectLit):
            keys = [k for k, _ in t.items]
            vals = [v for _, v in t.items]
            for kvs in self._iter_product(keys + vals, env, ctx, tuple):
                n = len(keys)
                yield FrozenDict(zip(kvs[:n], kvs[n:]))
            return
        if isinstance(t, A.ArrayCompr):
            out = []
            cenv = dict(env)
            mark = ctx.mark()
            try:
                for _ in self._solve(t.body, 0, cenv, ctx):
                    for v in self._iter_term(t.head, cenv, ctx):
                        out.append(v)
            finally:
                ctx.undo(mark)
            yield tuple(out)
            return
        if isinstance(t, A.SetCompr):
            acc = set()
            cenv = dict(env)
            mark = ctx.mark()
            try:
                for _ in self._solve(t.body, 0, cenv, ctx):
                    for v in self._iter_term(t.head, cenv, ctx):
                        acc.add(v)
            finally:
                ctx.undo(mark)
            yield frozenset(acc)
            return
        if isinstance(t, A.ObjectCompr):
            obj: dict = {}
            cenv = dict(env)
            mark = ctx.mark()
            try:
                for _ in self._solve(t.body, 0, cenv, ctx):
                    for k in self._iter_term(t.key, cenv, ctx):
                        for v in self._iter_term(t.value, cenv, ctx):
                            if k in obj and not rego_eq(obj[k], v):
                                raise RegoError(
                                    f"object comprehension: conflicting key {k!r}"
                                )
                            obj[k] = v
            finally:
                ctx.undo(mark)
            yield FrozenDict(obj)
            return
        raise RegoError(f"cannot evaluate term {t!r}")

    def _iter_product(self, terms, env, ctx, ctor) -> Iterator[Any]:
        vals: list = []

        def rec(i):
            if i == len(terms):
                yield ctor(vals)
                return
            for v in self._iter_term(terms[i], env, ctx):
                vals.append(v)
                try:
                    yield from rec(i + 1)
                finally:
                    vals.pop()

        yield from rec(0)

    def _iter_var(self, name: str, env: dict, ctx: Ctx) -> Iterator[Any]:
        v = env.get(name, _MISSING)
        if v is not _MISSING and v is not FRESH:
            yield v
            return
        if name == "input":
            if ctx.input is not None:
                yield ctx.input
            return  # no input document => undefined
        if name == "data":
            yield DataNode((), self.data)
            return
        pkg = ctx.pkg_stack[-1] if ctx.pkg_stack else ()
        rules = self._rules(pkg, name)
        if rules:
            if rules[0].kind == "function":
                raise RegoError(f"{name} is a function; it must be called")
            rv = self._rule_value(pkg, name, ctx)
            if rv is not UNDEF:
                yield rv
            return
        raise RegoError(f"unsafe variable {name!r} (line context: pkg {pkg})")

    # ------------------------------------------------------------ refs

    def _walk_ref(self, base, args, i, env: dict, ctx: Ctx) -> Iterator[Any]:
        if i == len(args):
            if isinstance(base, DataNode):
                yield self._materialize_node(base, ctx)
            else:
                yield base
            return
        arg = args[i]
        if isinstance(arg, A.Var) and _is_unbound(env, arg.name) and arg.name not in (
            "input",
            "data",
        ):
            wc = arg.name.startswith("$wc")
            for k, v in self._enumerate(base, ctx):
                mark = ctx.mark()
                try:
                    if not wc:
                        ctx.bind(env, arg.name, k)
                    yield from self._walk_ref(v, args, i + 1, env, ctx)
                finally:
                    ctx.undo(mark)
            return
        if self._is_pattern(arg, env):
            # composite pattern with unbound vars, e.g. the partial-set
            # membership general_violation[{"msg": msg, "field": "containers"}]
            # in library/general/containerlimits/src.rego
            for k, v in self._enumerate(base, ctx):
                mark = ctx.mark()
                try:
                    if self._unify_pattern(arg, k, env, ctx):
                        yield from self._walk_ref(v, args, i + 1, env, ctx)
                finally:
                    ctx.undo(mark)
            return
        for k in self._iter_term(arg, env, ctx):
            v = self._step(base, k, ctx)
            if v is not UNDEF:
                yield from self._walk_ref(v, args, i + 1, env, ctx)

    def _enumerate(self, base, ctx: Ctx):
        """Yield (key, value) children of a value or DataNode."""
        if isinstance(base, (FrozenDict, dict)):
            for k, v in base.items():
                yield k, v
        elif isinstance(base, tuple):
            for idx, v in enumerate(base):
                yield idx, v
        elif isinstance(base, frozenset):
            for m in sorted(base, key=sort_key):
                yield m, m
        elif isinstance(base, DataNode):
            seen = set()
            overrides = ctx.data_overrides[-1]
            plen = len(base.path)
            for opath in overrides:
                # overrides may mount deep below this node (`with
                # data.constraints.a.b.spec.match as {}` enumerated from
                # data.constraints) — surface the next path segment
                if len(opath) > plen and opath[:plen] == base.path:
                    k = opath[plen]
                    if k not in seen:
                        seen.add(k)
                        v = self._step(base, k, ctx)
                        if v is not UNDEF:
                            yield k, v
            pkg = self.packages.get(base.path)
            if pkg:
                for name, rules in pkg.items():
                    if rules[0].kind == "function" or name in seen:
                        continue
                    seen.add(name)
                    rv = self._rule_value(base.path, name, ctx)
                    if rv is not UNDEF:
                        yield name, rv
            for pfx in self._pkg_prefixes:
                if len(pfx) == plen + 1 and pfx[:plen] == base.path:
                    k = pfx[-1]
                    if k not in seen:
                        seen.add(k)
                        yield k, self._step(base, k, ctx)
            if isinstance(base.base, (dict, FrozenDict)):
                for k, v in base.base.items():
                    if k in seen:
                        continue
                    yield k, self._node_or_value(base.path + (k,), v)

    def _step(self, base, key, ctx: Ctx):
        if isinstance(base, DataNode):
            path = base.path + (key,)
            overrides = ctx.data_overrides[-1]
            if path in overrides:
                return overrides[path]
            pkg_rules = self.packages.get(base.path)
            if pkg_rules and key in pkg_rules:
                if pkg_rules[key][0].kind == "function":
                    raise RegoError(f"{key} is a function; it must be called")
                return self._rule_value(base.path, key, ctx)
            sub = _MISSING
            if isinstance(base.base, (dict, FrozenDict)):
                sub = base.base.get(key, _MISSING)
            if path in self._pkg_prefixes or any(
                p[: len(path)] == path for p in overrides
            ):
                return DataNode(path, sub if sub is not _MISSING else _MISSING)
            if sub is _MISSING:
                return UNDEF
            return self._node_or_value(path, sub)
        if isinstance(base, (FrozenDict, dict)):
            v = base.get(key, _MISSING)
            return UNDEF if v is _MISSING else v
        if isinstance(base, tuple):
            if isinstance(key, bool) or not isinstance(key, int):
                return UNDEF
            if 0 <= key < len(base):
                return base[key]
            return UNDEF
        if isinstance(base, frozenset):
            return key if key in base else UNDEF
        return UNDEF

    def _node_or_value(self, path: tuple, sub):
        # plain mutable dicts inside the store remain traversable; frozen
        # leaves are values
        if isinstance(sub, dict) and not isinstance(sub, FrozenDict):
            return DataNode(path, sub)
        return sub

    def _materialize_node(self, node: DataNode, ctx: Ctx):
        out = {}
        for k, v in self._enumerate(node, ctx):
            if isinstance(v, DataNode):
                v = self._materialize_node(v, ctx)
            out[k] = v
        return FrozenDict(out)

    # ------------------------------------------------------------ calls

    def _iter_call(self, t: A.Call, env: dict, ctx: Ctx) -> Iterator[Any]:
        pkg = ctx.pkg_stack[-1] if ctx.pkg_stack else ()
        fn_pkg = None
        fn_name = None
        if len(t.fn) == 1 and self._rules(pkg, t.fn[0]):
            fn_pkg, fn_name = pkg, t.fn[0]
        elif t.fn[0] == "data" and len(t.fn) > 2:
            cand_pkg, cand_name = tuple(t.fn[1:-1]), t.fn[-1]
            if self._rules(cand_pkg, cand_name):
                fn_pkg, fn_name = cand_pkg, cand_name

        if fn_pkg is not None:
            rules = self._rules(fn_pkg, fn_name)
            if rules[0].kind != "function":
                raise RegoError(f"{fn_name} is not a function")
            for argvals in self._iter_product(t.args, env, ctx, tuple):
                v = self._call_function(fn_pkg, fn_name, argvals, ctx)
                if v is not UNDEF:
                    yield v
            return

        if tuple(t.fn) == ("walk",):
            # multi-valued builtin: walk(x) enumerates every [path, value]
            # pair of the document, root first (OPA topdown/walk.go); the
            # common `[p, v] := walk(x)` form destructures the pairs.
            # Deliberately NOT in BUILTINS: codegen/device treat unknown
            # fns as Unsupported, falling back to this interpreter.
            for argvals in self._iter_product(t.args, env, ctx, tuple):
                yield from _walk_pairs(argvals[0])
            return

        fn = BUILTINS.get(t.fn)
        if fn is None:
            raise RegoError(f"unknown function {'.'.join(t.fn)}")
        for argvals in self._iter_product(t.args, env, ctx, tuple):
            try:
                v = fn(*argvals)
            except BuiltinError:
                continue
            except (TypeError, ValueError, KeyError, ZeroDivisionError):
                continue
            if v is not UNDEF:
                yield v


# ---------------------------------------------------------------- helpers


def _walk_pairs(v):
    stack = [((), v)]
    while stack:
        path, node = stack.pop()
        yield (path, node)
        if isinstance(node, FrozenDict):
            for k, x in node.items():
                stack.append((path + (k,), x))
        elif isinstance(node, tuple):
            for i, x in enumerate(node):
                stack.append((path + (i,), x))
        elif isinstance(node, frozenset):
            for x in node:
                stack.append((path + (x,), x))


def _binop(op: str, a, b):
    num_a = isinstance(a, (int, float)) and not isinstance(a, bool)
    num_b = isinstance(b, (int, float)) and not isinstance(b, bool)
    if op == "==":
        return rego_eq(a, b)
    if op == "!=":
        return not rego_eq(a, b)
    if op in ("<", "<=", ">", ">="):
        ka, kb = sort_key(a), sort_key(b)
        if op == "<":
            return ka < kb
        if op == "<=":
            return ka <= kb
        if op == ">":
            return ka > kb
        return ka >= kb
    if op == "+":
        if num_a and num_b:
            return a + b
        return UNDEF
    if op == "-":
        if num_a and num_b:
            return a - b
        if isinstance(a, frozenset) and isinstance(b, frozenset):
            return a - b
        return UNDEF
    if op == "*":
        if num_a and num_b:
            return a * b
        return UNDEF
    if op == "/":
        if num_a and num_b and b != 0:
            q = a / b
            if isinstance(a, int) and isinstance(b, int) and a % b == 0:
                return a // b
            return q
        return UNDEF
    if op == "%":
        if num_a and num_b and b != 0:
            return a % b
        return UNDEF
    if op == "|":
        if isinstance(a, frozenset) and isinstance(b, frozenset):
            return a | b
        return UNDEF
    if op == "&":
        if isinstance(a, frozenset) and isinstance(b, frozenset):
            return a & b
        return UNDEF
    return UNDEF


def _set_in(base, path: tuple, value):
    """Functional update of a frozen object at a path (for `with input.x as v`)."""
    if not path:
        return value
    obj = base if isinstance(base, FrozenDict) else FrozenDict()
    d = dict(obj)
    k = path[0]
    d[k] = _set_in(obj.get(k, FrozenDict()), path[1:], value)
    return FrozenDict(d)
