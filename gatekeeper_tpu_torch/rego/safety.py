"""Body-literal reordering (safety analysis).

OPA's compiler reorders rule-body literals so every variable is bound before
it is *needed* (ast/compile.go "reorderBodyForSafety"). Source order is not
evaluation order — e.g. library/general/uniqueserviceselector/src.rego:

    selectors := [s | s = concat(":", [key, val]); val = obj.spec.selector[key]]

where the first comprehension literal consumes key/val that only the second
binds. This pass replicates that: a greedy topological sort where a literal
is schedulable once all its needed vars are bound, applied recursively to
comprehension bodies.

Positions that can BIND a var: lhs/rhs pattern positions of `=`/`:=`
(nested array/object-value patterns included) and ref bracket arguments.
Positions that NEED a var bound: builtin/function call arguments, ref bases,
binop operands, object keys, everything under negation. Comprehensions bind
their own locals; only their residual free vars are needed from the outer
scope.
"""

from __future__ import annotations

from . import ast as A

_GLOBALS = ("input", "data")


def _is_binding_pattern(t) -> bool:
    if isinstance(t, A.Var):
        return True
    if isinstance(t, A.ArrayLit):
        return all(_is_binding_pattern(x) or isinstance(x, A.Scalar) for x in t.items)
    if isinstance(t, A.ObjectLit):
        return all(
            _is_binding_pattern(v) or isinstance(v, A.Scalar) for _, v in t.items
        )
    return False


def _pattern_vars(t, out: set):
    if isinstance(t, A.Var):
        out.add(t.name)
    elif isinstance(t, A.ArrayLit):
        for x in t.items:
            _pattern_vars(x, out)
    elif isinstance(t, A.ObjectLit):
        for _, v in t.items:
            _pattern_vars(v, out)


def _term_vars(t, needed: set, bound: set):
    """Collect vars of term t into `needed` (must be pre-bound) and `bound`
    (bindable by evaluating this term in a positive literal)."""
    if isinstance(t, A.Var):
        needed.add(t.name)
    elif isinstance(t, A.Ref):
        if isinstance(t.base, A.Var):
            needed.add(t.base.name)
        else:
            _term_vars(t.base, needed, bound)
        for a in t.args:
            if isinstance(a, A.Var):
                bound.add(a.name)  # unbound bracket vars enumerate
            elif _is_binding_pattern(a):
                _pattern_vars(a, bound)
            else:
                _term_vars(a, needed, bound)
    elif isinstance(t, A.Call):
        for a in t.args:
            _term_vars(a, needed, bound)
    elif isinstance(t, A.BinOp):
        _term_vars(t.lhs, needed, bound)
        _term_vars(t.rhs, needed, bound)
    elif isinstance(t, A.UnaryMinus):
        _term_vars(t.term, needed, bound)
    elif isinstance(t, (A.ArrayLit, A.SetLit)):
        for x in t.items:
            _term_vars(x, needed, bound)
    elif isinstance(t, A.ObjectLit):
        for k, v in t.items:
            _term_vars(k, needed, bound)
            _term_vars(v, needed, bound)
    elif isinstance(t, A.ArrayCompr):
        needed.update(_compr_free(list(t.body), [t.head]))
    elif isinstance(t, A.SetCompr):
        needed.update(_compr_free(list(t.body), [t.head]))
    elif isinstance(t, A.ObjectCompr):
        needed.update(_compr_free(list(t.body), [t.key, t.value]))


def _compr_free(body: list, heads: list) -> set:
    """Free vars of a comprehension = (needed by body+heads) - (bindable in body)."""
    needed: set = set()
    bindable: set = set()
    for lit in body:
        n, b = _literal_vars(lit)
        needed |= n
        bindable |= b
    for h in heads:
        hn: set = set()
        hb: set = set()
        _term_vars(h, hn, hb)
        needed |= hn
    return needed - bindable


def _literal_vars(lit: A.Literal):
    """Return (needed, bindable) var sets for a literal."""
    needed: set = set()
    bindable: set = set()
    e = lit.expr
    if isinstance(e, A.SomeDecl):
        bindable.update(e.names)
    elif isinstance(e, (A.Assign, A.Unify)):
        for side in (e.lhs, e.rhs):
            if _is_binding_pattern(side):
                _pattern_vars(side, bindable)
            else:
                _term_vars(side, needed, bindable)
    else:
        _term_vars(e, needed, bindable)
    if lit.negated:
        needed |= bindable
        bindable = set()
    for w in lit.withs:
        wn: set = set()
        wb: set = set()
        _term_vars(w.value, wn, wb)
        needed |= wn | wb
    needed -= set(_GLOBALS)
    bindable = {v for v in bindable if v not in _GLOBALS}
    return needed, bindable


def reorder_body(body: tuple, rule_names: set, pre_bound: set) -> tuple:
    body = tuple(_reorder_terms(lit, rule_names) for lit in body)
    if len(body) < 2:
        return body
    pending = list(body)
    bound = set(pre_bound)
    out = []
    infos = {id(l): _literal_vars(l) for l in pending}
    # vars no literal can bind must come from the outer scope (comprehension
    # closures) or be rule references — treat them as already bound
    all_bindable: set = set()
    for _, b in infos.values():
        all_bindable |= b
    while pending:
        progressed = False
        for i, lit in enumerate(pending):
            needed, _ = infos[id(lit)]
            unmet = {
                v
                for v in needed
                if v in all_bindable
                and v not in bound
                and v not in rule_names
                and not v.startswith("$wc")
            }
            if not unmet:
                out.append(lit)
                bound |= infos[id(lit)][1]
                # a scheduled positive literal also grounds its needed vars
                bound |= needed
                del pending[i]
                progressed = True
                break
        if not progressed:
            # unsatisfiable ordering: keep source order for the remainder and
            # let evaluation report the unsafe var
            out.extend(pending)
            break
    return tuple(out)


def _reorder_terms(lit: A.Literal, rule_names: set) -> A.Literal:
    """Recursively reorder comprehension bodies inside a literal."""

    def rt(t):
        if isinstance(t, A.ArrayCompr):
            return A.ArrayCompr(rt(t.head), reorder_body(t.body, rule_names, set()))
        if isinstance(t, A.SetCompr):
            return A.SetCompr(rt(t.head), reorder_body(t.body, rule_names, set()))
        if isinstance(t, A.ObjectCompr):
            return A.ObjectCompr(
                rt(t.key), rt(t.value), reorder_body(t.body, rule_names, set())
            )
        if isinstance(t, A.Ref):
            return A.Ref(rt(t.base), tuple(rt(a) for a in t.args))
        if isinstance(t, A.Call):
            return A.Call(t.fn, tuple(rt(a) for a in t.args))
        if isinstance(t, A.BinOp):
            return A.BinOp(t.op, rt(t.lhs), rt(t.rhs))
        if isinstance(t, A.UnaryMinus):
            return A.UnaryMinus(rt(t.term))
        if isinstance(t, A.ArrayLit):
            return A.ArrayLit(tuple(rt(x) for x in t.items))
        if isinstance(t, A.SetLit):
            return A.SetLit(tuple(rt(x) for x in t.items))
        if isinstance(t, A.ObjectLit):
            return A.ObjectLit(tuple((rt(k), rt(v)) for k, v in t.items))
        if isinstance(t, (A.Assign, A.Unify)):
            cls = type(t)
            return cls(rt(t.lhs), rt(t.rhs))
        return t

    return A.Literal(
        expr=rt(lit.expr),
        negated=lit.negated,
        withs=tuple(A.WithMod(w.target, rt(w.value)) for w in lit.withs),
        line=lit.line,
    )


def reorder_module(m: A.Module) -> A.Module:
    rule_names = {r.name for r in m.rules}
    new_rules = []
    for r in m.rules:
        pre: set = set()
        for a in r.args:
            _pattern_vars(a, pre)
        new_rules.append(
            A.Rule(
                name=r.name,
                kind=r.kind,
                args=r.args,
                key=r.key,
                value=r.value,
                body=reorder_body(r.body, rule_names, pre),
                is_default=r.is_default,
                line=r.line,
            )
        )
    return A.Module(
        package=m.package,
        imports=m.imports,
        rules=tuple(new_rules),
        source_name=m.source_name,
    )
