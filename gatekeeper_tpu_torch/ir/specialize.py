"""AST specialization: expand rule indirection into flat violation clauses.

The policy corpus hides iteration unions behind local helper rules — the
`input_containers` partial set unioning containers/initContainers
(reference library/pod-security-policy/*/src.rego), the object-headed
`general_violation[{"msg": msg, "field": field}]` invocation
(library/general/containerlimits/src.rego:123-129), and path-valued
functions like `run_as_user` (pod-security-policy/users/src.rego:38-48).

The vectorized compiler wants none of that indirection: a device clause is
a flat conjunction over explicit iteration axes. This pass multiplies each
clause by the alternatives of every positively-referenced local rule,
substituting terms with capture-free renaming, so compile.py sees only
direct paths. Negated references are left alone — negation needs the
existential boundary that compile.py's helper inlining provides.

Pure AST -> AST; raises nothing (unexpandable shapes are left in place for
compile.py to reject into the interpreter fallback path).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

from ..rego import ast as A

_MAX_EXPANSIONS = 256  # per-rule alternative cap (explosion guard)


class _Fresh:
    def __init__(self):
        self.n = 0

    def var(self, base: str) -> str:
        self.n += 1
        return f"{base}__x{self.n}"


# ------------------------------------------------------------ substitution


def subst(t, m: dict):
    """Substitute Var names by terms, splicing refs into ref bases."""
    if t is None or isinstance(t, A.Scalar):
        return t
    if isinstance(t, A.Var):
        return m.get(t.name, t)
    if isinstance(t, A.Ref):
        base = subst(t.base, m)
        args = tuple(subst(a, m) for a in t.args)
        if isinstance(base, A.Ref):
            return A.Ref(base=base.base, args=base.args + args)
        return A.Ref(base=base, args=args)
    if isinstance(t, A.Call):
        return A.Call(fn=t.fn, args=tuple(subst(a, m) for a in t.args))
    if isinstance(t, A.BinOp):
        return A.BinOp(op=t.op, lhs=subst(t.lhs, m), rhs=subst(t.rhs, m))
    if isinstance(t, A.UnaryMinus):
        return A.UnaryMinus(term=subst(t.term, m))
    if isinstance(t, A.ArrayLit):
        return A.ArrayLit(items=tuple(subst(x, m) for x in t.items))
    if isinstance(t, A.SetLit):
        return A.SetLit(items=tuple(subst(x, m) for x in t.items))
    if isinstance(t, A.ObjectLit):
        return A.ObjectLit(items=tuple((subst(k, m), subst(v, m))
                                       for k, v in t.items))
    if isinstance(t, A.ArrayCompr):
        return A.ArrayCompr(head=subst(t.head, m),
                            body=tuple(subst_lit(l, m) for l in t.body))
    if isinstance(t, A.SetCompr):
        return A.SetCompr(head=subst(t.head, m),
                          body=tuple(subst_lit(l, m) for l in t.body))
    if isinstance(t, A.ObjectCompr):
        return A.ObjectCompr(key=subst(t.key, m), value=subst(t.value, m),
                             body=tuple(subst_lit(l, m) for l in t.body))
    if isinstance(t, A.Assign):
        return A.Assign(lhs=subst(t.lhs, m), rhs=subst(t.rhs, m))
    if isinstance(t, A.Unify):
        return A.Unify(lhs=subst(t.lhs, m), rhs=subst(t.rhs, m))
    if isinstance(t, A.SomeDecl):
        return t
    return t


def subst_lit(lit: A.Literal, m: dict) -> A.Literal:
    return replace(lit, expr=subst(lit.expr, m))


def _local_vars(rule: A.Rule) -> set:
    out: set = set()

    def walk(t):
        if isinstance(t, A.Var):
            if t.name not in ("input", "data"):
                out.add(t.name)
        elif isinstance(t, A.Ref):
            walk(t.base)
            for a in t.args:
                walk(a)
        elif isinstance(t, (A.Call,)):
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

    if rule.key is not None:
        walk(rule.key)
    if rule.value is not None:
        walk(rule.value)
    for a in rule.args:
        walk(a)
    for lit in rule.body:
        walk(lit.expr)
    return out


def _freshen(rule: A.Rule, fresh: _Fresh) -> A.Rule:
    ren = {v: A.Var(fresh.var(v)) for v in _local_vars(rule)
           if not v.startswith("$wc")}
    # wildcards stay wildcards but must not collide across copies
    for v in _local_vars(rule):
        if v.startswith("$wc"):
            ren[v] = A.Var(fresh.var("$wc"))
    return replace(
        rule,
        key=subst(rule.key, ren) if rule.key is not None else None,
        value=subst(rule.value, ren) if rule.value is not None else None,
        args=tuple(subst(a, ren) for a in rule.args),
        body=tuple(subst_lit(l, ren) for l in rule.body),
    )


# ------------------------------------------------------------ site finding


class _Site:
    """First expandable reference found in a literal."""

    def __init__(self, kind: str, name: str, term: Optional[A.Ref] = None):
        self.kind = kind  # "ps" | "objhead" | "pathfn"
        self.name = name
        self.term = term


def _find_ps_ref(t, ps_names: set) -> Optional[A.Ref]:
    """Deepest-first search for Ref(base=Var(ps), ...)."""
    if isinstance(t, A.Ref):
        inner = _find_ps_ref(t.base, ps_names)
        if inner is not None:
            return inner
        for a in t.args:
            inner = _find_ps_ref(a, ps_names)
            if inner is not None:
                return inner
        if isinstance(t.base, A.Var) and t.base.name in ps_names and t.args:
            return t
        return None
    if isinstance(t, A.Call):
        for a in t.args:
            inner = _find_ps_ref(a, ps_names)
            if inner is not None:
                return inner
        return None
    if isinstance(t, A.BinOp):
        return (_find_ps_ref(t.lhs, ps_names)
                or _find_ps_ref(t.rhs, ps_names))
    if isinstance(t, A.UnaryMinus):
        return _find_ps_ref(t.term, ps_names)
    if isinstance(t, (A.Assign, A.Unify)):
        return (_find_ps_ref(t.lhs, ps_names)
                or _find_ps_ref(t.rhs, ps_names))
    return None


def _replace_term(t, old, new):
    if t is old:
        return new
    if isinstance(t, A.Ref):
        base = _replace_term(t.base, old, new)
        args = tuple(_replace_term(a, old, new) for a in t.args)
        if isinstance(base, A.Ref):
            return A.Ref(base=base.base, args=base.args + args)
        return A.Ref(base=base, args=args)
    if isinstance(t, A.Call):
        return A.Call(fn=t.fn, args=tuple(_replace_term(a, old, new)
                                          for a in t.args))
    if isinstance(t, A.BinOp):
        return A.BinOp(op=t.op, lhs=_replace_term(t.lhs, old, new),
                       rhs=_replace_term(t.rhs, old, new))
    if isinstance(t, A.UnaryMinus):
        return A.UnaryMinus(term=_replace_term(t.term, old, new))
    if isinstance(t, (A.Assign,)):
        return A.Assign(lhs=_replace_term(t.lhs, old, new),
                        rhs=_replace_term(t.rhs, old, new))
    if isinstance(t, (A.Unify,)):
        return A.Unify(lhs=_replace_term(t.lhs, old, new),
                       rhs=_replace_term(t.rhs, old, new))
    return t


# ------------------------------------------------------------- expansion


class _Expander:
    def __init__(self, module: A.Module):
        self.module = module
        self.fresh = _Fresh()
        self.rules: dict[str, list[A.Rule]] = {}
        for r in module.rules:
            self.rules.setdefault(r.name, []).append(r)
        self.ps_names = {
            n for n, rs in self.rules.items()
            if all(r.kind == "partial_set" for r in rs)
        }
        # path-valued functions: every clause's head value is a Var whose
        # body binding (or the value itself) is a plain Ref/Var — inlining
        # them multiplies clauses without introducing uncompilable exprs
        self.pathfn_names = {
            n for n, rs in self.rules.items()
            if rs and all(r.kind == "function" and self._path_valued(r)
                          for r in rs)
        }

    def _path_valued(self, r: A.Rule) -> bool:
        v = r.value
        if v is None:
            return False
        if isinstance(v, A.Ref):
            return True
        if not isinstance(v, A.Var):
            return False
        for lit in r.body:
            e = lit.expr
            if not lit.negated and isinstance(e, (A.Assign, A.Unify)) and \
                    isinstance(e.lhs, A.Var) and e.lhs.name == v.name:
                return isinstance(e.rhs, (A.Ref, A.Var))
        return False

    # ------------------------------------------------------------- driver

    def expand_module(self) -> A.Module:
        out_rules: list[A.Rule] = []
        for name, rs in self.rules.items():
            if name in self.ps_names and name != "violation":
                # referenced partial sets stay (interpreter still needs
                # them for message materialization) and are also expanded
                # in place so compile-time helper inlining sees flat bodies
                out_rules.extend(self._expand_rule(r) for r in rs)
                continue
            for r in rs:
                out_rules.extend(self._expand_all(r))
        flat = []
        for x in out_rules:
            flat.extend(x if isinstance(x, list) else [x])
        return replace(self.module, rules=tuple(flat))

    def _expand_rule(self, r: A.Rule) -> list:
        return self._expand_all(r)

    def _expand_all(self, rule: A.Rule) -> list[A.Rule]:
        work = [rule]
        done: list[A.Rule] = []
        budget = _MAX_EXPANSIONS
        while work:
            r = work.pop()
            exp = self._expand_once(r)
            if exp is None:
                done.append(r)
                continue
            budget -= len(exp)
            if budget <= 0:
                return [rule]  # explosion: leave original for fallback
            work.extend(exp)
        done.reverse()
        return done

    def _expand_once(self, rule: A.Rule) -> Optional[list[A.Rule]]:
        for i, lit in enumerate(rule.body):
            if lit.negated or lit.withs:
                continue
            e = lit.expr
            # object-headed partial-set invocation:
            #   general_violation[{"msg": msg, "field": "containers"}]
            if isinstance(e, A.Ref) and isinstance(e.base, A.Var) \
                    and e.base.name in self.ps_names \
                    and len(e.args) == 1 \
                    and isinstance(e.args[0], A.ObjectLit):
                alts = self._expand_objhead(rule, i, e.base.name, e.args[0])
                if alts is not None:
                    return alts
                continue
            # value-function inlining at a positive binding site
            if isinstance(e, (A.Assign, A.Unify)) and \
                    isinstance(e.lhs, A.Var) and isinstance(e.rhs, A.Call) \
                    and len(e.rhs.fn) == 1 \
                    and e.rhs.fn[0] in self.pathfn_names:
                alts = self._expand_pathfn(rule, i, e.lhs, e.rhs)
                if alts is not None:
                    return alts
                continue
            site = _find_ps_ref(e, self.ps_names)
            if site is not None:
                alts = self._expand_ps(rule, i, lit, site)
                if alts is not None:
                    return alts
        return None

    # ------------------------------------------------------ ps expansion

    def _expand_ps(self, rule: A.Rule, i: int, lit: A.Literal,
                   site: A.Ref) -> Optional[list[A.Rule]]:
        name = site.base.name
        a0 = site.args[0]
        rest = site.args[1:]
        e = lit.expr
        out: list[A.Rule] = []
        for pc in self.rules[name]:
            pc = _freshen(pc, self.fresh)
            if not isinstance(pc.key, A.Var):
                return None  # non-var set element: not expandable
            head = pc.key.name
            pre = list(rule.body[:i])
            post = list(rule.body[i + 1:])
            body = list(pc.body)
            extra: list[A.Literal] = []
            if isinstance(a0, A.Var):
                if a0.name.startswith("$wc"):
                    bound = head
                else:
                    # rename the set-element var to the caller's var
                    ren = {head: A.Var(a0.name)}
                    body = [subst_lit(l, ren) for l in body]
                    bound = a0.name
            elif isinstance(a0, A.Scalar):
                extra = [A.Literal(expr=A.Unify(lhs=A.Var(head), rhs=a0))]
                bound = head
            else:
                return None
            # rebuild the literal with the site replaced
            if not rest and e is site:
                new_lits: list[A.Literal] = []  # bare membership: consumed
            elif not rest and isinstance(e, (A.Assign, A.Unify)) and \
                    isinstance(e.lhs, A.Var) and e.rhs is site:
                if isinstance(a0, A.Var) and not a0.name.startswith("$wc"):
                    # x := ps[y]: keep x alias to the element var
                    new_lits = [replace(lit, expr=A.Assign(
                        lhs=e.lhs, rhs=A.Var(bound)))]
                else:
                    ren2 = {bound: A.Var(e.lhs.name)}
                    body = [subst_lit(l, ren2) for l in body]
                    extra = [subst_lit(l, ren2) for l in extra]
                    new_lits = []
            else:
                repl = A.Var(bound) if not rest else \
                    A.Ref(base=A.Var(bound), args=rest)
                new_lits = [replace(lit, expr=_replace_term(e, site, repl))]
            out.append(replace(rule, body=tuple(
                pre + body + extra + new_lits + post)))
        return out

    # -------------------------------------------------- objhead expansion

    def _expand_objhead(self, rule: A.Rule, i: int, name: str,
                        pat: A.ObjectLit) -> Optional[list[A.Rule]]:
        pat_map = {}
        for k, v in pat.items:
            if not isinstance(k, A.Scalar) or not isinstance(k.value, str):
                return None
            pat_map[k.value] = v
        out: list[A.Rule] = []
        for pc in self.rules[name]:
            pc = _freshen(pc, self.fresh)
            if not isinstance(pc.key, A.ObjectLit):
                return None
            ren: dict = {}
            extra: list[A.Literal] = []
            ok = True
            for hk, hv in pc.key.items:
                if not isinstance(hk, A.Scalar) or hk.value not in pat_map:
                    ok = False
                    break
                pv = pat_map[hk.value]
                if isinstance(hv, A.Var):
                    # head var <- caller term (var or constant)
                    ren[hv.name] = pv
                elif isinstance(hv, A.Scalar):
                    if isinstance(pv, A.Scalar):
                        if pv.value != hv.value:
                            ok = False
                            break
                    elif isinstance(pv, A.Var):
                        extra.append(A.Literal(
                            expr=A.Assign(lhs=pv, rhs=hv)))
                    else:
                        ok = False
                        break
                else:
                    ok = False
                    break
            if not ok:
                continue
            body = [subst_lit(l, ren) for l in pc.body]
            out.append(replace(rule, body=tuple(
                list(rule.body[:i]) + body + extra +
                list(rule.body[i + 1:]))))
        return out if out else None

    # --------------------------------------------------- pathfn expansion

    def _expand_pathfn(self, rule: A.Rule, i: int, lhs: A.Var,
                       call: A.Call) -> Optional[list[A.Rule]]:
        name = call.fn[0]
        out: list[A.Rule] = []
        for fc in self.rules[name]:
            fc = _freshen(fc, self.fresh)
            if len(fc.args) != len(call.args):
                continue
            ren: dict = {}
            extra: list[A.Literal] = []
            ok = True
            for formal, actual in zip(fc.args, call.args):
                if isinstance(formal, A.Var):
                    ren[formal.name] = actual
                elif isinstance(formal, A.Scalar):
                    if isinstance(actual, A.Scalar):
                        if actual.value != formal.value:
                            ok = False
                            break
                    else:
                        extra.append(A.Literal(
                            expr=A.Unify(lhs=actual, rhs=formal)))
                else:
                    ok = False
                    break
            if not ok:
                continue
            body = [subst_lit(l, ren) for l in fc.body]
            value = subst(fc.value, ren)
            bind = A.Literal(expr=A.Assign(lhs=lhs, rhs=value))
            out.append(replace(rule, body=tuple(
                list(rule.body[:i]) + extra + body + [bind] +
                list(rule.body[i + 1:]))))
        return out if out else None


def specialize_module(module: A.Module) -> A.Module:
    """Expand local-rule indirection across the whole module (violation
    clauses AND helper bodies, so compile-time helper inlining also sees
    flat alternatives)."""
    return _Expander(module).expand_module()
