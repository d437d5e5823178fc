"""Template-module rewriting: package namespacing + extern safety.

The reference's regorewriter (vendor/.../constraint/pkg/client/regorewriter/
regorewriter.go) rewrites a template's entry module into the
`templates["<target>"]["<Kind>"]` package and its libs under
`libs.<target>.<Kind>`, requires libs to live under `package lib...`,
and rejects references to any `data.*` root other than the lib prefix and
the allowed externs (`data.inventory`). It also enforces that the entry
module defines `violation` as a partial-set rule (client.go:312-316).

This implementation works on parsed AST modules directly (no source
re-emission — the driver stores ASTs), which also gives the recompile-free
template swap the reference lacks (local.go:168-207 recompiles everything).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Iterable

from ..rego import ast as A
from ..rego.parser import ParseError, parse_module


class RewriteError(Exception):
    pass


def template_package(target: str, kind: str) -> tuple:
    return ("templates", target, kind)


def lib_package_prefix(target: str, kind: str) -> tuple:
    return ("libs", target, kind)


def rewrite_template_modules(
    target: str,
    kind: str,
    rego_src: str,
    libs: Iterable[str] = (),
    allowed_externs: tuple = ("inventory",),
    source_name: str = "<template>",
) -> list[A.Module]:
    """Parse + namespace a template's entry module and libs.

    Returns modules whose packages are `templates.<target>.<Kind>` (entry)
    and `libs.<target>.<Kind>.lib...` (libs); every `data.lib...` reference
    is redirected into the namespaced lib location.
    """
    try:
        entry = parse_module(rego_src, source_name)
    except ParseError as e:
        raise RewriteError(f"could not parse template rego: {e}") from None
    lib_mods = []
    for i, src in enumerate(libs):
        try:
            m = parse_module(src, f"{source_name}/lib_{i}")
        except ParseError as e:
            raise RewriteError(f"could not parse lib {i}: {e}") from None
        if not m.package or m.package[0] != "lib":
            raise RewriteError(
                f"lib {i}: package must begin with `lib`, got {'.'.join(m.package)}"
            )
        lib_mods.append(m)

    _require_violation_rule(entry)

    lib_prefix = lib_package_prefix(target, kind)

    def redirect(path: tuple) -> tuple:
        """Map a data-root path onto its namespaced location."""
        if path and path[0] == "lib":
            return lib_prefix + path
        return path

    out = []
    entry2 = replace(
        entry,
        package=template_package(target, kind),
        rules=tuple(
            _rewrite_rule(r, redirect, allowed_externs, entry.package)
            for r in entry.rules
        ),
    )
    out.append(entry2)
    for m in lib_mods:
        m2 = replace(
            m,
            package=lib_prefix + m.package,
            rules=tuple(
                _rewrite_rule(r, redirect, allowed_externs, m.package)
                for r in m.rules
            ),
        )
        out.append(m2)
    return out


def _require_violation_rule(entry: A.Module) -> None:
    kinds = [r.kind for r in entry.rules if r.name == "violation"]
    if not kinds:
        raise RewriteError("Invalid rego: template must define a violation rule")
    if any(k != "partial_set" for k in kinds):
        raise RewriteError(
            "Invalid rego: violation must be a partial-set rule of arity 1 "
            "(violation[{…}] { … })"
        )


# ------------------------------------------------------------ AST traversal


def _rewrite_rule(rule: A.Rule, redirect: Callable, externs: tuple, pkg: tuple):
    fn = _make_term_rewriter(redirect, externs, pkg)
    return replace(
        rule,
        args=tuple(fn(t) for t in rule.args),
        key=fn(rule.key) if rule.key is not None else None,
        value=fn(rule.value) if rule.value is not None else None,
        body=tuple(_rewrite_literal(l, fn) for l in rule.body),
    )


def _rewrite_literal(lit: A.Literal, fn: Callable) -> A.Literal:
    return replace(
        lit,
        expr=fn(lit.expr),
        withs=tuple(replace(w, value=fn(w.value)) for w in lit.withs),
    )


def _ref_static_path(t: A.Ref) -> tuple | None:
    """The leading all-static segments of a data ref, or None if not data-rooted."""
    if not isinstance(t.base, A.Var) or t.base.name != "data":
        return None
    path = []
    for a in t.args:
        if isinstance(a, A.Scalar) and isinstance(a.value, str):
            path.append(a.value)
        else:
            break
    return tuple(path)


def _make_term_rewriter(redirect: Callable, externs: tuple, pkg: tuple):
    def fn(t):
        if t is None:
            return None
        if isinstance(t, A.Ref):
            base = fn(t.base)
            args = tuple(fn(a) for a in t.args)
            t2 = A.Ref(base=base, args=args)
            static = _ref_static_path(t2)
            if static is not None:
                if not static:
                    raise RewriteError(
                        "template rego may not reference the bare `data` document"
                    )
                root = static[0]
                if root == "lib":
                    new = redirect(static)
                    new_args = tuple(A.Scalar(s) for s in new) + args[len(static):]
                    return A.Ref(base=base, args=new_args)
                if root not in externs:
                    raise RewriteError(
                        f"invalid data reference data.{'.'.join(static)}: only "
                        f"data.lib and data.{{{', '.join(externs)}}} are allowed "
                        "in template rego"
                    )
            return t2
        if isinstance(t, A.Scalar) or isinstance(t, A.Var):
            return t
        if isinstance(t, A.ArrayLit):
            return A.ArrayLit(tuple(fn(x) for x in t.items))
        if isinstance(t, A.SetLit):
            return A.SetLit(tuple(fn(x) for x in t.items))
        if isinstance(t, A.ObjectLit):
            return A.ObjectLit(tuple((fn(k), fn(v)) for k, v in t.items))
        if isinstance(t, A.ArrayCompr):
            return A.ArrayCompr(fn(t.head), tuple(_rewrite_literal(l, fn) for l in t.body))
        if isinstance(t, A.SetCompr):
            return A.SetCompr(fn(t.head), tuple(_rewrite_literal(l, fn) for l in t.body))
        if isinstance(t, A.ObjectCompr):
            return A.ObjectCompr(
                fn(t.key), fn(t.value), tuple(_rewrite_literal(l, fn) for l in t.body)
            )
        if isinstance(t, A.Call):
            # calls into libs: data.lib.x.fn(...) — redirect the name path
            if t.fn and t.fn[0] == "data" and len(t.fn) > 1:
                inner = t.fn[1:]
                if inner[0] == "lib":
                    t = A.Call(("data",) + redirect(inner), t.args)
                elif inner[0] not in externs:
                    raise RewriteError(
                        f"invalid data call data.{'.'.join(inner)}"
                    )
            return A.Call(t.fn, tuple(fn(a) for a in t.args))
        if isinstance(t, A.BinOp):
            return A.BinOp(t.op, fn(t.lhs), fn(t.rhs))
        if isinstance(t, A.UnaryMinus):
            return A.UnaryMinus(fn(t.term))
        if isinstance(t, (A.Assign, A.Unify)):
            return type(t)(fn(t.lhs), fn(t.rhs))
        if isinstance(t, A.SomeDecl):
            return t
        raise RewriteError(f"unhandled AST node {type(t).__name__}")

    return fn
