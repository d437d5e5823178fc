"""Canonical Rego pretty-printer (the `opa fmt` analog).

Renders a parsed Module back to canonical Rego source: dotted refs where
legal, `:=` kept as written, one literal per body line, 2-space indent,
wildcards printed as `_`. The contract mirrors opa fmt's
(vendor/.../opa/format): output re-parses to the same AST (modulo
source positions and wildcard numbering) — pinned by the round-trip
tests over the reference library corpus.
"""

from __future__ import annotations

import json
import re

from . import ast as A

_IDENT = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_INFIX = {"==", "!=", "<", "<=", ">", ">=", "+", "-", "*", "/", "%",
          "|", "&"}
# binding strength only matters for the few nestings the corpus uses;
# parenthesize any nested binop conservatively
_KEYWORDS = {"not", "some", "with", "as", "default", "package", "import",
             "true", "false", "null", "else"}


def _scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        if isinstance(v, float) and v.is_integer():
            return str(int(v))
        return repr(v)
    return json.dumps(v)


def _var(name: str) -> str:
    return "_" if name.startswith("$wc") else name


def term(t, parent_binop: bool = False) -> str:
    if isinstance(t, A.Scalar):
        return _scalar(t.value)
    if isinstance(t, A.Var):
        return _var(t.name)
    if isinstance(t, A.Ref):
        out = term(t.base)
        for a in t.args:
            if isinstance(a, A.Scalar) and isinstance(a.value, str) and \
                    _IDENT.match(a.value) and a.value not in _KEYWORDS:
                out += f".{a.value}"
            else:
                out += f"[{term(a)}]"
        return out
    if isinstance(t, A.Call):
        args = ", ".join(term(a) for a in t.args)
        return f"{'.'.join(t.fn)}({args})"
    if isinstance(t, A.BinOp):
        lhs = term(t.lhs, parent_binop=True)
        rhs = term(t.rhs, parent_binop=True)
        s = f"{lhs} {t.op} {rhs}"
        return f"({s})" if parent_binop else s
    if isinstance(t, A.UnaryMinus):
        return f"-{term(t.term, parent_binop=True)}"
    if isinstance(t, A.ArrayLit):
        return "[" + ", ".join(term(x) for x in t.items) + "]"
    if isinstance(t, A.SetLit):
        if not t.items:
            return "set()"
        return "{" + ", ".join(term(x) for x in t.items) + "}"
    if isinstance(t, A.ObjectLit):
        return "{" + ", ".join(f"{term(k)}: {term(v)}"
                               for k, v in t.items) + "}"
    if isinstance(t, A.ArrayCompr):
        return f"[{term(t.head)} | {_compr_body(t.body)}]"
    if isinstance(t, A.SetCompr):
        return f"{{{term(t.head)} | {_compr_body(t.body)}}}"
    if isinstance(t, A.ObjectCompr):
        return (f"{{{term(t.key)}: {term(t.value)} | "
                f"{_compr_body(t.body)}}}")
    if isinstance(t, A.Assign):
        return f"{term(t.lhs)} := {term(t.rhs)}"
    if isinstance(t, A.Unify):
        return f"{term(t.lhs)} = {term(t.rhs)}"
    if isinstance(t, A.SomeDecl):
        return "some " + ", ".join(_var(n) for n in t.names)
    raise TypeError(f"cannot format {type(t).__name__}")


def _literal(lit: A.Literal) -> str:
    body = term(lit.expr)
    if lit.negated:
        body = f"not {body}"
    for w in lit.withs:
        body += f" with {'.'.join(w.target)} as {term(w.value)}"
    return body


def _compr_body(body: tuple) -> str:
    return "; ".join(_literal(l) for l in body)


def _rule_head(r: A.Rule) -> str:
    head = r.name
    if r.kind == "function":
        head += "(" + ", ".join(term(a) for a in r.args) + ")"
    elif r.kind == "partial_set":
        head += f"[{term(r.key)}]"
    elif r.kind == "partial_object":
        head += f"[{term(r.key)}]"
    if r.kind == "partial_object":
        head += f" = {term(r.value)}"
    elif r.value is not None and not (isinstance(r.value, A.Scalar)
                                      and r.value.value is True):
        head += f" = {term(r.value)}"
    if r.is_default:
        head = f"default {head}"
    return head


def format_rule(r: A.Rule) -> str:
    head = _rule_head(r)
    if not r.body:
        return head
    lines = [head + " {"]
    for lit in r.body:
        lines.append(f"  {_literal(lit)}")
    lines.append("}")
    return "\n".join(lines)


def format_module(m: A.Module) -> str:
    out = ["package " + ".".join(m.package)]
    for imp in m.imports:
        out.append("import " + ".".join(imp) if isinstance(imp, tuple)
                   else f"import {imp}")
    out.append("")
    for r in m.rules:
        out.append(format_rule(r))
        out.append("")
    return "\n".join(out).rstrip() + "\n"
