"""Recursive-descent parser for the Rego subset (see ast.py for coverage).

Newline discipline: rule and comprehension bodies separate literals with
NEWLINE or `;`; inside any bracketed term context newlines are skipped. This
matches how the reference corpus formats multi-line calls, e.g. the
match_expression_violated(...) call spanning four lines in
pkg/target/regolib/src.rego.
"""

from __future__ import annotations

from .ast import (
    ArrayCompr,
    ArrayLit,
    Assign,
    BinOp,
    Call,
    Literal,
    Module,
    ObjectCompr,
    ObjectLit,
    Ref,
    Rule,
    Scalar,
    SetCompr,
    SetLit,
    SomeDecl,
    Unify,
    UnaryMinus,
    Var,
    WithMod,
)
from .scanner import Token, scan


class ParseError(SyntaxError):
    pass


_KEYWORDS = {"package", "import", "as", "not", "with", "some", "default", "else",
             "true", "false", "null"}

_CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}
_ADD_OPS = {"+", "-", "|", "&"}
_MUL_OPS = {"*", "/", "%"}


class Parser:
    def __init__(self, src: str, name: str = "<rego>"):
        self.toks: list[Token] = scan(src, name)
        self.pos = 0
        self.name = name
        self._wc = 0

    # ------------------------------------------------------------ plumbing

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "EOF":
            self.pos += 1
        return t

    def at(self, kind: str, value=None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value in ops

    def expect(self, kind: str, value=None) -> Token:
        t = self.peek()
        if t.kind != kind or (value is not None and t.value != value):
            raise ParseError(
                f"{self.name}:{t.line}: expected {value or kind}, got {t.kind}({t.value!r})"
            )
        return self.next()

    def skip_nl(self):
        while self.at("NEWLINE"):
            self.next()

    def err(self, msg: str):
        t = self.peek()
        raise ParseError(f"{self.name}:{t.line}: {msg} (at {t.kind}({t.value!r}))")

    # ------------------------------------------------------------ module

    def parse_module(self) -> Module:
        self.skip_nl()
        self.expect("IDENT", "package")
        package = tuple(self._parse_dotted_name())
        imports = []
        rules = []
        self.skip_nl()
        while self.at("IDENT", "import"):
            self.next()
            path = tuple(self._parse_dotted_name())
            alias = None
            if self.at("IDENT", "as"):
                self.next()
                alias = self.expect("IDENT").value
            imports.append((path, alias))
            self.skip_nl()
        while not self.at("EOF"):
            rules.append(self._parse_rule())
            self.skip_nl()
        return Module(package=package, imports=tuple(imports), rules=tuple(rules),
                      source_name=self.name)

    def _parse_dotted_name(self) -> list[str]:
        parts = [self.expect("IDENT").value]
        while self.at_op("."):
            self.next()
            t = self.peek()
            if t.kind in ("IDENT", "STRING"):
                parts.append(self.next().value)
            else:
                self.err("expected name segment")
        return parts

    # ------------------------------------------------------------ rules

    def _parse_rule(self) -> Rule:
        line = self.peek().line
        is_default = False
        if self.at("IDENT", "default"):
            self.next()
            is_default = True
        name_tok = self.expect("IDENT")
        name = name_tok.value
        if name in _KEYWORDS:
            self.err(f"keyword {name!r} cannot start a rule")

        if self.at_op("(") and not is_default:
            self.next()
            args = self._parse_term_list(")")
            value = None
            if self.at_op("=", ":="):
                self.next()
                value = self._parse_relation()
            body = self._parse_opt_body()
            return Rule(name=name, kind="function", args=tuple(args),
                        value=value or Scalar(True), body=body, line=line)

        if self.at_op("[") and not is_default:
            self.next()
            self.skip_nl()
            key = self._parse_relation()
            self.skip_nl()
            self.expect("OP", "]")
            if self.at_op("=", ":="):
                self.next()
                value = self._parse_relation()
                body = self._parse_opt_body()
                return Rule(name=name, kind="partial_object", key=key, value=value,
                            body=body, line=line)
            body = self._parse_opt_body()
            return Rule(name=name, kind="partial_set", key=key, body=body, line=line)

        value = None
        if self.at_op("=", ":="):
            self.next()
            value = self._parse_relation()
        body = () if is_default else self._parse_opt_body()
        return Rule(name=name, kind="complete", value=value or Scalar(True),
                    body=body, is_default=is_default, line=line)

    def _parse_opt_body(self) -> tuple:
        if self.at_op("{"):
            self.next()
            return self._parse_body("}")
        return ()

    def _parse_body(self, end_op: str) -> tuple:
        """Literals separated by NEWLINE/';' until the closing op (consumed)."""
        lits = []
        while True:
            while self.at("NEWLINE") or self.at_op(";"):
                self.next()
            if self.at_op(end_op):
                self.next()
                break
            if self.at("EOF"):
                self.err(f"unterminated body, expected {end_op}")
            lits.append(self._parse_literal())
            if not (self.at("NEWLINE") or self.at_op(";") or self.at_op(end_op)):
                self.err("expected end of expression")
        return tuple(lits)

    # ------------------------------------------------------------ literals

    def _parse_literal(self) -> Literal:
        line = self.peek().line
        if self.at("IDENT", "some"):
            self.next()
            names = [self.expect("IDENT").value]
            while self.at_op(","):
                self.next()
                names.append(self.expect("IDENT").value)
            return Literal(expr=SomeDecl(tuple(names)), line=line)
        negated = False
        if self.at("IDENT", "not"):
            self.next()
            negated = True
        expr = self._parse_expr()
        withs = []
        # `with` modifiers may start on a continuation line, and the term
        # after `as` may too (seen throughout the reference's src_test.rego
        # files) — look ahead through newlines for the `with` keyword
        while self.at("IDENT", "with") or self._nl_then_with():
            self.skip_nl()
            self.next()
            target = tuple(self._parse_with_target())
            self.expect("IDENT", "as")
            self.skip_nl()
            value = self._parse_relation()
            withs.append(WithMod(target=target, value=value))
        return Literal(expr=expr, negated=negated, withs=tuple(withs), line=line)

    def _nl_then_with(self) -> bool:
        k = 0
        while self.peek(k).kind == "NEWLINE":
            k += 1
        t = self.peek(k)
        return k > 0 and t.kind == "IDENT" and t.value == "with"

    def _parse_with_target(self) -> list:
        parts = [self.expect("IDENT").value]
        while True:
            if self.at_op("."):
                self.next()
                parts.append(self.expect("IDENT").value)
            elif self.at_op("["):
                self.next()
                parts.append(self.expect("STRING").value)
                self.expect("OP", "]")
            else:
                return parts

    def _parse_expr(self):
        lhs = self._parse_relation()
        if self.at_op(":="):
            self.next()
            return Assign(lhs=lhs, rhs=self._parse_relation())
        if self.at_op("="):
            self.next()
            return Unify(lhs=lhs, rhs=self._parse_relation())
        return lhs

    # ------------------------------------------------------------ terms

    def _parse_relation(self, stop_union: bool = False):
        lhs = self._parse_addsub(stop_union)
        if self.at_op(*_CMP_OPS):
            op = self.next().value
            rhs = self._parse_addsub(stop_union)
            return BinOp(op=op, lhs=lhs, rhs=rhs)
        return lhs

    def _parse_addsub(self, stop_union: bool = False):
        lhs = self._parse_muldiv()
        while self.at_op(*_ADD_OPS):
            if stop_union and self.at_op("|"):
                break
            op = self.next().value
            self.skip_nl()
            lhs = BinOp(op=op, lhs=lhs, rhs=self._parse_muldiv())
        return lhs

    def _parse_muldiv(self):
        lhs = self._parse_unary()
        while self.at_op(*_MUL_OPS):
            op = self.next().value
            self.skip_nl()
            lhs = BinOp(op=op, lhs=lhs, rhs=self._parse_unary())
        return lhs

    def _parse_unary(self):
        if self.at_op("-"):
            self.next()
            t = self._parse_unary()
            if isinstance(t, Scalar) and isinstance(t.value, (int, float)):
                return Scalar(-t.value)
            return UnaryMinus(t)
        return self._parse_postfix()

    def _parse_postfix(self):
        term = self._parse_primary()
        while True:
            if self.at_op("."):
                self.next()
                seg = self.expect("IDENT").value
                if self.at_op("("):
                    # dotted builtin call like glob.match(...)
                    fn = self._ref_to_name(term)
                    fn.append(seg)
                    self.next()
                    args = self._parse_term_list(")")
                    term = Call(fn=tuple(fn), args=tuple(args))
                    continue
                term = self._ref_append(term, Scalar(seg))
                continue
            if self.at_op("["):
                self.next()
                self.skip_nl()
                idx = self._parse_relation()
                self.skip_nl()
                self.expect("OP", "]")
                term = self._ref_append(term, idx)
                continue
            if self.at_op("("):
                fn = self._ref_to_name(term)
                self.next()
                args = self._parse_term_list(")")
                term = Call(fn=tuple(fn), args=tuple(args))
                continue
            return term

    def _ref_append(self, term, arg):
        if isinstance(term, Ref):
            return Ref(base=term.base, args=term.args + (arg,))
        return Ref(base=term, args=(arg,))

    def _ref_to_name(self, term) -> list:
        if isinstance(term, Var):
            return [term.name]
        if isinstance(term, Ref) and isinstance(term.base, Var):
            parts = [term.base.name]
            for a in term.args:
                if isinstance(a, Scalar) and isinstance(a.value, str):
                    parts.append(a.value)
                else:
                    self.err("function name must be a static dotted path")
            return parts
        self.err("cannot call a non-name term")

    def _parse_term_list(self, end_op: str) -> list:
        self.skip_nl()
        items = []
        if self.at_op(end_op):
            self.next()
            return items
        while True:
            items.append(self._parse_relation())
            self.skip_nl()
            if self.at_op(","):
                self.next()
                self.skip_nl()
                continue
            self.expect("OP", end_op)
            return items

    def _parse_primary(self):
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            return Scalar(t.value)
        if t.kind == "STRING":
            self.next()
            return Scalar(t.value)
        if t.kind == "IDENT":
            if t.value == "true":
                self.next()
                return Scalar(True)
            if t.value == "false":
                self.next()
                return Scalar(False)
            if t.value == "null":
                self.next()
                return Scalar(None)
            if t.value == "_":
                self.next()
                self._wc += 1
                return Var(f"$wc{self._wc}")
            if t.value == "not" or t.value == "some" or t.value == "with":
                self.err(f"unexpected keyword {t.value!r} in term")
            self.next()
            return Var(t.value)
        if t.kind == "OP" and t.value == "(":
            self.next()
            self.skip_nl()
            inner = self._parse_expr()
            self.skip_nl()
            self.expect("OP", ")")
            return inner
        if t.kind == "OP" and t.value == "[":
            self.next()
            self.skip_nl()
            if self.at_op("]"):
                self.next()
                return ArrayLit(())
            head = self._parse_relation(stop_union=True)
            self.skip_nl()
            if self.at_op("|"):
                self.next()
                body = self._parse_body("]")
                return ArrayCompr(head=head, body=body)
            items = [head]
            while self.at_op(","):
                self.next()
                self.skip_nl()
                if self.at_op("]"):
                    break
                items.append(self._parse_relation())
                self.skip_nl()
            self.expect("OP", "]")
            return ArrayLit(tuple(items))
        if t.kind == "OP" and t.value == "{":
            return self._parse_brace_term()
        self.err("expected a term")

    def _parse_brace_term(self):
        self.expect("OP", "{")
        self.skip_nl()
        if self.at_op("}"):
            self.next()
            return ObjectLit(())
        first = self._parse_relation(stop_union=True)
        self.skip_nl()
        if self.at_op(":"):
            self.next()
            self.skip_nl()
            value = self._parse_relation(stop_union=True)
            self.skip_nl()
            if self.at_op("|"):
                self.next()
                body = self._parse_body("}")
                return ObjectCompr(key=first, value=value, body=body)
            items = [(first, value)]
            while self.at_op(","):
                self.next()
                self.skip_nl()
                if self.at_op("}"):
                    break
                k = self._parse_relation()
                self.skip_nl()
                self.expect("OP", ":")
                self.skip_nl()
                v = self._parse_relation()
                items.append((k, v))
                self.skip_nl()
            self.expect("OP", "}")
            return ObjectLit(tuple(items))
        if self.at_op("|"):
            self.next()
            body = self._parse_body("}")
            return SetCompr(head=first, body=body)
        items = [first]
        while self.at_op(","):
            self.next()
            self.skip_nl()
            if self.at_op("}"):
                break
            items.append(self._parse_relation())
            self.skip_nl()
        self.expect("OP", "}")
        return SetLit(tuple(items))


def parse_module(src: str, name: str = "<rego>") -> Module:
    return Parser(src, name).parse_module()
