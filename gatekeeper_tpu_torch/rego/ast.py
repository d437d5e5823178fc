"""AST for the Rego subset used by Gatekeeper policy libraries.

Grammar coverage is driven by the corpus this framework must run: the 23
ConstraintTemplates of the reference policy library and the target matcher
library (reference: pkg/target/regolib/src.rego, library/**/src.rego), plus
their test suites (src_test.rego). That means: packages, default rules,
complete/function/partial-set/partial-object rules with multiple clauses,
bodies of literals with `not` / `some` / `with ... as` modifiers, full terms
(scalars, refs with dynamic brackets, arrays, objects, sets, array/set/object
comprehensions, calls), unification and `:=` assignment, comparison /
arithmetic / set binops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class Node:
    pass


# ---------------------------------------------------------------- terms


@dataclass(frozen=True)
class Scalar(Node):
    value: Any  # None | bool | int | float | str


@dataclass(frozen=True)
class Var(Node):
    name: str  # wildcards are renamed to unique "$wc<N>" by the parser


@dataclass(frozen=True)
class Ref(Node):
    """base[arg0][arg1]...; `a.b.c` sugar becomes string-scalar brackets."""

    base: Node  # Var or parenthesized term / Call
    args: tuple  # of term nodes; Scalar(str) for dotted access


@dataclass(frozen=True)
class ArrayLit(Node):
    items: tuple


@dataclass(frozen=True)
class ObjectLit(Node):
    items: tuple  # of (key_term, value_term)


@dataclass(frozen=True)
class SetLit(Node):
    items: tuple


@dataclass(frozen=True)
class ArrayCompr(Node):
    head: Node
    body: tuple  # of Literal


@dataclass(frozen=True)
class SetCompr(Node):
    head: Node
    body: tuple


@dataclass(frozen=True)
class ObjectCompr(Node):
    key: Node
    value: Node
    body: tuple


@dataclass(frozen=True)
class Call(Node):
    """fn(args...) — fn is a dotted name like ("re_match",) or ("glob","match")."""

    fn: tuple  # name path
    args: tuple


@dataclass(frozen=True)
class BinOp(Node):
    op: str  # == != < <= > >= + - * / % | &
    lhs: Node
    rhs: Node


@dataclass(frozen=True)
class UnaryMinus(Node):
    term: Node


# ---------------------------------------------------------------- literals


@dataclass(frozen=True)
class Assign(Node):
    lhs: Node
    rhs: Node


@dataclass(frozen=True)
class Unify(Node):
    lhs: Node
    rhs: Node


@dataclass(frozen=True)
class SomeDecl(Node):
    names: tuple  # of str


@dataclass(frozen=True)
class WithMod(Node):
    target: tuple  # ref path as names, e.g. ("input",) or ("data","inventory")
    value: Node


@dataclass(frozen=True)
class Literal(Node):
    expr: Node  # Assign | Unify | BinOp | Call | term | SomeDecl
    negated: bool = False
    withs: tuple = ()  # of WithMod
    line: int = 0


# ---------------------------------------------------------------- rules


@dataclass(frozen=True)
class Rule(Node):
    """One clause. Multiple clauses with the same name form a disjunction
    (partial rules union; complete/function rules must agree — OPA's
    "complete rules must not produce multiple outputs" semantics)."""

    name: str
    kind: str  # "complete" | "function" | "partial_set" | "partial_object"
    args: tuple = ()  # function formal-parameter terms
    key: Optional[Node] = None  # partial-set element / partial-object key
    value: Optional[Node] = None  # head value (None => Scalar(True))
    body: tuple = ()  # of Literal; () => always-true body
    is_default: bool = False
    line: int = 0


@dataclass(frozen=True)
class Module(Node):
    package: tuple  # of str, e.g. ("k8srequiredlabels",)
    imports: tuple = ()
    rules: tuple = ()
    source_name: str = "<module>"
