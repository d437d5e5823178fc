"""Vectorized policy IR.

A compiled template is a `Program`: extraction slots describing what to
pull out of each review object, parameter slots describing what to encode
per constraint, and clauses — tri-state boolean expressions over the
implicit axes N (objects) × C (constraints) plus small iteration axes
(container lists, label maps, parameter lists).

The device program answers ONE question per (object, constraint) pair:
"does at least one violation clause fire?" — the 99.99%-reject filter of
the audit/admission cross-product. Messages and details for firing pairs
are materialized host-side by the reference interpreter, which guarantees
exact parity with the reference's topdown semantics (regolib/src.go hook
join) while keeping strings off the device entirely.

Correctness invariant (enforced by differential tests): the compiled
filter must never UNDER-fire relative to the interpreter. Templates whose
rego falls outside the compilable subset fall back per-template to the
interpreter driver.

Value model on device (see ops/strtab.py): strings are interned int32 ids;
string predicates are [pattern, vocab] table lookups; numbers are f32;
value kinds are int8 codes so undefined-vs-false tri-state survives
vectorization (SURVEY.md §7 hard part 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

# value kind codes stored per extracted cell
K_ABSENT = 0
K_NULL = 1
K_FALSE = 2
K_TRUE = 3
K_NUM = 4
K_STR = 5
K_ARR = 6
K_OBJ = 7


# ------------------------------------------------------------------- slots


@dataclass(frozen=True)
class Seg:
    """One path segment: a fixed field or an iteration axis (iteration
    covers both arrays — integer keys — and objects — string keys)."""

    kind: str  # "field" | "iter"
    name: str = ""  # field name for "field"
    axis: str = ""  # axis id for "iter"


@dataclass(frozen=True)
class ObjSlotSpec:
    """What to extract from each review. root: "object" | "oldObject" |
    "review" (the review dict itself, for kind.kind etc.).

    mode:
      "scalar"  — value at path (last seg may be an axis -> [N,K] values)
      "entries" — map at path iterated: key ids + value cells [N,K]
      "count"   — number of children of the collection at path [N]
    """

    slot: int
    root: str
    segs: tuple  # of Seg
    mode: str = "scalar"


@dataclass(frozen=True)
class ParamSlotSpec:
    """What to encode per constraint from spec.parameters.

    segs address into the parameters document; a "list" seg iterates a
    parameter array (the P dim). mode "scalar" (P=1) or "list" [C,P] or
    "count".

    pattern_ops: string-match ops this slot's values are used as patterns
    for — the encoder interns a match-table row per (op, value) and stores
    row indices alongside ids (MatchLookup gathers them on device).
    """

    slot: int
    segs: tuple  # of Seg
    mode: str = "scalar"
    pattern_ops: tuple = ()


# ------------------------------------------------------------------ exprs


@dataclass(frozen=True)
class Expr:
    pass


@dataclass(frozen=True)
class OVal(Expr):
    """Object slot leaf. field: "id" | "num" | "kind" | "key" | "count".
    axis None -> scalar slot (K broadcast)."""

    slot: int
    f: str = "id"
    axis: Optional[str] = None


@dataclass(frozen=True)
class PVal(Expr):
    """Param slot leaf. field: "id" | "num" | "kind" | "count" | "row:<op>"."""

    slot: int
    f: str = "id"
    axis: Optional[str] = None


@dataclass(frozen=True)
class Const(Expr):
    kind: str  # "id" | "num" | "bool"
    value: Union[int, float, bool]


@dataclass(frozen=True)
class Cmp(Expr):
    """Comparison. dtype "id" (string equality) or "num". Defined iff both
    sides are defined with the right kind."""

    op: str  # eq ne lt le gt ge
    lhs: Expr
    rhs: Expr
    dtype: str = "num"


@dataclass(frozen=True)
class MatchLookup(Expr):
    """match_table[row, id] — string predicate against a pattern row."""

    row: Expr  # row index (PVal row:<op> or Const row)
    sid: Expr  # string id expr


@dataclass(frozen=True)
class DerivedVal(Expr):
    """derived_columns[col] gathered at the base cell's intern id (sid for
    strings, nid for numbers) — the device image of a pure unary function
    (canonify_cpu/canonify_mem, split parts, prefix strips) precomputed
    host-side over the vocab (ops/derived.py). Kind K_ABSENT where the
    function is undefined for that input."""

    col: int  # index into Program.derived
    base: Expr


@dataclass(frozen=True)
class KindIs(Expr):
    """cell.kind ∈ kinds, as a boolean (always defined)."""

    e: Expr
    kinds: tuple  # of int kind codes


@dataclass(frozen=True)
class Arith(Expr):
    """Numeric arithmetic over value intervals. Results are widened by an
    f32-rounding epsilon so threshold comparisons over-fire instead of
    under-firing (host re-check is exact)."""

    op: str  # "add" | "sub" | "mul"
    lhs: Expr
    rhs: Expr


@dataclass(frozen=True)
class Truthy(Expr):
    """Rego body-literal success of a value: defined and not false."""

    e: Expr


@dataclass(frozen=True)
class Exists(Expr):
    """Definedness of a value as a boolean (always defined itself)."""

    e: Expr


@dataclass(frozen=True)
class And(Expr):
    items: tuple


@dataclass(frozen=True)
class Or(Expr):
    items: tuple


@dataclass(frozen=True)
class Not(Expr):
    """Rego negation: succeeds when e is undefined or false. Axes listed in
    `local_axes` are existentially reduced inside the negation (wildcards
    first bound under `not`)."""

    e: Expr
    local_axes: tuple = ()


@dataclass(frozen=True)
class OrReduce(Expr):
    """∃ axis: presence(axis) ∧ e. Always defined (empty -> false)."""

    axis: str
    e: Expr


@dataclass(frozen=True)
class SumReduce(Expr):
    """Σ over axis of (presence ∧ e) as a number. Always defined."""

    axis: str
    e: Expr


# ------------------------------------------------------------------ clauses


@dataclass(frozen=True)
class Axis:
    """Iteration axis. kind "obj" (bound to an object slot's K dim) or
    "param" (a parameter list's P dim). presence comes from the owning
    slot's kind/cell masks."""

    name: str
    kind: str  # "obj" | "param"
    slot: int  # owning ObjSlotSpec.slot / ParamSlotSpec.slot


@dataclass(frozen=True)
class Guard:
    expr: Expr
    negated: bool = False


@dataclass(frozen=True)
class Clause:
    axes: tuple  # of Axis — positively-bound; reduced jointly at clause level
    guards: tuple  # of Guard


@dataclass(frozen=True)
class DerivedSpec:
    """One derived column the program needs. kind:
      "fn"           — arg = module function name, host-evaluated by the
                       interpreter per vocab entry
      "split"        — arg = "<sep>|<i>|<k>": part i of split(s, sep),
                       defined only when the split has exactly k parts
      "strip_prefix" — arg = prefix; s minus prefix, undefined otherwise
    """

    col: int
    kind: str
    arg: str


@dataclass(frozen=True)
class Program:
    """One compiled template."""

    kind: str  # template Kind (constraint kind)
    obj_slots: tuple  # of ObjSlotSpec
    param_slots: tuple  # of ParamSlotSpec
    clauses: tuple  # of Clause
    # every axis in the program (clause-level AND reduce-internal), by name
    axes: tuple = ()  # of Axis
    derived: tuple = ()  # of DerivedSpec
    # interpreted binary predicates: (match op name, module function name);
    # the driver registers each op with MatchTables before evaluation
    pred_ops: tuple = ()

    def axis_table(self) -> dict[str, Axis]:
        return {a.name: a for a in self.axes}
