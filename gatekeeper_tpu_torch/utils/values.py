"""Immutable Rego value model.

Rego documents are JSON values plus sets. The interpreter (rego/interp.py)
and the vectorizing compiler (ir/) both operate on *frozen* values so they
can be hashed into sets, used as object keys, and interned into device
vocabularies (ops/strtab.py).

Representation:
  null    -> None
  bool    -> bool
  number  -> int | float  (ints kept exact, matching OPA's arbitrary precision
             for the magnitudes k8s policies use, e.g. mem_multiple("Ei"))
  string  -> str
  array   -> tuple
  object  -> FrozenDict
  set     -> frozenset

Reference semantics being mirrored: the OPA value model in
vendor/github.com/open-policy-agent/opa/ast/term.go (types Null, Boolean,
Number, String, Array, Object, Set) and its canonical sort ordering used by
sprintf("%v") output of sets.
"""

from __future__ import annotations

from typing import Any


class FrozenDict(dict):
    """Hashable, immutable dict used for Rego objects."""

    __slots__ = ("_hash",)

    def __hash__(self):  # type: ignore[override]
        h = getattr(self, "_hash", None)
        if h is None:
            h = hash(frozenset(self.items()))
            object.__setattr__(self, "_hash", h)
        return h

    def _immutable(self, *a, **k):
        raise TypeError("FrozenDict is immutable")

    __setitem__ = _immutable
    __delitem__ = _immutable
    clear = _immutable
    pop = _immutable
    popitem = _immutable
    setdefault = _immutable
    update = _immutable

    def __reduce__(self):
        # dict subclasses normally pickle by reconstruct-then-setitem,
        # which the immutability guard rejects; rebuild through the
        # constructor instead (the state-snapshot blob path pickles
        # whole frozen inventory trees)
        return (FrozenDict, (dict(self),))


def freeze(v: Any) -> Any:
    """Deep-freeze a JSON-ish Python value into the Rego value model."""
    if isinstance(v, dict):
        return FrozenDict((freeze(k), freeze(x)) for k, x in v.items())
    if isinstance(v, (list, tuple)):
        return tuple(freeze(x) for x in v)
    if isinstance(v, (set, frozenset)):
        return frozenset(freeze(x) for x in v)
    if isinstance(v, float) and v.is_integer() and abs(v) < 2**53:
        # json numbers like 2.0 canonicalize to ints, as OPA's ast.Number does
        return int(v)
    return v


def thaw(v: Any) -> Any:
    """Convert a frozen value back to plain JSON-able Python (sets -> sorted lists)."""
    if isinstance(v, FrozenDict):
        return {thaw(k): thaw(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return [thaw(x) for x in v]
    if isinstance(v, frozenset):
        return [thaw(x) for x in sorted(v, key=sort_key)]
    return v


# OPA canonical type order: null < bool < number < string < var < ref < array
# < object < set (ast/compare.go). We only need the value types.
_TYPE_RANK = {
    type(None): 0,
    bool: 1,
    int: 2,
    float: 2,
    str: 3,
    tuple: 4,
    FrozenDict: 5,
    frozenset: 6,
}


def type_name(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, tuple):
        return "array"
    if isinstance(v, FrozenDict):
        return "object"
    if isinstance(v, frozenset):
        return "set"
    raise TypeError(f"not a rego value: {type(v)!r}")


def sort_key(v: Any):
    """Total-order sort key across heterogeneous Rego values."""
    r = _TYPE_RANK[type(v)]
    if r == 0:
        return (0, 0)
    if r == 1:
        return (1, int(v))
    if r == 2:
        return (2, float(v))
    if r == 3:
        return (3, v)
    if r == 4:
        return (4, tuple(sort_key(x) for x in v))
    if r == 5:
        return (5, tuple(sorted((sort_key(k), sort_key(x)) for k, x in v.items())))
    return (6, tuple(sorted(sort_key(x) for x in v)))


def rego_eq(a: Any, b: Any) -> bool:
    """Type-aware equality: booleans never equal numbers (unlike Python)."""
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    return a == b


def format_value(v: Any, top: bool = True) -> str:
    """Go fmt `%v`-style rendering as OPA's sprintf produces it.

    Top-level strings print bare; nested strings are quoted; sets print as
    {elem, ...} in canonical order; objects as {"k": v, ...}. Mirrors message
    output of e.g. `sprintf("you must provide labels: %v", [missing])` in
    library/general/requiredlabels/src.rego.
    """
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        if isinstance(v, float):
            if v.is_integer():
                return str(int(v))
            return repr(v)
        return str(v)
    if isinstance(v, str):
        if top:
            return v
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, tuple):
        return "[" + ", ".join(format_value(x, top=False) for x in v) + "]"
    if isinstance(v, frozenset):
        items = sorted(v, key=sort_key)
        return "{" + ", ".join(format_value(x, top=False) for x in items) + "}"
    if isinstance(v, FrozenDict):
        items = sorted(v.items(), key=lambda kv: sort_key(kv[0]))
        return (
            "{"
            + ", ".join(
                f"{format_value(k, top=False)}: {format_value(x, top=False)}"
                for k, x in items
            )
            + "}"
        )
    raise TypeError(f"not a rego value: {type(v)!r}")
