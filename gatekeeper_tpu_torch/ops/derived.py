"""Derived vocab columns: pure unary functions as device lookup tables.

The TPU evaluator never runs scalar string/number functions per (object,
constraint) pair. Instead, a pure unary helper (canonify_cpu / canonify_mem
from library/general/containerlimits/src.rego, split parts, prefix strips)
is evaluated ONCE per interned vocab entry on the host — via the Rego
interpreter for module functions — and shipped to the device as columns
indexed by string id. The cross-product sweep then costs one gather, the
same hoisting trick the match tables use for string predicates
(ops/strtab.py): O(vocab) host work outside the hot loop instead of
O(objects × constraints) interpreted calls inside it (the reference's cost
shape, vendor/.../opa/topdown).

Columns extend lazily as the vocab grows, keyed by the same epoch scheme
as MatchTables.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from .strtab import StringTable, canon_num

UNDEF = object()

# kind codes mirrored from ir/prog.py (no import cycle: ops is below ir)
_K_ABSENT = 0
_K_NULL = 1
_K_FALSE = 2
_K_TRUE = 3
_K_NUM = 4
_K_STR = 5


def decode_vocab(s: str) -> Any:
    """Interned vocab entry -> the value it stands for. Numbers are
    interned as canonical "\\x01n<repr>" strings (strtab.canon_num)."""
    if s.startswith("\x01n"):
        body = s[2:]
        try:
            return int(body)
        except ValueError:
            return float(body)
    if s.startswith("\x00"):
        return UNDEF  # pad entry
    return s


def split_part(sep: str, i: int, k: int) -> Callable[[Any], Any]:
    """Part i of split(s, sep), defined only for exactly-k-part splits —
    the definedness of part 0 doubles as the destructure arity guard."""

    def fn(v: Any) -> Any:
        if not isinstance(v, str):
            return UNDEF
        parts = v.split(sep)
        if len(parts) != k:
            return UNDEF
        return parts[i]

    return fn


def strip_prefix(prefix: str) -> Callable[[Any], Any]:
    def fn(v: Any) -> Any:
        if not isinstance(v, str) or not v.startswith(prefix):
            return UNDEF
        return v[len(prefix):]

    return fn


def builtin_unary(name: str) -> Callable[[Any], Any]:
    """Host image of a unary Rego builtin (compile.py _BUILTIN_DERIVED,
    e.g. to_number — vendor/.../opa/topdown/casts.go). Raising -> UNDEF
    via materialize()'s exception guard."""
    from ..rego.builtins import BUILTINS

    return BUILTINS[(name,)]


class DerivedTables:
    """Per-driver cache of derived columns over the shared vocab.

    Chain-depth cap: derived OUTPUTS intern new vocab entries (canonical
    number strings, stripped prefixes, ...). Those entries themselves need
    derived coverage only when programs chain derived calls
    (to_number(canonify(x)) — DerivedVal base can be a DerivedVal), and
    chain depth is bounded by program nesting. Without a cap, each
    materialize pass would evaluate the fns over the previous pass's
    outputs and intern yet more entries — an unbounded vocab-growth loop
    (canonify outputs multiply by 1000 per generation) that also reshapes
    the match table and forces an XLA recompile EVERY audit."""

    MAX_CHAIN = 4

    def __init__(self, table: StringTable):
        self.table = table
        self._cols: dict[Any, int] = {}
        self._fns: list[Callable[[Any], Any]] = []
        self._data: list[dict[str, np.ndarray]] = []
        self._built: list[int] = []
        self._level: dict[int, int] = {}  # vocab id -> derivation depth
        # rows whose level just DROPPED (an output row later reached from
        # a shallower input — e.g. a level-4 chain artifact that a real
        # object value canonifies straight into): previously-skipped
        # entries must be re-evaluated or the device under-fires
        self._relower: set[int] = set()

    def _intern_out(self, s: str, level: int) -> int:
        new_level = level + 1
        before = len(self.table)
        i = self.table.intern(s)
        if i >= before:  # entry created by derived materialization
            self._level[i] = new_level
        elif self._level.get(i, 0) > new_level:
            self._level[i] = new_level
            self._relower.add(i)
        return i

    def col(self, key: Any, fn: Callable[[Any], Any]) -> int:
        c = self._cols.get(key)
        if c is None:
            c = len(self._fns)
            self._cols[key] = c
            self._fns.append(fn)
            self._data.append({
                "sid": np.zeros(0, dtype=np.int32),
                "num": np.zeros(0, dtype=np.float32),
                "nid": np.zeros(0, dtype=np.int32),
                "kind": np.zeros(0, dtype=np.int8),
            })
            self._built.append(0)
        return c

    def materialize(self, cols: list[int]) -> dict[int, dict[str, np.ndarray]]:
        """Extend the requested columns to the current vocab and return
        {col: {sid, num, nid, kind}} arrays of length V. Evaluating a fn
        may intern new output strings (growing the vocab); iterate to a
        fixpoint so chained derived programs (to_number(canonify(x)))
        see coverage for every base row, while the MAX_CHAIN depth cap
        keeps pure chain artifacts from growing the vocab forever. Rows
        whose level drops mid-pass (self._relower) are re-evaluated."""
        for _ in range(64):  # safety bound; the fixpoint is reached in
            changed = False  # chain-depth + 1 iterations
            for c in cols:
                changed |= self._extend_col(c)
            if self._relower:
                relower, self._relower = self._relower, set()
                for c in cols:
                    changed |= self._retry_col(c, relower)
                changed = True
            if not changed:
                break
        return {c: self._data[c] for c in cols}

    def _eval_row(self, c: int, i: int, arrs: dict, j: int) -> None:
        """Evaluate column c's fn for vocab row i into arrs at offset j."""
        level = self._level.get(i, 0)
        if level >= self.MAX_CHAIN:
            return  # depth cap: see class docstring
        v = decode_vocab(self.table.string(i))
        if v is UNDEF:
            return
        try:
            r = self._fns[c](v)
        except Exception:
            r = UNDEF
        if r is UNDEF:
            return
        if isinstance(r, bool):
            arrs["kind"][j] = _K_TRUE if r else _K_FALSE
            arrs["num"][j] = 1.0 if r else 0.0
        elif isinstance(r, (int, float)):
            arrs["kind"][j] = _K_NUM
            # clamp into f32 range rather than letting the cast overflow
            # to inf: distinct huge values collapse to the same f32 either
            # way (the nid tie-detection in evaljax keeps comparisons
            # over-firing), but inf would turn device arithmetic into nan
            # (inf - inf) which compares false on BOTH interval bounds —
            # an under-fire. Clamped values stay nan-free.
            arrs["num"][j] = min(max(float(r), -3.4e38), 3.4e38)
            arrs["nid"][j] = self._intern_out(canon_num(r), level)
        elif isinstance(r, str):
            arrs["kind"][j] = _K_STR
            arrs["sid"][j] = self._intern_out(r, level)
        elif r is None:
            arrs["kind"][j] = _K_NULL
        # arrays/objects: leave absent (no scalar image)

    def _extend_col(self, c: int) -> bool:
        V = len(self.table)
        built = self._built[c]
        if built >= V:
            return False
        n_new = V - built
        fresh = {
            "sid": np.zeros(n_new, dtype=np.int32),
            "num": np.full(n_new, np.nan, dtype=np.float32),
            "nid": np.zeros(n_new, dtype=np.int32),
            "kind": np.zeros(n_new, dtype=np.int8),
        }
        for j in range(n_new):
            i = built + j
            if i == 0:
                continue  # pad entry: absent
            self._eval_row(c, i, fresh, j)
        d = self._data[c]
        self._data[c] = {k: np.concatenate([d[k], fresh[k]])
                         for k in fresh}
        self._built[c] = V
        return True

    def _retry_col(self, c: int, rows: set[int]) -> bool:
        """Re-evaluate relowered rows already built as absent. Arrays are
        replaced (not mutated): device caches key on array identity."""
        built = self._built[c]
        todo = [i for i in rows
                if i < built and self._data[c]["kind"][i] == _K_ABSENT]
        if not todo:
            return False
        d = {k: a.copy() for k, a in self._data[c].items()}
        for i in todo:
            self._eval_row(c, i, d, i)
        self._data[c] = d
        return True


def interp_unary(module, name: str) -> Callable[[Any], Any]:
    """Host closure evaluating a module function of one argument via the
    Rego interpreter (the exact-semantics engine the host re-check uses)."""
    from ..rego.interp import Ctx, Interpreter, RegoError, UNDEF as R_UNDEF
    from ..utils.values import freeze, thaw

    interp = Interpreter({"m": module})

    def fn(v: Any) -> Any:
        ctx = Ctx(interp, None)
        try:
            r = interp._call_function(module.package, name, (freeze(v),), ctx)
        except RegoError:
            return UNDEF
        return UNDEF if r is R_UNDEF else thaw(r)

    return fn


def interp_pred(module, name: str, pattern_pos: int
                ) -> Callable[[str, list], np.ndarray]:
    """Match-table op closure for a binary boolean helper: rows are keyed
    by the pattern (parameter-side) string; the vector is the predicate
    over every vocab entry. pattern_pos says which formal receives the
    pattern."""
    from ..rego.interp import Ctx, Interpreter, RegoError, UNDEF as R_UNDEF
    from ..utils.values import freeze

    interp = Interpreter({"m": module})

    def op(pattern: str, strings: list) -> np.ndarray:
        out = np.zeros(len(strings), dtype=bool)
        fp = freeze(pattern)
        for i, s in enumerate(strings):
            v = decode_vocab(s)
            if v is UNDEF:
                continue
            args = (fp, freeze(v)) if pattern_pos == 0 else (freeze(v), fp)
            ctx = Ctx(interp, None)
            try:
                r = interp._call_function(module.package, name, args, ctx)
            except RegoError:
                continue
            out[i] = r is not R_UNDEF and r is not False
        return out

    return op
