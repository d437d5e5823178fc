"""String intern table + pattern match tables.

The vectorized evaluator never touches raw strings on device: every string
in objects, parameters, and templates is interned to an int32 id, and
string predicates (startswith/endswith/contains/re_match/equality against
patterns) become boolean lookup tables `table[pattern_row, string_id]`
computed once per (pattern set, vocab epoch) and gathered on device.

This mirrors how the reference's hot loop spends its time — the OPA
topdown evaluator re-running string builtins per object per constraint
(vendor/.../opa/topdown, e.g. re_match at topdown/regex.go) — except the
work is hoisted out of the cross-product entirely: string predicates cost
O(vocab × patterns) once, then O(1) gathers inside the [objects ×
constraints] sweep.

Tables are built host-side with numpy here. The JAX package batches large
regex row extensions through a device byte-NFA scan; that scan is not part
of this package yet, so every regex row is built by the host re.search
loop below.
"""

from __future__ import annotations

import re
from typing import Any, Iterable

import numpy as np

PAD_ID = 0  # id 0 is reserved: "absent"; real strings start at 1


def escape_transform_arg(arg: str) -> str:
    """Escape a pattern-transform argument for embedding in an
    "<op>@<tag>:<arg>" op string ("@" delimits tags)."""
    return arg.replace("%", "%25").replace("@", "%40")


def _unescape_transform_arg(arg: str) -> str:
    return arg.replace("%40", "@").replace("%25", "%")


def canon_num(v) -> str:
    """Canonical string form of a number, interned so numeric equality on
    device is exact (f32 cells are approximate past 2^24)."""
    f = float(v)
    if f.is_integer() and abs(f) < 2**53:
        return "\x01n" + str(int(f))
    return "\x01n" + repr(f)


def vocab_cap(v: int) -> int:
    """Capacity bucket for vocab-indexed device arrays: padding to a
    power of two keeps their SHAPES stable while the vocab grows, so a
    single new interned string does not recompile every jitted sweep
    (XLA kernels are shape-specialized)."""
    c = 256
    while c < v:
        c *= 2
    return c


class StringTable:
    """Append-only intern table. Ids are stable for the life of the table;
    `epoch` increments on growth so cached match tables know to extend."""

    def __init__(self):
        self._ids: dict[str, int] = {}
        self._strs: list[str] = ["\x00<pad>"]  # id 0 placeholder
        self.epoch = 0

    def __len__(self) -> int:
        return len(self._strs)

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strs)
            self._ids[s] = i
            self._strs.append(s)
            self.epoch += 1
        return i

    def intern_many(self, ss: Iterable[str]) -> list[int]:
        return [self.intern(s) for s in ss]

    def lookup(self, s: str) -> int:
        """Id of s, or PAD_ID if never interned (≠ any real string)."""
        return self._ids.get(s, PAD_ID)

    def snapshot(self) -> tuple[int, int]:
        """(size, epoch) marker. Interning is append-only — ids handed
        out before a snapshot are NEVER reassigned — so caches holding
        encoded rows stay valid across vocab growth and only need to
        extend vocab-indexed tables past the snapshot size (the
        incremental audit patches dirty rows against exactly this
        invariant)."""
        return (len(self._strs), self.epoch)

    def grown_since(self, snap: tuple[int, int]) -> int:
        """How many strings were interned after `snap` was taken (the
        per-sweep vocab-growth signal the audit metrics report)."""
        return len(self._strs) - snap[0]

    def string(self, i: int) -> str:
        return self._strs[i]

    def dump(self) -> list[str]:
        """All interned strings in id order (excluding the pad entry) —
        the warm-restart vocab snapshot. Restoring this list on a fresh
        table reproduces the exact id assignment, so persisted encoded
        rows (which hold int32 ids) and vocab-capacity-bucketed program
        shapes stay valid across process restarts."""
        return list(self._strs[1:])

    def restore(self, strings: Iterable[str]) -> None:
        """Re-intern a dump() onto a FRESH table. Refuses on a table
        that already interned anything: ids are append-only and already
        handed out, so replaying an old vocab underneath them would
        silently remap every existing id."""
        if len(self._strs) != 1:
            raise ValueError("vocab restore requires a fresh StringTable")
        for s in strings:
            if not isinstance(s, str):
                raise ValueError("vocab snapshot entries must be strings")
            self.intern(s)

    def bytes_tensor(self, max_len: int = 128) -> np.ndarray:
        """[V, max_len] uint8, zero-padded — the vocab as a byte matrix
        (the input of a device regex scan)."""
        out = np.zeros((len(self._strs), max_len), dtype=np.uint8)
        for i, s in enumerate(self._strs):
            if i == 0:
                continue
            b = s.encode("utf-8")[:max_len]
            out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        return out


class MatchTables:
    """Cache of boolean match vectors over the vocab, one row per
    (op, pattern) pair. Rows extend lazily as the vocab grows.

    Every row, regex rows included, is built on the host (re.search for
    re_match/glob, numpy string ops for the string family)."""

    # pattern-side transforms: "<op>@trim:<cutset>" applies the transform
    # to the pattern string at row-creation time (rego trim/trim_prefix/…
    # wrapped around a parameter pattern, e.g. forbidden-sysctls). Args are
    # %-escaped (see escape_transform_arg) so cutsets containing "@" can't
    # corrupt the tag encoding. Rego trim(s, "") strips nothing, so an
    # empty cutset is the identity (not Python's whitespace strip).
    TRANSFORMS = {
        "trim": lambda v, arg: v.strip(arg) if arg else v,
        "lower": lambda v, arg: v.lower(),
        "upper": lambda v, arg: v.upper(),
        "trim_prefix": lambda v, arg: v[len(arg):]
        if arg and v.startswith(arg) else v,
        "trim_suffix": lambda v, arg: v[: -len(arg)]
        if arg and v.endswith(arg) else v,
    }

    def __init__(self, table: StringTable):
        self.table = table
        self._rows: dict[tuple[str, str], int] = {}
        self._patterns: list[tuple[str, str]] = []
        self._data: list[np.ndarray] = []  # per row, bool[V_at_build]
        self._built_len: list[int] = []
        self._packed_cache: np.ndarray | None = None
        self._packed_key: tuple | None = None
        self._custom: dict[str, Any] = {}  # op -> fn(pattern, strings)->bool[]
        # per-materialize window caches: (built, V) -> decoded string
        # list / fixed-width unicode array. Without these, every row
        # re-decodes the same vocab window (O(rows × vocab) Python), and
        # the string-family ops loop per string; with them, decoding is
        # amortized across rows and startswith/endswith/contains/eq run
        # as numpy C loops over the whole window at once
        self._win_strs: dict[tuple[int, int], list] = {}
        self._win_arr: dict[tuple[int, int], np.ndarray] = {}

    def register_op(self, op: str, fn) -> None:
        """Custom predicate op (interpreter-backed binary helpers,
        ops/derived.py interp_pred). Idempotent per op name."""
        self._custom.setdefault(op, fn)

    def row(self, op: str, pattern: str) -> int:
        """Row index for (op, pattern); builds the vector on first use.
        op may carry @transform tags applied to the pattern here, so
        transformed patterns share rows with directly-written ones."""
        if "@" in op:
            op, _, tags = op.partition("@")
            for tag in tags.split("@"):
                name, _, arg = tag.partition(":")
                fn = self.TRANSFORMS.get(name)
                if fn is None:
                    raise ValueError(f"unknown pattern transform {name!r}")
                if isinstance(pattern, str):
                    pattern = fn(pattern, _unescape_transform_arg(arg))
        key = (op, pattern)
        r = self._rows.get(key)
        if r is None:
            r = len(self._patterns)
            self._rows[key] = r
            self._patterns.append(key)
            self._data.append(np.zeros(0, dtype=bool))
            self._built_len.append(0)
        return r

    def _window(self, built: int, V: int) -> list:
        """Decoded vocab strings [built, V), shared across rows."""
        key = (built, V)
        win = self._win_strs.get(key)
        if win is None:
            if len(self._win_strs) > 8:  # windows die with their epoch
                self._win_strs.clear()
                self._win_arr.clear()
            win = [self.table.string(i) for i in range(built, V)]
            self._win_strs[key] = win
        return win

    # fixed-width unicode arrays cost O(window × max_len); past this
    # length the vectorization win can't pay for the padding memory
    MAX_VECTOR_STRLEN = 512

    def _window_arr(self, built: int, V: int, strings: list[str]):
        """Fixed-width unicode array of the window, for the vectorized
        string-family ops (np.char runs the comparison as one C loop
        instead of a Python generator per row). None when an oversize
        string makes the padded array a bad trade — callers then keep
        the per-string host path."""
        key = (built, V)
        if key in self._win_arr:
            return self._win_arr[key]
        arr = None
        if strings:
            if max(len(s) for s in strings) <= self.MAX_VECTOR_STRLEN:
                arr = np.array(strings, dtype=str)
        else:
            arr = np.zeros(0, dtype="U1")
        self._win_arr[key] = arr
        return arr

    @staticmethod
    def glob_regex(pattern: str) -> str:
        """Image-ref style glob ('*' wildcard only) as an anchored
        regex — the single source of truth for both the host path and
        the device NFA batch."""
        return ("^" + ".*".join(re.escape(p) for p in pattern.split("*"))
                + "$")

    def _eval(self, op: str, pattern: str, strings: list[str],
              arr: np.ndarray | None = None) -> np.ndarray:
        if op in self._custom:
            return np.asarray(self._custom[op](pattern, strings), dtype=bool)
        if op in ("startswith", "endswith", "contains", "eq") and \
                arr is not None:
            if op == "startswith":
                return np.char.startswith(arr, pattern)
            if op == "endswith":
                return np.char.endswith(arr, pattern)
            if op == "contains":
                return np.char.find(arr, pattern) >= 0 if pattern else \
                    np.ones(len(strings), dtype=bool)
            return arr == pattern
        if op == "startswith":
            return np.fromiter((s.startswith(pattern) for s in strings),
                               dtype=bool, count=len(strings))
        if op == "endswith":
            return np.fromiter((s.endswith(pattern) for s in strings),
                               dtype=bool, count=len(strings))
        if op == "contains":
            return np.fromiter((pattern in s for s in strings),
                               dtype=bool, count=len(strings))
        if op == "eq":
            return np.fromiter((s == pattern for s in strings),
                               dtype=bool, count=len(strings))
        if op == "re_match":
            try:
                rx = re.compile(pattern)
            except re.error:
                return np.zeros(len(strings), dtype=bool)
            return np.fromiter((rx.search(s) is not None for s in strings),
                               dtype=bool, count=len(strings))
        if op == "glob":
            rx = re.compile(self.glob_regex(pattern))
            return np.fromiter((rx.search(s) is not None for s in strings),
                               dtype=bool, count=len(strings))
        raise ValueError(f"unknown match op {op!r}")

    def materialize_packed(self) -> np.ndarray:
        """[V, W] uint32 — bit r of word w set iff pattern row (w*32+r)
        matches the string. The device predicate is then a single fused
        int32 AND against a per-row bitmask (no extra broadcast dim).

        Cached until the vocab or pattern set grows, so steady-state audits
        reuse the same ndarray (and JAX skips re-uploading the buffer)."""
        key = (self.table.epoch, len(self._patterns))
        if self._packed_cache is not None and self._packed_key == key:
            return self._packed_cache
        table = self.materialize()  # [R, V]
        R, V = table.shape
        W = max(1, (R + 31) // 32)
        cap = vocab_cap(V)  # stable shape under vocab growth
        bits = np.zeros((cap, W * 32), dtype=bool)
        bits[:V, :R] = table.T
        weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint64)
        words = (bits.reshape(cap, W, 32).astype(np.uint64) * weights).sum(
            axis=-1).astype(np.uint32)
        self._packed_cache = words
        self._packed_key = key
        return words

    def materialize(self) -> np.ndarray:
        """[R, V] bool — all rows, padded/extended to the current vocab.

        OPA semantics note: re_match is anchored like Go's regexp.MatchString
        (unanchored search), mirrored by using re.search above.
        """
        V = len(self.table)
        R = max(1, len(self._patterns))
        out = np.zeros((R, V), dtype=bool)
        for r, (op, pattern) in enumerate(self._patterns):
            built = self._built_len[r]
            if built < V:
                strings = self._window(built, V)
                arr = self._window_arr(built, V, strings)
                new = self._eval(op, pattern, strings, arr=arr)
                if built == 0:
                    # row 0 of the vocab is the pad entry: never matches
                    new[0] = False
                self._data[r] = np.concatenate([self._data[r], new])
                self._built_len[r] = V
            out[r, : self._built_len[r]] = self._data[r]
        return out
