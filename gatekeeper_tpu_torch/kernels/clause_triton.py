"""K2 on Hopper: one generated Triton kernel per template and shape.

Replaces the JAX package's per-template device program
(gatekeeper_tpu/ir/evaljax.py: CompiledTemplate._eval -> _eval_clause /
_eval_bool / _eval_num / _eval_cell, with the bit-pack body of _scan_jit)
that XLA fused for the TPU. The Program IR is only known when a
ConstraintTemplate is ingested, so this module walks the resolved Program
and its ClausePlans (kernels/clause.py) and writes the Triton source of a
kernel that evaluates it: each program instance covers BLOCK_N object
rows x BC constraint columns (WPP words of 32, or one narrower word),
evaluates every clause with loops over the static iteration-axis sizes
(in place of the JAX layout's [N, axes..., C] dims), ORs the clauses and
packs each word's columns into one int32 per row. The loops stay loops
(scf.for, accumulators of the full tile): unrolling them multiplied the
compile time.

Bound: operations. Per (row, constraint) cell the JAX program does one
pass of its clause body per iteration-axis trip; that count (the
"pair-trips", `clause.clause_work`, read from the Program IR and the leaf
shapes, never from this emitter) over the card's 67 TOP/s outweighs the
bytes (every input leaf read once, the [N, W] words written once) at the
shapes the audits use. Nothing goes to the tensor cores, and the
[N, axes..., C] intermediates never exist. `emitted_ops` counts what the
emitted source itself does; it is a design diagnostic, not a bound.

Design, against what held the first version back (one generic cell
equality per trip, parameter work inside object loops, a fixed 32 x 32
tile whose ROW work every thread repeated):
  * Loop-invariant code motion in the emitter. Every value records the
    loop level where its last loop variable is bound and is emitted there
    (`_Emitter.let(level)`), so a value of the parameter side (COL) is
    computed once per program and parameter trip, and a value of the
    object side (ROW) once per row block and object trip; only the
    pairwise (FULL) work runs in the innermost loop. The free loops of a
    clause run parameter axes outermost, so the object loads and their
    ROW work sit innermost.
  * Each operand of an auto-typed `Cmp` is canonicalised once, outside
    the pairwise work: a kind code with a per-side sentinel for absent
    (so kind equality implies both defined), one comparable id (sid for
    strings, nid for numbers, 0 otherwise) and, where the kind can be an
    array or an object, a "not maybe" flag. The pairwise work is then two
    compares and an AND (plus one AND or XOR per BPair half), and it gives
    the plain `_cell_eq`'s (lo, hi) bits exactly (see `_cmp_auto`). A
    `MatchLookup` folds its `defined` test into the two operands of its
    bit test (the word of a non-string and the bit of a negative pattern
    row are 0), and with a one-word match table its gather is ROW-shaped.
    A clause ANDs its guards and axis presences shape by shape, so a ROW
    or COL factor costs one FULL operation at most. Numeric compares
    (with the nid tie rule), derived-column gathers and Arith keep the
    first version's code.
  * The tile is laid out [BC, BLOCK_N], columns x rows, so Triton's
    default layout puts a warp's lanes on rows and a ROW value costs each
    thread one register (rows x columns, the first version's layout, put
    the lanes on columns and made every thread repeat the row block's ROW
    work). Its sizes, `CONFIG`, were chosen by measurement on the H100
    (PERF.md; `chip_smoke.py --tune` at the config-4 flagship slab, config
    6's 16 templates at their 50,000-pod shapes and the 21 templates at
    the corpus shapes): few elements a thread, since the hoisted COL
    values stay live across the object loops and registers, not
    operations, limited the wider tiles (occupancy); and a template with
    C < 32 takes a narrow word of C columns (rounded up to a power of
    two) and more rows instead of 32 columns it would leave empty.
  * Not done: object values are loaded per object trip as [1, BLOCK_N]
    vectors of one slot, rows L * 4 bytes apart (each lane its own row;
    L1 serves the later trips), not as one coalesced 2-D [BLOCK_N, L]
    tile per program: Triton cannot index a register tile with a loop
    variable, selecting a slot with where + sum costs L operations a row
    (and loses the sign of a float zero), and unrolling the object loops
    over static slots multiplies the compile time.

The emitter mirrors the plain version's structure expression by
expression, including which BPair subtrees are exact (lo `is` hi); a
BPair whose two halves are the very same emitted value is exact too,
which changes no bit. The kernel launches with enable_fp_fusion=False:
the JAX program rounds Arith's products and sums separately, and a fused
multiply-add could move a threshold comparison by one ulp.

Triton reads a @triton.jit function's source with `inspect`, so each
generated kernel is written to a .py file under _build/ and imported;
`import triton` happens inside `launch`, never at import time.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import sys

import numpy as np

from ..ir.prog import (
    K_ABSENT,
    K_ARR,
    K_FALSE,
    K_NUM,
    K_OBJ,
    K_STR,
    K_TRUE,
    And,
    Arith,
    Cmp,
    Const,
    DerivedVal,
    Exists,
    KindIs,
    MatchLookup,
    Not,
    Or,
    OrReduce,
    OVal,
    PVal,
    SumReduce,
    Truthy,
)
from .build import build_dir
from .clause import EvalError, feat_rows, param_c

# (BLOCK_N rows, at most WPP words per program, num_warps, narrow tile
# elements): see the module docstring and PERF.md for the measurement
# that chose them. A template with C < 32 constraints takes BC = C
# rounded up to a power of two (at least 2) and as many rows as keep the
# tile at the narrow element count.
CONFIG = (8, 2, 4, 256)


# value shapes: a bitmask of the tile dims a value spans
SCALAR, ROW, COL, FULL = 0, 1, 2, 3

# the absent-kind sentinels of the two sides of a canonicalised compare:
# negative, so never a kind code, and different, so never equal
_UNDEF = (-1, -2)


class G:
    """One generated value: a Triton expression (`code`) or a Python
    constant (`const`), spanning `shape` (SCALAR, ROW = the row block's
    dim, COL = the columns' dim, or FULL), available from loop `level` on
    (0 = the program's top level). Object identity stands for JAX array
    identity when exactness (lo `is` hi) is decided; a BP also treats
    two Gs of one temporary as the same value (see BP)."""

    __slots__ = ("code", "const", "shape", "level")

    def __init__(self, code=None, const=None, shape=SCALAR, level=0):
        self.code = code
        self.const = const
        self.shape = shape if code is not None else SCALAR
        self.level = level if code is not None else 0

    @property
    def is_const(self) -> bool:
        return self.code is None


class BP:
    """A BPair of Gs. Both halves naming one temporary are the very same
    value, so the pair is exact. That holds for the `t<n>` temporaries,
    each bound once; an accumulator (`acc<n>`) is re-bound in its loop
    and only its own G object stands for it."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: G, hi: G):
        self.lo = lo
        if lo.is_const:
            same = hi.is_const and lo.const is hi.const
        else:
            same = lo is hi or (lo.code == hi.code
                                and not lo.code.startswith("acc"))
        self.hi = lo if same else hi

    @staticmethod
    def exact(v: G) -> "BP":
        return BP(v, v)

    @property
    def is_exact(self) -> bool:
        return self.lo is self.hi


def _f32(v) -> float:
    return float(np.float32(v))


def _lv(*gs) -> int:
    return max((g.level for g in gs), default=0)


class _Frame:
    """One loop body (or the program's top level): its lines, in order,
    with nested loops as _Frame items; the common subexpressions bound in
    it; and its trip count times its parents'."""

    __slots__ = ("header", "lines", "cache", "trips")

    def __init__(self, header, trips: int):
        self.header = header
        self.lines: list = []
        self.cache: dict = {}
        self.trips = trips


class _Emitter:
    """Writes one kernel body. `leaf` maps (space, slot, name) to its
    kernel argument and array shape; space is "f" (features), "p"
    (parameters), "d" (derived columns) or "t" (match table)."""

    def __init__(self, leaves: dict, block_n: int, cols: int):
        self.leaves = leaves
        self.frames = [_Frame(None, 1)]
        self.var_level: dict = {}
        self.ntmp = 0
        self.elems = {SCALAR: 1, ROW: block_n, COL: cols,
                      FULL: block_n * cols}
        # elementwise operations one program instance performs: each
        # statement's tile elements times the trip counts around it
        self.ops = 0

    # ---------------------------------------------------------- plumbing

    @property
    def level(self) -> int:
        return len(self.frames) - 1

    def emit(self, line: str, level: int | None = None) -> None:
        """Append `line` to loop `level`'s body (default: the innermost
        open loop). A line for an outer level goes just before that
        level's open inner loop, after every line it can depend on."""
        lv = self.level if level is None else level
        fr = self.frames[lv]
        if lv < self.level:
            fr.lines.insert(len(fr.lines) - 1, line)
        else:
            fr.lines.append(line)

    def fresh(self, stem: str = "t") -> str:
        self.ntmp += 1
        return f"{stem}{self.ntmp}"

    def count(self, shape: int, level: int | None = None) -> None:
        lv = self.level if level is None else level
        self.ops += self.elems[shape] * self.frames[lv].trips

    def let(self, code: str, shape: int, level: int) -> G:
        """Bind `code` to a temporary at loop `level` (common
        subexpressions there share one; each call still returns a new G,
        as each jnp op makes a new array)."""
        fr = self.frames[level]
        name = fr.cache.get(code)
        if name is None:
            name = self.fresh()
            self.emit(f"{name} = {code}", level)
            self.count(shape, level)
            fr.cache[code] = name
        return G(name, shape=shape, level=level)

    def open_loop(self, var: str, trips: int) -> None:
        fr = _Frame(f"for {var} in range({trips}):",
                    self.frames[-1].trips * trips)
        self.frames[-1].lines.append(fr)
        self.frames.append(fr)
        self.var_level[var] = self.level

    def close_loop(self) -> None:
        self.frames.pop()

    def render(self) -> list[str]:
        out: list[str] = []

        def walk(fr: _Frame, depth: int) -> None:
            for item in fr.lines:
                if isinstance(item, _Frame):
                    out.append("    " * depth + item.header)
                    walk(item, depth + 1)
                else:
                    out.append("    " * depth + item)

        walk(self.frames[0], 1)
        return out

    @staticmethod
    def c(g: G) -> str:
        if not g.is_const:
            return g.code
        v = g.const
        if isinstance(v, (bool, np.bool_)):
            raise EvalError("boolean constant reached emitted code")
        if isinstance(v, (int, np.integer)):
            return str(int(v))
        v = float(v)
        if v != v:
            return "NAN_F"
        if v == float("inf"):
            return "INF_F"
        if v == -float("inf"):
            return "(-INF_F)"
        return repr(v)

    # ------------------------------------------------------- value ops

    def _op(self, code: str, *gs: G) -> G:
        shape = 0
        for g in gs:
            shape |= g.shape
        return self.let(code, shape, _lv(*gs))

    def band(self, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            return G(const=bool(a.const) and bool(b.const))
        if (a.is_const and not a.const) or (b.is_const and not b.const):
            return G(const=False)
        if a.is_const:
            return G(b.code, shape=b.shape, level=b.level)
        if b.is_const:
            return G(a.code, shape=a.shape, level=a.level)
        return self._op(f"{a.code} & {b.code}", a, b)

    def bor(self, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            return G(const=bool(a.const) or bool(b.const))
        if (a.is_const and a.const) or (b.is_const and b.const):
            return G(const=True)
        if a.is_const:
            return G(b.code, shape=b.shape, level=b.level)
        if b.is_const:
            return G(a.code, shape=a.shape, level=a.level)
        return self._op(f"{a.code} | {b.code}", a, b)

    def bxor(self, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            return G(const=bool(a.const) != bool(b.const))
        if a.is_const or b.is_const:
            k, v = (a, b) if a.is_const else (b, a)
            return self.bnot(v) if k.const else \
                G(v.code, shape=v.shape, level=v.level)
        return self._op(f"{a.code} ^ {b.code}", a, b)

    def bnot(self, a: G) -> G:
        if a.is_const:
            return G(const=not bool(a.const))
        return self._op(f"~{a.code}", a)

    def cmp(self, op: str, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            x, y = a.const, b.const
            return G(const=bool({"<": x < y, "<=": x <= y, ">": x > y,
                                 ">=": x >= y, "==": x == y,
                                 "!=": x != y}[op]))
        return self._op(f"{self.c(a)} {op} {self.c(b)}", a, b)

    def isnan(self, a: G) -> G:
        if a.is_const:
            return G(const=bool(a.const != a.const))
        return self._op(f"{a.code} != {a.code}", a)

    def where(self, cond: G, a: G, b: G) -> G:
        if cond.is_const:
            src = a if cond.const else b
            return G(src.code, src.const, src.shape, src.level)
        return self._op(f"tl.where({cond.code}, {self.c(a)}, {self.c(b)})",
                        cond, a, b)

    def farith(self, op: str, a: G, b: G) -> G:
        """f32 arithmetic; constants fold in f32 (as the device would)."""
        if a.is_const and b.is_const:
            x, y = np.float32(a.const), np.float32(b.const)
            with np.errstate(all="ignore"):
                r = {"+": x + y, "-": x - y, "*": x * y}[op]
            return G(const=float(np.float32(r)))
        return self._op(f"{self.c(a)} {op} {self.c(b)}", a, b)

    def fminmax(self, fn: str, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            x, y = np.float32(a.const), np.float32(b.const)
            r = np.minimum(x, y) if fn == "minimum" else np.maximum(x, y)
            return G(const=float(r))
        return self._op(f"tl.{fn}({self.c(a)}, {self.c(b)}, "
                        f"propagate_nan=tl.PropagateNan.ALL)", a, b)

    def fabs(self, a: G) -> G:
        if a.is_const:
            return G(const=float(np.abs(np.float32(a.const))))
        return self._op(f"tl.abs({a.code})", a)

    def iclip(self, a: G, hi: int) -> G:
        if a.is_const:
            return G(const=int(min(max(int(a.const), 0), hi)))
        return self._op(f"tl.minimum(tl.maximum({a.code}, 0), {hi})", a)

    def iarith(self, op: str, a: G, b: G) -> G:
        """int32 arithmetic (+, *, &, >>, <<); constants fold as int32."""
        if a.is_const and b.is_const:
            x, y = int(a.const), int(b.const)
            r = {"+": x + y, "*": x * y, "&": x & y, ">>": x >> y,
                 "<<": x << y}[op]
            return G(const=((r + (1 << 31)) % (1 << 32)) - (1 << 31))
        return self._op(f"{self.c(a)} {op} {self.c(b)}", a, b)

    def gather(self, arg: str, idx: G, to_i32: bool) -> G:
        """Unmasked gather at clipped indices."""
        suffix = ".to(tl.int32)" if to_i32 else ""
        return self._op(f"tl.load({arg} + {self.c(idx)}){suffix}", idx)


class _ClauseGen:
    """Generates one clause's contribution (the any over its free axes of
    pair.hi AND the clause axes' presence) into `acc_name`."""

    def __init__(self, em: _Emitter, plan, feats_shapes: dict,
                 params_shapes: dict):
        self.em = em
        self.plan = plan
        self.fshape = feats_shapes
        self.pshape = params_shapes
        self.sizes: dict[str, int] = {}

    # --------------------------------------------------- leaf placement

    def _leaf_axes(self, space: str, slot: int, name: str, leaf_axis):
        """(axis, dim size) per non-leading array dim, as place_obj /
        place_param bind them."""
        plan = self.plan
        if space == "f":
            shape = self.fshape[slot][name]
            seg_axes = plan.slot_axes(slot, False, leaf_axis)
            out = []
            for ax, k in zip(seg_axes, shape[1:]):
                if plan.axpos.get(ax) is None:
                    raise EvalError(f"axis {ax} not in clause layout")
                out.append((ax, int(k)))
            return out
        shape = self.pshape[slot][name]
        if len(shape) == 2:
            seg_axes = plan.slot_axes(slot, True, leaf_axis)
            if not seg_axes:
                raise EvalError("param array has P dim but no axis")
            if plan.axpos.get(seg_axes[-1]) is None:
                raise EvalError(f"axis {seg_axes[-1]} not in clause layout")
            return [(seg_axes[-1], int(shape[1]))]
        return []

    def _note_sizes(self, axes) -> None:
        for ax, k in axes:
            cur = self.sizes.get(ax, 1)
            if k > 1 and cur > 1 and k != cur:
                raise EvalError(f"axis {ax}: sizes {cur} and {k} do not "
                                f"broadcast")
            self.sizes[ax] = max(cur, k)

    def load(self, space: str, slot: int, name: str, leaf_axis, env) -> G:
        em = self.em
        arg, shape, dtype = em.leaves[(space, slot, name)]
        axes = self._leaf_axes(space, slot, name, leaf_axis)
        strides = []
        s = 1
        for d in reversed(shape[1:]):
            strides.append(s)
            s *= int(d)
        strides.reverse()
        base = "rows" if space == "f" else "cols"
        terms = [f"{base} * {s}" if s != 1 else base]
        level = 0
        for (ax, k), st in zip(axes, strides):
            if k == 1:
                continue
            var = env.get(ax)
            if var is None:
                raise EvalError(f"axis {ax} unbound at a load")
            level = max(level, em.var_level[var])
            terms.append(f"{var} * {st}" if st != 1 else var)
        mask = "rmask" if space == "f" else "cmask"
        suffix = ".to(tl.int32)" if dtype == "int8" else ""
        return em.let(f"tl.load({arg} + {' + '.join(terms)}, mask={mask}, "
                      f"other=0){suffix}", ROW if space == "f" else COL,
                      level)

    def presence(self, axis: str, env) -> G:
        ax = self.plan.axis_table[axis]
        space = "p" if ax.kind == "param" else "f"
        k = self.load(space, ax.slot, "kind", axis, env)
        return self.em.cmp("!=", k, G(const=K_ABSENT))

    # ------------------------------------------------------ free axes

    def _free_leaf(self, space, slot, name, leaf_axis) -> set:
        axes = self._leaf_axes(space, slot, name, leaf_axis)
        self._note_sizes(axes)
        return {ax for ax, _k in axes}

    def _free_pres(self, axis: str) -> set:
        ax = self.plan.axis_table[axis]
        space = "p" if ax.kind == "param" else "f"
        return self._free_leaf(space, ax.slot, "kind", axis)

    def free(self, e) -> set:
        """Axes an expression's value depends on (its JAX tensor's placed
        dims that no reduction inside it removed); records axis sizes."""
        if isinstance(e, OVal):
            if e.f in ("count", "countz"):
                out = self._free_leaf("f", e.slot, "count", None)
                if e.f == "count":
                    out |= self._free_leaf("f", e.slot, "kind", None)
                return out
            name = "key_id" if e.f == "key" else "id"
            return self._free_leaf("f", e.slot, name, e.axis)
        if isinstance(e, PVal):
            if e.f == "count":
                return self._free_leaf("p", e.slot, "count", None)
            name = e.f if e.f.startswith("row:") else \
                ("key_id" if e.f == "key" else "id")
            return self._free_leaf("p", e.slot, name, e.axis)
        if isinstance(e, Const):
            return set()
        if isinstance(e, (Cmp, Arith)):
            return self.free(e.lhs) | self.free(e.rhs)
        if isinstance(e, MatchLookup):
            return self.free(e.row) | self.free(e.sid)
        if isinstance(e, (Truthy, Exists, KindIs)):
            return self.free(e.e)
        if isinstance(e, DerivedVal):
            return self.free(e.base)
        if isinstance(e, (And, Or)):
            out = set()
            for x in e.items:
                out |= self.free(x)
            return out
        if isinstance(e, Not):
            out = self.free(e.e)
            for ax in e.local_axes:
                out = (out | self._free_pres(ax)) - {ax}
            return out
        if isinstance(e, (OrReduce, SumReduce)):
            return (self.free(e.e) | self._free_pres(e.axis)) - {e.axis}
        raise EvalError(f"unsupported expr {type(e).__name__}")

    # -------------------------------------------------------- cells

    def _key_kind(self, sid: G, num: G, absent: int = K_ABSENT) -> G:
        em = self.em
        inner = em.where(em.isnan(num), G(const=absent), G(const=K_NUM))
        return em.where(em.cmp(">", sid, G(const=0)), G(const=K_STR), inner)

    def cell(self, e, env):
        em = self.em
        if isinstance(e, OVal):
            if e.f == "key":
                sid = self.load("f", e.slot, "key_id", e.axis, env)
                num = self.load("f", e.slot, "key_num", e.axis, env)
                nid = self.load("f", e.slot, "key_nid", e.axis, env)
                return sid, num, nid, self._key_kind(sid, num)
            return tuple(self.load("f", e.slot, nm, e.axis, env)
                         for nm in ("id", "num", "nid", "kind"))
        if isinstance(e, PVal):
            if e.f.startswith("row:"):
                return (self.load("p", e.slot, e.f, e.axis, env),
                        G(const=0.0), G(const=0), G(const=0))
            if e.f == "key":
                sid = self.load("p", e.slot, "key_id", e.axis, env)
                num = self.load("p", e.slot, "key_num", e.axis, env)
                nid = self.load("p", e.slot, "key_nid", e.axis, env)
                return sid, num, nid, self._key_kind(sid, num)
            return tuple(self.load("p", e.slot, nm, e.axis, env)
                         for nm in ("id", "num", "nid", "kind"))
        if isinstance(e, Const):
            if e.kind == "id":
                return (G(const=int(e.value)), G(const=float("nan")),
                        G(const=0), G(const=K_STR))
            if e.kind == "numc":
                num, nid = e.value
                return (G(const=0), G(const=_f32(num)), G(const=int(nid)),
                        G(const=K_NUM))
            if e.kind == "bool":
                return (G(const=0), G(const=1.0 if e.value else 0.0),
                        G(const=0), G(const=K_TRUE if e.value else K_FALSE))
            if e.kind == "rowidx":
                return (G(const=int(e.value)), G(const=0.0), G(const=0),
                        G(const=0))
            raise EvalError(f"unresolved const {e.kind}")
        if isinstance(e, DerivedVal):
            bsid, _bnum, bnid, bkind = self.cell(e.base, env)
            is_str = em.cmp("==", bkind, G(const=K_STR))
            is_num = em.cmp("==", bkind, G(const=K_NUM))
            ix = em.where(is_str, bsid, em.where(is_num, bnid, G(const=0)))
            V = self.em.leaves[("d", e.col, "kind")][1][0]
            ix = em.iclip(ix, V - 1)
            arg = {nm: self.em.leaves[("d", e.col, nm)][0]
                   for nm in ("sid", "num", "nid", "kind")}
            kind = em.where(em.bor(is_str, is_num),
                            em.gather(arg["kind"], ix, True),
                            G(const=K_ABSENT))
            return (em.gather(arg["sid"], ix, False),
                    em.gather(arg["num"], ix, False),
                    em.gather(arg["nid"], ix, False), kind)
        raise EvalError(f"not a value expr: {type(e).__name__}")

    def _canon(self, e, env, side: int):
        """One auto-compare operand, canonicalised: (kind code with the
        side's absent sentinel, comparable id, not-maybe flag). The id is
        sid for strings and nid for numbers (only compared when the kinds
        are equal, so the two id spaces never meet) and 0 for the other
        kinds, which compare equal by kind alone; not-maybe is False for
        arrays and objects."""
        em = self.em
        undef = _UNDEF[side]
        if isinstance(e, (OVal, PVal)) and e.f == "key":
            space = "f" if isinstance(e, OVal) else "p"
            sid = self.load(space, e.slot, "key_id", e.axis, env)
            num = self.load(space, e.slot, "key_num", e.axis, env)
            nid = self.load(space, e.slot, "key_nid", e.axis, env)
            # a key is a string or a number, never an array or object
            return (self._key_kind(sid, num, undef),
                    em.where(em.cmp(">", sid, G(const=0)), sid, nid),
                    G(const=True))
        sid, _num, nid, kind = self.cell(e, env)
        kc = em.where(em.cmp("!=", kind, G(const=K_ABSENT)), kind,
                      G(const=undef))
        idv = em.where(em.cmp("==", kind, G(const=K_STR)), sid,
                       em.where(em.cmp("==", kind, G(const=K_NUM)), nid,
                                G(const=0)))
        nm = em.band(em.cmp("!=", kind, G(const=K_ARR)),
                     em.cmp("!=", kind, G(const=K_OBJ)))
        return kc, idv, nm

    def _cmp_auto(self, e, env) -> BP:
        """An auto-typed eq/ne over canonicalised operands. With
        E = (kc_l == kc_r) & (id_l == id_r), which is the plain version's
        defined & eq, and D = defined (each kind code off its sentinel):
            eq: lo = E & not-maybe, hi = E;
            ne: lo = D ^ E,         hi = D ^ (E & not-maybe)
        (E and E & not-maybe lie inside D, so XOR is AND NOT). Kinds must
        be equal for E, so either side's not-maybe flag serves; the
        cheaper one is taken."""
        em = self.em
        if e.op not in ("eq", "ne"):
            raise EvalError(f"auto cmp op {e.op}")
        lk, lid, lnm = self._canon(e.lhs, env, 0)
        rk, rid, rnm = self._canon(e.rhs, env, 1)
        ee = em.band(em.cmp("==", lk, rk), em.cmp("==", lid, rid))
        nm = min((lnm, rnm), key=lambda g: (not g.is_const, g.shape,
                                            g.level))
        e_nm = em.band(ee, nm)
        if e.op == "eq":
            return BP(e_nm, ee)
        dd = em.band(em.cmp("!=", lk, G(const=_UNDEF[0])),
                     em.cmp("!=", rk, G(const=_UNDEF[1])))
        return BP(em.bxor(dd, ee), em.bxor(dd, e_nm))

    # ------------------------------------------------------ reductions

    def _loop(self, axis: str, env, body):
        """Emit `for <var> in range(size)` around body(env2)."""
        em = self.em
        var = em.fresh("i")
        em.open_loop(var, self.sizes.get(axis, 1))
        try:
            body(dict(env, **{axis: var}))
        finally:
            em.close_loop()

    def _acc(self, dtype: str) -> G:
        """A loop-carried accumulator at the current level: the full tile,
        so its type stays fixed across iterations."""
        em = self.em
        name = em.fresh("acc")
        if dtype == "int1":
            em.emit(f"{name} = tl.zeros([BC, BLOCK_N], dtype=tl.int32) != 0")
        else:
            em.emit(f"{name} = tl.zeros([BC, BLOCK_N], dtype=tl.{dtype})")
        em.count(FULL)
        return G(name, shape=FULL, level=em.level)

    def _or_into(self, acc: G, v: G) -> None:
        if v.is_const:
            if v.const:
                self.em.emit(f"{acc.code} = {acc.code} | True")
                self.em.count(FULL)
            return
        self.em.emit(f"{acc.code} = {acc.code} | {v.code}")
        self.em.count(FULL)

    def bany(self, axes: list, env, inner_fn) -> BP:
        """_bany over `axes` in order (innermost first), each step ANDing
        that axis' presence: the JAX package's sequential keepdims any."""
        em = self.em
        lo_acc = self._acc("int1")
        hi_acc = self._acc("int1")
        exact = []

        def body(env2):
            if len(axes) > 1:
                v = self.bany(axes[:-1], env2, inner_fn)
            else:
                v = inner_fn(env2)
            pres = self.presence(axes[-1], env2)
            exact.append(v.is_exact)
            lo = em.band(v.lo, pres)
            self._or_into(lo_acc, lo)
            if not v.is_exact:
                self._or_into(hi_acc, em.band(v.hi, pres))

        self._loop(axes[-1], env, body)
        return BP(lo_acc, lo_acc if exact[0] else hi_acc)

    # ------------------------------------------------------- numbers

    def num(self, e, env):
        """-> (vlo, vhi, defined, nid-or-None) as evaljax._eval_num."""
        em = self.em
        if isinstance(e, SumReduce):
            slo_acc = self._acc("float32")
            shi_acc = self._acc("float32")
            exact = []

            def body(env2):
                inner = self.boolean(e.e, env2)
                pres = self.presence(e.axis, env2)
                exact.append(inner.is_exact)
                for acc, v in ((slo_acc, inner.lo), (shi_acc, inner.hi)):
                    if acc is shi_acc and inner.is_exact:
                        continue
                    m = em.band(v, pres)
                    if m.is_const:
                        if m.const:
                            em.emit(f"{acc.code} = {acc.code} + 1.0")
                            em.count(FULL)
                        continue
                    em.emit(f"{acc.code} = {acc.code} + "
                            f"tl.where({m.code}, 1.0, 0.0)")
                    em.count(FULL)

            self._loop(e.axis, env, body)
            return slo_acc, (slo_acc if exact[0] else shi_acc), \
                G(const=True), None
        if isinstance(e, OVal) and e.f in ("count", "countz"):
            val = self.load("f", e.slot, "count", None, env)
            if e.f == "countz":
                return val, val, G(const=True), None
            kinds = self.load("f", e.slot, "kind", None, env)
            return val, val, em.cmp("!=", kinds, G(const=K_ABSENT)), None
        if isinstance(e, PVal) and e.f == "count":
            val = self.load("p", e.slot, "count", None, env)
            return val, val, G(const=True), None
        if isinstance(e, Arith):
            llo, lhi, ld, _ = self.num(e.lhs, env)
            rlo, rhi, rd, _ = self.num(e.rhs, env)
            defined = em.band(ld, rd)
            if e.op == "add":
                lo, hi = em.farith("+", llo, rlo), em.farith("+", lhi, rhi)
            elif e.op == "sub":
                lo, hi = em.farith("-", llo, rhi), em.farith("-", lhi, rlo)
            elif e.op == "mul":
                a, b = em.farith("*", llo, rlo), em.farith("*", llo, rhi)
                c, d = em.farith("*", lhi, rlo), em.farith("*", lhi, rhi)
                lo = em.fminmax("minimum", em.fminmax("minimum", a, b),
                                em.fminmax("minimum", c, d))
                hi = em.fminmax("maximum", em.fminmax("maximum", a, b),
                                em.fminmax("maximum", c, d))
            else:
                raise EvalError(f"arith op {e.op}")
            eps, tiny = G(const=_f32(1e-5)), G(const=_f32(1e-30))
            lo = em.farith("-", lo, em.farith(
                "+", em.farith("*", em.fabs(lo), eps), tiny))
            hi = em.farith("+", hi, em.farith(
                "+", em.farith("*", em.fabs(hi), eps), tiny))
            lo = em.where(em.isnan(lo), G(const=-float("inf")), lo)
            hi = em.where(em.isnan(hi), G(const=float("inf")), hi)
            return lo, hi, defined, None
        sid, num, nid, kind = self.cell(e, env)
        return num, num, em.cmp("==", kind, G(const=K_NUM)), nid

    # ------------------------------------------------------ booleans

    def boolean(self, e, env) -> BP:
        em = self.em
        band, bor, bnot = em.band, em.bor, em.bnot
        if isinstance(e, Cmp):
            if e.dtype == "auto":
                return self._cmp_auto(e, env)
            lvlo, lvhi, ld, lnid = self.num(e.lhs, env)
            rvlo, rvhi, rd, rnid = self.num(e.rhs, env)
            defined = band(ld, rd)
            if lnid is not None and rnid is not None:
                tie = band(em.cmp("==", lvlo, rvlo),
                           band(em.cmp("!=", lnid, rnid),
                                band(em.cmp("!=", lnid, G(const=0)),
                                     em.cmp("!=", rnid, G(const=0)))))
                exact = False
            else:
                tie = G(const=False)
                exact = (lvlo is lvhi) and (rvlo is rvhi)
            point = (lvlo is lvhi) and (rvlo is rvhi)
            cmp = em.cmp
            if e.op == "lt":
                lo, hi = cmp("<", lvhi, rvlo), bor(cmp("<", lvlo, rvhi), tie)
            elif e.op == "gt":
                lo, hi = cmp(">", lvlo, rvhi), bor(cmp(">", lvhi, rvlo), tie)
            elif e.op == "le":
                lo = band(cmp("<=", lvhi, rvlo), bnot(tie))
                hi = cmp("<=", lvlo, rvhi)
            elif e.op == "ge":
                lo = band(cmp(">=", lvlo, rvhi), bnot(tie))
                hi = cmp(">=", lvhi, rvlo)
            elif e.op in ("eq", "ne"):
                pts = cmp("==", lvlo, rvlo) if point else band(
                    cmp("==", lvlo, lvhi),
                    band(cmp("==", rvlo, rvhi), cmp("==", lvlo, rvlo)))
                if e.op == "eq":
                    lo = band(pts, bnot(tie))
                    hi = band(cmp("<=", lvlo, rvhi), cmp("<=", rvlo, lvhi))
                else:
                    lo = bor(cmp("<", lvhi, rvlo), cmp("<", rvhi, lvlo))
                    hi = bnot(band(pts, bnot(tie)))
            else:
                raise EvalError(f"cmp op {e.op}")
            lo = band(defined, lo)
            hi = lo if exact else band(defined, hi)
            return BP(lo, hi)
        if isinstance(e, MatchLookup):
            # defined & hit, with defined's two sides folded into the two
            # operands of the bit test: the word of a non-string is 0, and
            # so is the bit of a negative pattern row
            row = self.cell(e.row, env)[0]
            ssid, _sn, _snid, skind = self.cell(e.sid, env)
            targ, (V, W), _dt = em.leaves[("t", 0, "table")]
            r = em.iclip(row, W * 32 - 1)
            s = em.iclip(ssid, V - 1)
            # word s * W + (r >> 5), bit r & 31; each part is emitted where
            # its own loops bind it, and with one word a string (r >> 5 is
            # then 0) the gather is the string side's alone
            idx = s if W == 1 else em.iarith(
                "+", em.iarith("*", s, G(const=W)),
                em.iarith(">>", r, G(const=5)))
            word = em.where(em.cmp("==", skind, G(const=K_STR)),
                            em.gather(targ, idx, False), G(const=0))
            bit = em.where(em.cmp(">=", row, G(const=0)),
                           em.iarith("<<", G(const=1),
                                     em.iarith("&", r, G(const=31))),
                           G(const=0))
            return BP.exact(em.cmp("!=", em.iarith("&", word, bit),
                                   G(const=0)))
        if isinstance(e, Truthy):
            k = self.cell(e.e, env)[3]
            return BP.exact(band(em.cmp("!=", k, G(const=K_ABSENT)),
                                 em.cmp("!=", k, G(const=K_FALSE))))
        if isinstance(e, Exists):
            k = self.cell(e.e, env)[3]
            return BP.exact(em.cmp("!=", k, G(const=K_ABSENT)))
        if isinstance(e, KindIs):
            k = self.cell(e.e, env)[3]
            hit = None
            for kk in e.kinds:
                t = em.cmp("==", k, G(const=int(kk)))
                hit = t if hit is None else bor(hit, t)
            return BP.exact(hit if hit is not None else G(const=False))
        if isinstance(e, And):
            out = None
            for x in e.items:
                v = self.boolean(x, env)
                if out is None:
                    out = v
                else:
                    lo = band(out.lo, v.lo)
                    out = BP(lo, lo if (out.is_exact and v.is_exact)
                             else band(out.hi, v.hi))
            return out if out is not None else BP.exact(G(const=True))
        if isinstance(e, Or):
            out = None
            for x in e.items:
                v = self.boolean(x, env)
                if out is None:
                    out = v
                else:
                    lo = bor(out.lo, v.lo)
                    out = BP(lo, lo if (out.is_exact and v.is_exact)
                             else bor(out.hi, v.hi))
            return out if out is not None else BP.exact(G(const=False))
        if isinstance(e, Not):
            if e.local_axes:
                inner = self.bany(list(e.local_axes), env,
                                  lambda env2: self.boolean(e.e, env2))
            else:
                inner = self.boolean(e.e, env)
            return self._bnot(inner)
        if isinstance(e, OrReduce):
            return self.bany([e.axis], env,
                             lambda env2: self.boolean(e.e, env2))
        if isinstance(e, SumReduce):
            slo, shi, _d, _n = self.num(e, env)
            lo = em.cmp("!=", slo, G(const=0.0))
            hi = lo if shi is slo else em.cmp("!=", shi, G(const=0.0))
            return BP(lo, hi)
        if isinstance(e, Const):
            if e.kind == "bool":
                return BP.exact(G(const=bool(e.value)))
            return BP.exact(G(const=True))
        raise EvalError(f"unsupported expr {type(e).__name__}")

    def _bnot(self, a: BP) -> BP:
        hi = self.em.bnot(a.lo)
        lo = hi if a.is_exact else self.em.bnot(a.hi)
        return BP(lo, hi)

    # --------------------------------------------------------- clause

    def clause(self, acc: G) -> None:
        plan = self.plan
        free: set = set()
        for g in plan.clause.guards:
            free |= self.free(g.expr)
        for a in plan.clause.axes:
            free |= self._free_pres(a.name)
        # the clause ORs over its free axes in any order: parameter axes
        # outermost, so the COL work is hoisted out of the object loops
        order = sorted(free, key=lambda a: (
            plan.axis_table[a].kind != "param", a))
        em = self.em

        def body(env, rest):
            if rest:
                self._loop(rest[0], env, lambda env2: body(env2, rest[1:]))
                return
            # the verdict is the AND of every guard's hi (the guards' lo
            # chain is never read) and the clause axes' presence; AND the
            # factors of one shape together first, so that a ROW or COL
            # factor costs one FULL operation at most
            factors = []
            for g in plan.clause.guards:
                v = self.boolean(g.expr, env)
                factors.append(em.bnot(v.lo) if g.negated else v.hi)
            for a in plan.clause.axes:
                factors.append(self.presence(a.name, env))
            success = G(const=True)
            for shape in (COL, ROW, SCALAR, FULL):
                part = G(const=True)
                for f in factors:
                    if f.shape == shape:
                        part = em.band(part, f)
                success = em.band(part, success) if shape == FULL else \
                    em.band(success, part)
            self._or_into(acc, success)

        body({}, order)


def _leaf_table(feats, params, table, derived):
    """Kernel arguments in a fixed order: (space, slot, name) -> (arg
    name, shape, dtype name), plus the tensors in argument order."""
    leaves = {}
    tensors = []

    def add(space, slot, name, t):
        arg = f"a{len(tensors)}"
        leaves[(space, slot, name)] = (arg, tuple(int(d) for d in t.shape),
                                       str(t.dtype).replace("torch.", ""))
        tensors.append(t)

    for space, tree in (("f", feats), ("p", params), ("d", derived)):
        for slot in sorted(tree):
            for name in sorted(tree[slot]):
                add(space, slot, name, tree[slot][name])
    add("t", 0, "table", table)
    return leaves, tensors


def tile(params) -> tuple[int, int, int, int]:
    """(BLOCK_N, BC columns, WPP words, num_warps) at `CONFIG` for inputs
    with these parameters. WPP is the configured words per program, cut to
    the power of two that covers the W words; below 32 constraints one
    word is cut to BC columns, and the rows grow to keep the tile's size,
    so a narrow template does not compute empty columns."""
    block_n, wpp, warps, narrow = CONFIG
    c = param_c(params)
    if c < 32:
        bc = max(2, 1 << (c - 1).bit_length())
        return max(block_n, narrow // bc), bc, 1, warps
    w = (c + 31) // 32
    wpp = min(wpp, 1 << (w - 1).bit_length())
    return block_n, 32 * wpp, wpp, warps


def generate(plans: list, feats, params, table, derived
             ) -> tuple[str, list, int]:
    """Triton source of the kernel for these plans and input shapes, the
    input tensors in argument order, and the elementwise operations one
    program instance performs at the tile `tile` gives."""
    block_n, bc, _wpp, _warps = tile(params)
    leaves, tensors = _leaf_table(feats, params, table, derived)
    em = _Emitter(leaves, block_n, bc)
    fshape = {s: {n: leaves[("f", s, n)][1] for n in a}
              for s, a in feats.items()}
    pshape = {s: {n: leaves[("p", s, n)][1] for n in a}
              for s, a in params.items()}
    em.emit("pid_n = tl.program_id(0)")
    em.emit("pid_w = tl.program_id(1)")
    em.emit("orow = pid_n * BLOCK_N + tl.arange(0, BLOCK_N)")
    em.emit("rows = orow[None, :]")
    em.emit("cols = pid_w * BC + tl.arange(0, BC)[:, None]")
    em.emit("rmask = rows < N")
    em.emit("cmask = cols < C")
    em.emit("fires = tl.zeros([1, 1], dtype=tl.int32) != 0")
    for plan in plans:
        gen = _ClauseGen(em, plan, fshape, pshape)
        acc = gen._acc("int1")
        gen.clause(acc)
        em.emit(f"fires = fires | {acc.code}")
        em.count(FULL)
    # pack: bit b of word k = column 32k + b of the tile (the bits are
    # disjoint, so their int32 sum is their OR)
    em.emit("fires = tl.broadcast_to(fires & cmask, [BC, BLOCK_N])")
    em.emit("bits = tl.where(fires, 1 << (tl.arange(0, BC) % 32)[:, None], 0)")
    em.emit("word = tl.sum(tl.reshape(bits, [WPP, BC // WPP, BLOCK_N]),"
            " axis=1)")
    em.emit("wcol = pid_w * WPP + tl.arange(0, WPP)[:, None]")
    em.emit("tl.store(out + rows * W + wcol, word, mask=rmask & (wcol < W))")
    for shape in (FULL, FULL, FULL, ROW):
        em.count(shape)
    args = ", ".join(leaves[k][0] for k in leaves)
    src = ("import triton\n"
           "import triton.language as tl\n\n\n"
           "@triton.jit\n"
           f"def clause_kernel({args}, out, N, C, W, NAN_F, INF_F,\n"
           "                  BLOCK_N: tl.constexpr, BC: tl.constexpr,\n"
           "                  WPP: tl.constexpr):\n"
           + "\n".join(em.render()) + "\n")
    return src, tensors, em.ops


def _load_kernel(src: str):
    """Import the kernel module for `src` (content-addressed: drivers
    that generate the same source share one module and so one compiled
    kernel)."""
    digest = hashlib.sha256(src.encode()).hexdigest()[:20]
    name = f"{__package__}._build_k2_{digest}"
    mod = sys.modules.get(name)
    if mod is None:
        path = os.path.join(build_dir(), f"k2_{digest}.py")
        if not os.path.exists(path):
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(src)
            os.replace(tmp, path)
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return mod.clause_kernel


def _signature(feats, params, table, derived) -> tuple:
    def shapes(tree):
        return tuple((k, shapes(tree[k])) if isinstance(tree[k], dict)
                     else (k, tuple(tree[k].shape), str(tree[k].dtype))
                     for k in sorted(tree))
    return (shapes(feats), shapes(params), tuple(table.shape),
            shapes(derived))


class _Entry:
    """One generated kernel: the JIT function, its source, the tile it
    was generated for, and the compiled kernel of its last launch (whose
    n_regs / n_spills Triton fills in)."""

    __slots__ = ("kernel", "src", "tile", "ops", "compiled")

    def __init__(self, kernel, src, tile_, ops):
        self.kernel = kernel
        self.src = src
        self.tile = tile_
        self.ops = ops
        self.compiled = None


def launch(plans: list, feats, params, table, derived, cache: dict):
    """Generate (once per shape signature and tile), compile and launch
    the K2 kernel; returns int32 words [N, W] on the inputs' device."""
    n = feat_rows(feats)
    c = param_c(params)
    w = max(1, (c + 31) // 32)
    block_n, bc, wpp, warps = tile_ = tile(params)
    # the row axis is a runtime argument: strip it from the signature
    sig = (_signature({s: {k: v[:1] for k, v in a.items()}
                       for s, a in feats.items()}, params, table, derived),
           tile_)
    ent = cache.get(sig)
    if ent is None:
        src, _, ops = generate(plans, feats, params, table, derived)
        ent = cache[sig] = _Entry(_load_kernel(src), src, tile_, ops)
    _, tensors = _leaf_table(feats, params, table, derived)
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("clause kernel inputs must be contiguous CUDA "
                             "tensors")
    import torch

    out = torch.empty((n, w), dtype=torch.int32, device=table.device)
    grid = ((n + block_n - 1) // block_n, (w + wpp - 1) // wpp)
    ent.compiled = ent.kernel[grid](
        *tensors, out, n, c, w, float("nan"), float("inf"),
        BLOCK_N=block_n, BC=bc, WPP=wpp, num_warps=warps,
        num_stages=1, enable_fp_fusion=False)
    return out


def emitted_ops(plans: list, feats, params, table, derived) -> int:
    """The elementwise operations the emitted source performs on these
    inputs (per program instance, times the grid): a diagnostic of the
    emitter's design, not a bound (clause.clause_work counts the work)."""
    n = feat_rows(feats)
    w = max(1, (param_c(params) + 31) // 32)
    block_n, _bc, wpp, _warps = tile(params)
    _src, _tensors, ops = generate(plans, feats, params, table, derived)
    return ops * ((n + block_n - 1) // block_n) * ((w + wpp - 1) // wpp)
