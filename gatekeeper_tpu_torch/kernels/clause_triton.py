"""K2 on Hopper: one generated Triton kernel per template and shape.

Replaces the JAX package's per-template device program
(gatekeeper_tpu/ir/evaljax.py: CompiledTemplate._eval -> _eval_clause /
_eval_bool / _eval_num / _eval_cell, with the bit-pack body of _scan_jit)
that XLA fused for the TPU. The Program IR is only known when a
ConstraintTemplate is ingested, so this module walks the resolved Program
and its ClausePlans (kernels/clause.py) and writes the Triton source of a
kernel that evaluates it: each program instance covers BLOCK_N object
rows x one 32-column word of constraints, evaluates every clause with
loops over the static iteration-axis sizes (in place of the JAX layout's
[N, axes..., C] dims), ORs the clauses and packs the 32 columns into one
int32 word per row. The loops stay loops (scf.for, accumulators of the
full [BLOCK_N, 32] tile): unrolling them multiplied the compile time.

Bound: bytes. Per (row, constraint) cell the work is a few dozen integer
and f32 operations on values loaded once per row (features, [BLOCK_N, 1])
and once per column (parameters, [1, 32]); the gathers into the match
table and derived columns hit L2. Nothing goes to the tensor cores, and
the [N, axes..., C] intermediates of the JAX program never exist: only the
packed words [N, W] are written, 1 bit per cell.

The emitter mirrors the plain version's structure expression by
expression, including which BPair subtrees are exact (lo `is` hi), so the
verdict bits equal it. The kernel launches with enable_fp_fusion=False:
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

BLOCK_N = 32
NUM_WARPS = 4


# value shapes: a bitmask of the tile dims a value spans
SCALAR, ROW, COL, FULL = 0, 1, 2, 3


class G:
    """One generated value: a Triton expression (`code`) or a Python
    constant (`const`), spanning `shape` (SCALAR, ROW = [BLOCK_N, 1],
    COL = [1, 32] or FULL). Object identity, never the code text, stands
    for JAX array identity when exactness (lo `is` hi) is decided."""

    __slots__ = ("code", "const", "shape")

    def __init__(self, code=None, const=None, shape=SCALAR):
        self.code = code
        self.const = const
        self.shape = shape if code is not None else SCALAR

    @property
    def is_const(self) -> bool:
        return self.code is None


class BP:
    __slots__ = ("lo", "hi")

    def __init__(self, lo: G, hi: G):
        self.lo = lo
        self.hi = hi

    @staticmethod
    def exact(v: G) -> "BP":
        return BP(v, v)

    @property
    def is_exact(self) -> bool:
        return self.lo is self.hi


def _f32(v) -> float:
    return float(np.float32(v))


class _Emitter:
    """Writes one kernel body. `leaf` maps (space, slot, name) to its
    kernel argument and array shape; space is "f" (features), "p"
    (parameters), "d" (derived columns) or "t" (match table)."""

    def __init__(self, leaves: dict):
        self.leaves = leaves
        self.lines: list[str] = []
        self.depth = 1
        self.ntmp = 0
        self.scopes: list[dict] = [{}]
        # elementwise operations one program instance performs: each
        # statement's tile elements times the trip counts around it
        self.ops = 0
        self.trips = [1]

    # ---------------------------------------------------------- plumbing

    def emit(self, line: str) -> None:
        self.lines.append("    " * self.depth + line)

    def fresh(self, stem: str = "t") -> str:
        self.ntmp += 1
        return f"{stem}{self.ntmp}"

    def _cached(self, key):
        for scope in reversed(self.scopes):
            if key in scope:
                return scope[key]
        return None

    def count(self, shape: int) -> None:
        elems = {SCALAR: 1, ROW: BLOCK_N, COL: 32, FULL: BLOCK_N * 32}
        self.ops += elems[shape] * self.trips[-1]

    def let(self, code: str, shape: int) -> G:
        """Bind `code` to a temporary (common subexpressions share one;
        each call still returns a new G, as each jnp op makes a new
        array)."""
        name = self._cached(code)
        if name is None:
            name = self.fresh()
            self.emit(f"{name} = {code}")
            self.count(shape)
            self.scopes[-1][code] = name
        return G(name, shape=shape)

    def push(self, trips: int) -> None:
        self.scopes.append({})
        self.trips.append(self.trips[-1] * trips)
        self.depth += 1

    def pop(self) -> None:
        self.scopes.pop()
        self.trips.pop()
        self.depth -= 1

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

    def band(self, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            return G(const=bool(a.const) and bool(b.const))
        if (a.is_const and not a.const) or (b.is_const and not b.const):
            return G(const=False)
        if a.is_const:
            return G(b.code, shape=b.shape)
        if b.is_const:
            return G(a.code, shape=a.shape)
        return self.let(f"{a.code} & {b.code}", a.shape | b.shape)

    def bor(self, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            return G(const=bool(a.const) or bool(b.const))
        if (a.is_const and a.const) or (b.is_const and b.const):
            return G(const=True)
        if a.is_const:
            return G(b.code, shape=b.shape)
        if b.is_const:
            return G(a.code, shape=a.shape)
        return self.let(f"{a.code} | {b.code}", a.shape | b.shape)

    def bnot(self, a: G) -> G:
        if a.is_const:
            return G(const=not bool(a.const))
        return self.let(f"~{a.code}", a.shape)

    def cmp(self, op: str, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            x, y = a.const, b.const
            return G(const=bool({"<": x < y, "<=": x <= y, ">": x > y,
                                 ">=": x >= y, "==": x == y,
                                 "!=": x != y}[op]))
        return self.let(f"{self.c(a)} {op} {self.c(b)}", a.shape | b.shape)

    def isnan(self, a: G) -> G:
        if a.is_const:
            return G(const=bool(a.const != a.const))
        return self.let(f"{a.code} != {a.code}", a.shape)

    def where(self, cond: G, a: G, b: G) -> G:
        if cond.is_const:
            src = a if cond.const else b
            return G(src.code, src.const, src.shape)
        return self.let(f"tl.where({cond.code}, {self.c(a)}, {self.c(b)})",
                        cond.shape | a.shape | b.shape)

    def farith(self, op: str, a: G, b: G) -> G:
        """f32 arithmetic; constants fold in f32 (as the device would)."""
        if a.is_const and b.is_const:
            x, y = np.float32(a.const), np.float32(b.const)
            with np.errstate(all="ignore"):
                r = {"+": x + y, "-": x - y, "*": x * y}[op]
            return G(const=float(np.float32(r)))
        return self.let(f"{self.c(a)} {op} {self.c(b)}", a.shape | b.shape)

    def fminmax(self, fn: str, a: G, b: G) -> G:
        if a.is_const and b.is_const:
            x, y = np.float32(a.const), np.float32(b.const)
            r = np.minimum(x, y) if fn == "minimum" else np.maximum(x, y)
            return G(const=float(r))
        return self.let(f"tl.{fn}({self.c(a)}, {self.c(b)}, "
                        f"propagate_nan=tl.PropagateNan.ALL)",
                        a.shape | b.shape)

    def fabs(self, a: G) -> G:
        if a.is_const:
            return G(const=float(np.abs(np.float32(a.const))))
        return self.let(f"tl.abs({a.code})", a.shape)

    def iclip(self, a: G, hi: int) -> G:
        if a.is_const:
            return G(const=int(min(max(int(a.const), 0), hi)))
        return self.let(f"tl.minimum(tl.maximum({a.code}, 0), {hi})",
                        a.shape)

    def gather(self, arg: str, idx: G, to_i32: bool) -> G:
        """Unmasked gather at clipped indices."""
        suffix = ".to(tl.int32)" if to_i32 else ""
        return self.let(f"tl.load({arg} + {self.c(idx)}){suffix}",
                        idx.shape)


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
        for (ax, k), st in zip(axes, strides):
            if k == 1:
                continue
            var = env.get(ax)
            if var is None:
                raise EvalError(f"axis {ax} unbound at a load")
            terms.append(f"{var} * {st}" if st != 1 else var)
        mask = "rmask" if space == "f" else "cmask"
        suffix = ".to(tl.int32)" if dtype == "int8" else ""
        return em.let(f"tl.load({arg} + {' + '.join(terms)}, mask={mask}, "
                      f"other=0){suffix}", ROW if space == "f" else COL)

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

    def _key_kind(self, sid: G, num: G) -> G:
        em = self.em
        inner = em.where(em.isnan(num), G(const=K_ABSENT), G(const=K_NUM))
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

    # ------------------------------------------------------ reductions

    def _loop(self, axis: str, env, body):
        """Emit `for <var> in range(size)` around body(env2)."""
        em = self.em
        var = em.fresh("i")
        trips = self.sizes.get(axis, 1)
        em.emit(f"for {var} in range({trips}):")
        em.push(trips)
        try:
            body(dict(env, **{axis: var}))
        finally:
            em.pop()

    def _acc(self, dtype: str) -> str:
        """A loop-carried accumulator: the full tile, so its type stays
        fixed across iterations."""
        name = self.em.fresh("acc")
        if dtype == "int1":
            self.em.emit(f"{name} = tl.zeros([BLOCK_N, 32], dtype=tl.int32)"
                         " != 0")
        else:
            self.em.emit(f"{name} = tl.zeros([BLOCK_N, 32], "
                         f"dtype=tl.{dtype})")
        self.em.count(FULL)
        return name

    def _or_into(self, acc: str, v: G) -> None:
        if v.is_const:
            if v.const:
                self.em.emit(f"{acc} = {acc} | True")
                self.em.count(FULL)
            return
        self.em.emit(f"{acc} = {acc} | {v.code}")
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
        lo = G(lo_acc, shape=FULL)
        return BP(lo, lo if exact[0] else G(hi_acc, shape=FULL))

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
                            em.emit(f"{acc} = {acc} + 1.0")
                            em.count(FULL)
                        continue
                    em.emit(f"{acc} = {acc} + tl.where({m.code}, 1.0, 0.0)")
                    em.count(FULL)

            self._loop(e.axis, env, body)
            slo = G(slo_acc, shape=FULL)
            return slo, (slo if exact[0] else G(shi_acc, shape=FULL)), \
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

    def _cell_eq(self, l, r):
        em = self.em
        lsid, _ln, lnid, lk = l
        rsid, _rn, rnid, rk = r
        defined = em.band(em.cmp("!=", lk, G(const=K_ABSENT)),
                          em.cmp("!=", rk, G(const=K_ABSENT)))
        same_kind = em.cmp("==", lk, rk)
        str_eq = em.band(em.cmp("==", lk, G(const=K_STR)),
                         em.cmp("==", lsid, rsid))
        num_eq = em.band(em.cmp("==", lk, G(const=K_NUM)),
                         em.cmp("==", lnid, rnid))
        lit_eq = em.band(same_kind, em.bor(
            em.bor(str_eq, num_eq),
            em.band(em.cmp("!=", lk, G(const=K_STR)),
                    em.cmp("!=", lk, G(const=K_NUM)))))
        maybe = em.band(same_kind, em.bor(em.cmp("==", lk, G(const=K_ARR)),
                                          em.cmp("==", lk, G(const=K_OBJ))))
        return em.bor(lit_eq, maybe), defined, maybe

    def boolean(self, e, env) -> BP:
        em = self.em
        band, bor, bnot = em.band, em.bor, em.bnot
        if isinstance(e, Cmp):
            if e.dtype == "auto":
                eq, defined, maybe = self._cell_eq(self.cell(e.lhs, env),
                                                   self.cell(e.rhs, env))
                if e.op == "eq":
                    return BP(band(defined, band(eq, bnot(maybe))),
                              band(defined, eq))
                if e.op == "ne":
                    return BP(band(defined, bnot(eq)),
                              band(defined, bor(bnot(eq), maybe)))
                raise EvalError(f"auto cmp op {e.op}")
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
            row = self.cell(e.row, env)[0]
            ssid, _sn, _snid, skind = self.cell(e.sid, env)
            defined = band(em.cmp(">=", row, G(const=0)),
                           em.cmp("==", skind, G(const=K_STR)))
            targ, (V, W), _dt = em.leaves[("t", 0, "table")]
            r = em.iclip(row, W * 32 - 1)
            s = em.iclip(ssid, V - 1)
            if s.is_const and r.is_const:
                idx = G(const=int(s.const) * W + (int(r.const) >> 5))
            else:
                idx = em.let(f"{em.c(s)} * {W} + ({em.c(r)} >> 5)",
                             s.shape | r.shape)
            word = em.gather(targ, idx, False)
            if r.is_const:
                bit = em.let(f"({word.code} >> {int(r.const) & 31}) & 1",
                             word.shape)
            else:
                bit = em.let(f"({word.code} >> ({r.code} & 31)) & 1",
                             word.shape | r.shape)
            hit = em.cmp("!=", bit, G(const=0))
            return BP.exact(band(defined, hit))
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

    def clause(self, acc: str) -> None:
        plan = self.plan
        free: set = set()
        for g in plan.clause.guards:
            free |= self.free(g.expr)
        for a in plan.clause.axes:
            free |= self._free_pres(a.name)
        order = sorted(free)
        em = self.em

        def body(env, rest):
            if rest:
                self._loop(rest[0], env, lambda env2: body(env2, rest[1:]))
                return
            pair = None
            for g in plan.clause.guards:
                v = self.boolean(g.expr, env)
                if g.negated:
                    v = self._bnot(v)
                if pair is None:
                    pair = v
                else:
                    lo = em.band(pair.lo, v.lo)
                    pair = BP(lo, lo if (pair.is_exact and v.is_exact)
                              else em.band(pair.hi, v.hi))
            success = pair.hi if pair is not None else G(const=True)
            for a in plan.clause.axes:
                success = em.band(success, self.presence(a.name, env))
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


def generate(plans: list, feats, params, table, derived
             ) -> tuple[str, list, int]:
    """Triton source of the kernel for these plans and input shapes, the
    input tensors in argument order, and the elementwise operations one
    program instance performs."""
    leaves, tensors = _leaf_table(feats, params, table, derived)
    em = _Emitter(leaves)
    fshape = {s: {n: leaves[("f", s, n)][1] for n in a}
              for s, a in feats.items()}
    pshape = {s: {n: leaves[("p", s, n)][1] for n in a}
              for s, a in params.items()}
    em.emit("pid_n = tl.program_id(0)")
    em.emit("pid_w = tl.program_id(1)")
    em.emit("orow = pid_n * BLOCK_N + tl.arange(0, BLOCK_N)")
    em.emit("rows = orow[:, None]")
    em.emit("cols = pid_w * 32 + tl.arange(0, 32)[None, :]")
    em.emit("rmask = rows < N")
    em.emit("cmask = cols < C")
    em.emit("fires = tl.zeros([1, 1], dtype=tl.int32) != 0")
    for plan in plans:
        gen = _ClauseGen(em, plan, fshape, pshape)
        acc = gen._acc("int1")
        gen.clause(acc)
        em.emit(f"fires = fires | {acc}")
        em.count(FULL)
    em.emit("fires = tl.broadcast_to(fires & cmask, [BLOCK_N, 32])")
    em.emit("word = tl.sum(tl.where(fires, 1 << tl.arange(0, 32)[None, :], "
            "0), axis=1)")
    em.emit("tl.store(out + orow * W + pid_w, word, mask=orow < N)")
    for shape in (FULL, FULL, FULL, ROW):
        em.count(shape)
    args = ", ".join(leaves[k][0] for k in leaves)
    src = ("import triton\n"
           "import triton.language as tl\n\n\n"
           "@triton.jit\n"
           f"def clause_kernel({args}, out, N, C, W, NAN_F, INF_F,\n"
           "                  BLOCK_N: tl.constexpr):\n"
           + "\n".join(em.lines) + "\n")
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


def launch(plans: list, feats, params, table, derived, cache: dict):
    """Generate (once per shape signature), compile and launch the K2
    kernel; returns int32 words [N, W] on the inputs' device."""
    n = feat_rows(feats)
    c = param_c(params)
    w = max(1, (c + 31) // 32)
    # the row axis is a runtime argument: strip it from the signature
    sig = _signature({s: {k: v[:1] for k, v in a.items()}
                      for s, a in feats.items()}, params, table, derived)
    ent = cache.get(sig)
    if ent is None:
        src, _, ops = generate(plans, feats, params, table, derived)
        ent = cache[sig] = (_load_kernel(src), src, ops)
    kernel = ent[0]
    _, tensors = _leaf_table(feats, params, table, derived)
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("clause kernel inputs must be contiguous CUDA "
                             "tensors")
    import torch

    out = torch.empty((n, w), dtype=torch.int32, device=table.device)
    grid = ((n + BLOCK_N - 1) // BLOCK_N, w)
    kernel[grid](*tensors, out, n, c, w, float("nan"), float("inf"),
                 BLOCK_N=BLOCK_N, num_warps=NUM_WARPS, num_stages=1,
                 enable_fp_fusion=False)
    return out


def cost(plans: list, feats, params, table, derived) -> dict:
    """The kernel's work on these inputs: bytes (every input leaf read
    once, the words written once) and elementwise operations (per
    program instance, times the grid)."""
    n = feat_rows(feats)
    w = max(1, (param_c(params) + 31) // 32)
    _src, tensors, ops = generate(plans, feats, params, table, derived)
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + n * w * 4
    return {"bytes": nbytes,
            "ops": ops * ((n + BLOCK_N - 1) // BLOCK_N) * w}
