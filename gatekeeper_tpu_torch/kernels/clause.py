"""K2: the per-template clause evaluator -> bit-packed verdict words.

Replaces `CompiledTemplate._eval` and the bit-pack body of `_scan_jit` in
gatekeeper_tpu/ir/evaljax.py (`_eval_clause`, `_eval_bool`, `_eval_num`,
`_eval_cell`): for every object row n and constraint column c, does any
violation clause of the template possibly fire? The answer is packed 32
columns to a word: words[N, W] int32 (the view of uint32), bit b of word w
= column 32w+b, columns >= C zero.

Semantics are the JAX package's exactly: tri-state BPair (lo, hi) literal
results where lo = certainly succeeds and hi = possibly succeeds, `Cmp`
over f32 intervals widened by a 1e-5 relative slack with NaN scrubbed to
the unbounded interval, `nid` ties for f32-equal numbers with different
canonical ids, SumReduce/OrReduce/Not(local_axes) over iteration axes,
derived-column and match-table gathers. The filter may over-fire (the
host re-check is exact) and never under-fires.

`clause_words` is the wrapper: the plain PyTorch interpreter below for
CPU tensors, the generated Triton kernel (clause_triton.py) for CUDA
tensors. The plain version keeps the JAX layout [N, axes..., C] per clause
and chunks N to bound those intermediates. `clause_work` counts what a
call must do on given inputs (bytes and pair-trips), from the IR and the
shapes alone: the yardstick for the kernel's bound.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

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
    Expr,
    KindIs,
    MatchLookup,
    Not,
    Or,
    OrReduce,
    OVal,
    Program,
    PVal,
    SumReduce,
    Truthy,
)
from .build import count_launch


class EvalError(Exception):
    pass


def collect_axes(e: Expr, out: set) -> None:
    if isinstance(e, (OVal, PVal)):
        if e.axis:
            out.add(e.axis)
    elif isinstance(e, (Cmp, Arith)):
        collect_axes(e.lhs, out)
        collect_axes(e.rhs, out)
    elif isinstance(e, MatchLookup):
        collect_axes(e.row, out)
        collect_axes(e.sid, out)
    elif isinstance(e, (Truthy, Exists, KindIs)):
        collect_axes(e.e, out)
    elif isinstance(e, DerivedVal):
        collect_axes(e.base, out)
    elif isinstance(e, (And, Or)):
        for x in e.items:
            collect_axes(x, out)
    elif isinstance(e, Not):
        collect_axes(e.e, out)
        out.update(e.local_axes)
    elif isinstance(e, (OrReduce, SumReduce)):
        collect_axes(e.e, out)
        out.add(e.axis)


class ClausePlan:
    """Static layout for one clause: [N, ax0, ax1, ..., C] (the JAX
    package's _ClausePlan). The Triton emitter reads the same plan."""

    def __init__(self, program: Program, clause):
        axes: set = set(a.name for a in clause.axes)
        for g in clause.guards:
            collect_axes(g.expr, axes)
        self.axis_order = sorted(axes)
        self.axpos = {a: 1 + i for i, a in enumerate(self.axis_order)}
        self.rank = 2 + len(self.axis_order)
        self.cpos = self.rank - 1
        self.clause = clause
        self.program = program
        self.axis_table = program.axis_table()
        self.slot_specs = {s.slot: s for s in program.obj_slots}
        self.pslot_specs = {s.slot: s for s in program.param_slots}

    def slot_axes(self, slot: int, is_param: bool, leaf_axis) -> list[str]:
        spec = self.pslot_specs[slot] if is_param else self.slot_specs[slot]
        seg_axes = [s.axis for s in spec.segs if s.kind == "iter"]
        if leaf_axis and (not seg_axes or seg_axes[-1] != leaf_axis):
            if len(seg_axes) > 1:
                raise EvalError("axis remap on multi-axis slot")
            seg_axes = [leaf_axis]
        return seg_axes

    def place_obj(self, arr: torch.Tensor, slot: int, leaf_axis):
        """arr [N, K...] -> broadcastable [N, ...dims..., 1]."""
        seg_axes = self.slot_axes(slot, False, leaf_axis)
        shape = [arr.shape[0]] + [1] * (self.rank - 1)
        for ax, k in zip(seg_axes, list(arr.shape[1:])):
            pos = self.axpos.get(ax)
            if pos is None:
                raise EvalError(f"axis {ax} not in clause layout")
            shape[pos] = k
        pos_list = [self.axpos[a] for a in seg_axes]
        if pos_list != sorted(pos_list):
            order = np.argsort(pos_list)
            arr = arr.permute([0] + [1 + int(i) for i in order])
        return arr.reshape(shape)

    def place_param(self, arr: torch.Tensor, slot: int, leaf_axis):
        """arr [C] or [C, P] -> [1, ...dims..., C]."""
        shape = [1] * (self.rank - 1) + [arr.shape[0]]
        if arr.dim() == 2:
            seg_axes = self.slot_axes(slot, True, leaf_axis)
            if not seg_axes:
                raise EvalError("param array has P dim but no axis")
            shape[self.axpos[seg_axes[-1]]] = arr.shape[1]
            arr = arr.movedim(0, -1)  # [P, C]
        return arr.reshape(shape)

    def presence(self, axis: str, env) -> torch.Tensor:
        ax = self.axis_table[axis]
        if ax.kind == "param":
            kinds = env.params[ax.slot]["kind"]
            return self.place_param(kinds, ax.slot, axis) != K_ABSENT
        kinds = env.feats[ax.slot]["kind"]
        return self.place_obj(kinds, ax.slot, axis) != K_ABSENT


# --------------------------------------------------------------- plain


class _Env:
    """One evaluation's inputs plus scalar constants on its device."""

    def __init__(self, feats, params, table, derived, device):
        self.feats = feats
        self.params = params
        self.table = table
        self.derived = derived
        self.device = device

    def i32(self, v):
        return torch.tensor(v, dtype=torch.int32, device=self.device)

    def f32(self, v):
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def i8(self, v):
        return torch.tensor(v, dtype=torch.int8, device=self.device)

    def b(self, v):
        return torch.tensor(bool(v), dtype=torch.bool, device=self.device)


class Cell(NamedTuple):
    sid: Any  # int32 string ids
    num: Any  # f32 (approximate; ordering comparisons only)
    nid: Any  # int32 interned canonical-number ids (exact equality)
    kind: Any  # int8


class BPair(NamedTuple):
    """Three-valued literal result (see evaljax.BPair): lo = certainly
    succeeds, hi = possibly succeeds; exact subtrees keep lo `is` hi."""

    lo: Any
    hi: Any

    @staticmethod
    def exact(v) -> "BPair":
        return BPair(v, v)

    @property
    def is_exact(self) -> bool:
        return self.lo is self.hi


def _band(a: BPair, b: BPair) -> BPair:
    lo = torch.logical_and(a.lo, b.lo)
    hi = lo if (a.is_exact and b.is_exact) else torch.logical_and(a.hi, b.hi)
    return BPair(lo, hi)


def _bor(a: BPair, b: BPair) -> BPair:
    lo = torch.logical_or(a.lo, b.lo)
    hi = lo if (a.is_exact and b.is_exact) else torch.logical_or(a.hi, b.hi)
    return BPair(lo, hi)


def _bnot(a: BPair) -> BPair:
    hi = torch.logical_not(a.lo)
    lo = hi if a.is_exact else torch.logical_not(a.hi)
    return BPair(lo, hi)


def _bany(a: BPair, mask, axis: int) -> BPair:
    lo = torch.any(torch.logical_and(a.lo, mask), dim=axis, keepdim=True)
    hi = lo if a.is_exact else torch.any(torch.logical_and(a.hi, mask),
                                         dim=axis, keepdim=True)
    return BPair(lo, hi)


def _key_kind(env: _Env, sid, num):
    return torch.where(sid > 0, env.i8(K_STR),
                       torch.where(torch.isnan(num), env.i8(K_ABSENT),
                                   env.i8(K_NUM)))


def _eval_cell(plan: ClausePlan, e: Expr, env: _Env) -> Cell:
    if isinstance(e, OVal):
        arrs = env.feats[e.slot]
        if e.f == "key":
            sid = plan.place_obj(arrs["key_id"], e.slot, e.axis)
            num = plan.place_obj(arrs["key_num"], e.slot, e.axis)
            return Cell(sid, num, plan.place_obj(arrs["key_nid"], e.slot,
                                                 e.axis),
                        _key_kind(env, sid, num))
        return Cell(
            plan.place_obj(arrs["id"], e.slot, e.axis),
            plan.place_obj(arrs["num"], e.slot, e.axis),
            plan.place_obj(arrs["nid"], e.slot, e.axis),
            plan.place_obj(arrs["kind"], e.slot, e.axis),
        )
    if isinstance(e, PVal):
        arrs = env.params[e.slot]
        if e.f.startswith("row:"):
            return Cell(plan.place_param(arrs[e.f], e.slot, e.axis),
                        env.f32(0.0), env.i32(0), env.i8(0))
        if e.f == "key":
            sid = plan.place_param(arrs["key_id"], e.slot, e.axis)
            num = plan.place_param(arrs["key_num"], e.slot, e.axis)
            return Cell(sid, num, plan.place_param(arrs["key_nid"], e.slot,
                                                   e.axis),
                        _key_kind(env, sid, num))
        return Cell(
            plan.place_param(arrs["id"], e.slot, e.axis),
            plan.place_param(arrs["num"], e.slot, e.axis),
            plan.place_param(arrs["nid"], e.slot, e.axis),
            plan.place_param(arrs["kind"], e.slot, e.axis),
        )
    if isinstance(e, Const):
        if e.kind == "id":
            return Cell(env.i32(e.value), env.f32(float("nan")), env.i32(0),
                        env.i8(K_STR))
        if e.kind == "numc":
            num, nid = e.value
            return Cell(env.i32(0), env.f32(num), env.i32(nid),
                        env.i8(K_NUM))
        if e.kind == "bool":
            return Cell(env.i32(0), env.f32(1.0 if e.value else 0.0),
                        env.i32(0),
                        env.i8(K_TRUE if e.value else K_FALSE))
        if e.kind == "rowidx":
            return Cell(env.i32(e.value), env.f32(0.0), env.i32(0),
                        env.i8(0))
        raise EvalError(f"unresolved const {e.kind}")
    if isinstance(e, DerivedVal):
        # one gather per cell: the unary function's image over the vocab,
        # indexed by the base cell's intern id (sid for strings, nid for
        # numbers; other kinds have no image -> absent)
        base = _eval_cell(plan, e.base, env)
        col = env.derived[e.col]
        is_str = base.kind == K_STR
        is_num = base.kind == K_NUM
        ix = torch.where(is_str, base.sid,
                         torch.where(is_num, base.nid, env.i32(0)))
        V = col["kind"].shape[0]
        ix = torch.clamp(ix, 0, V - 1).long()
        kind = torch.where(torch.logical_or(is_str, is_num),
                           col["kind"][ix], env.i8(K_ABSENT))
        return Cell(col["sid"][ix], col["num"][ix], col["nid"][ix], kind)
    raise EvalError(f"not a value expr: {type(e).__name__}")


def _eval_num(plan: ClausePlan, e: Expr, env: _Env):
    """-> (vlo, vhi, defined, nid-or-None): an interval [vlo, vhi]
    containing the true value (evaljax._eval_num)."""
    if isinstance(e, SumReduce):
        inner = _eval_bool(plan, e.e, env)
        pres = plan.presence(e.axis, env)
        pos = plan.axpos[e.axis]
        one, zero = env.f32(1.0), env.f32(0.0)
        slo = torch.sum(torch.where(torch.logical_and(inner.lo, pres), one,
                                    zero), dim=pos, keepdim=True)
        shi = slo if inner.is_exact else torch.sum(
            torch.where(torch.logical_and(inner.hi, pres), one, zero),
            dim=pos, keepdim=True)
        return slo, shi, env.b(True), None
    if isinstance(e, OVal) and e.f in ("count", "countz"):
        arrs = env.feats[e.slot]
        val = plan.place_obj(arrs["count"], e.slot, None)
        if e.f == "countz":
            return val, val, env.b(True), None
        kinds = plan.place_obj(arrs["kind"], e.slot, None)
        return val, val, kinds != K_ABSENT, None
    if isinstance(e, PVal) and e.f == "count":
        arrs = env.params[e.slot]
        val = plan.place_param(arrs["count"], e.slot, None)
        return val, val, env.b(True), None
    if isinstance(e, Arith):
        llo, lhi, ld, _ = _eval_num(plan, e.lhs, env)
        rlo, rhi, rd, _ = _eval_num(plan, e.rhs, env)
        defined = torch.logical_and(ld, rd)
        if e.op == "add":
            lo, hi = llo + rlo, lhi + rhi
        elif e.op == "sub":
            lo, hi = llo - rhi, lhi - rlo
        elif e.op == "mul":
            # interval product: extremes are among the endpoint products
            a, b, c, d = llo * rlo, llo * rhi, lhi * rlo, lhi * rhi
            lo = torch.minimum(torch.minimum(a, b), torch.minimum(c, d))
            hi = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
        else:
            raise EvalError(f"arith op {e.op}")
        # widen by the f32 rounding slack plus a tiny absolute term, then
        # scrub nan (inf - inf, 0 * inf) to the unbounded interval —
        # threshold comparisons over-fire, never under-fire
        eps = env.f32(1e-5)
        tiny = env.f32(1e-30)
        lo = lo - (torch.abs(lo) * eps + tiny)
        hi = hi + (torch.abs(hi) * eps + tiny)
        lo = torch.where(torch.isnan(lo), env.f32(-float("inf")), lo)
        hi = torch.where(torch.isnan(hi), env.f32(float("inf")), hi)
        return lo, hi, defined, None
    cell = _eval_cell(plan, e, env)
    return cell.num, cell.num, cell.kind == K_NUM, cell.nid


def _cell_eq(l: Cell, r: Cell):
    """(eq-ish value, defined, maybe). Arrays/objects compare as 'maybe'."""
    defined = torch.logical_and(l.kind != K_ABSENT, r.kind != K_ABSENT)
    same_kind = l.kind == r.kind
    str_eq = torch.logical_and(l.kind == K_STR, l.sid == r.sid)
    num_eq = torch.logical_and(l.kind == K_NUM, l.nid == r.nid)
    lit_eq = torch.logical_and(same_kind, torch.logical_or(
        torch.logical_or(str_eq, num_eq),
        torch.logical_and(l.kind != K_STR, l.kind != K_NUM)))
    maybe = torch.logical_and(
        same_kind, torch.logical_or(l.kind == K_ARR, l.kind == K_OBJ))
    return torch.logical_or(lit_eq, maybe), defined, maybe


def _eval_bool(plan: ClausePlan, e: Expr, env: _Env) -> BPair:
    land, lor, lnot = torch.logical_and, torch.logical_or, torch.logical_not
    if isinstance(e, Cmp):
        if e.dtype == "auto":
            l = _eval_cell(plan, e.lhs, env)
            r = _eval_cell(plan, e.rhs, env)
            eq, defined, maybe = _cell_eq(l, r)
            if e.op == "eq":
                return BPair(land(defined, land(eq, lnot(maybe))),
                             land(defined, eq))
            if e.op == "ne":
                return BPair(land(defined, lnot(eq)),
                             land(defined, lor(lnot(eq), maybe)))
            raise EvalError(f"auto cmp op {e.op}")
        lvlo, lvhi, ld, lnid = _eval_num(plan, e.lhs, env)
        rvlo, rvhi, rd, rnid = _eval_num(plan, e.rhs, env)
        defined = land(ld, rd)
        if lnid is not None and rnid is not None:
            tie = land(lvlo == rvlo, land(lnid != rnid,
                                          land(lnid != 0, rnid != 0)))
            exact = False
        else:
            tie = env.b(False)
            exact = (lvlo is lvhi) and (rvlo is rvhi)
        point = (lvlo is lvhi) and (rvlo is rvhi)
        if e.op == "lt":
            lo, hi = lvhi < rvlo, lor(lvlo < rvhi, tie)
        elif e.op == "gt":
            lo, hi = lvlo > rvhi, lor(lvhi > rvlo, tie)
        elif e.op == "le":
            lo = land(lvhi <= rvlo, lnot(tie))
            hi = lvlo <= rvhi
        elif e.op == "ge":
            lo = land(lvlo >= rvhi, lnot(tie))
            hi = lvhi >= rvlo
        elif e.op == "eq":
            pts = (lvlo == rvlo) if point else land(
                lvlo == lvhi, land(rvlo == rvhi, lvlo == rvlo))
            lo = land(pts, lnot(tie))
            hi = land(lvlo <= rvhi, rvlo <= lvhi)  # overlap
        elif e.op == "ne":
            pts = (lvlo == rvlo) if point else land(
                lvlo == lvhi, land(rvlo == rvhi, lvlo == rvlo))
            lo = lor(lvhi < rvlo, rvhi < lvlo)  # disjoint
            hi = lnot(land(pts, lnot(tie)))
        else:
            raise EvalError(f"cmp op {e.op}")
        lo = land(defined, lo)
        hi = lo if exact else land(defined, hi)
        return BPair(lo, hi)
    if isinstance(e, MatchLookup):
        # table [V, W] int32 view of the uint32 row bitsets: gather the
        # pattern row's word for the string and test its bit
        row = _eval_cell(plan, e.row, env).sid
        sv = _eval_cell(plan, e.sid, env)
        defined = land(row >= 0, sv.kind == K_STR)
        V, W = env.table.shape
        r = torch.clamp(row, 0, W * 32 - 1).long()
        s = torch.clamp(sv.sid, 0, V - 1).long()
        word = env.table[s, r >> 5]
        hit = ((word >> (r & 31).to(torch.int32)) & 1) != 0
        return BPair.exact(land(defined, hit))
    if isinstance(e, Truthy):
        c = _eval_cell(plan, e.e, env)
        return BPair.exact(land(c.kind != K_ABSENT, c.kind != K_FALSE))
    if isinstance(e, Exists):
        c = _eval_cell(plan, e.e, env)
        return BPair.exact(c.kind != K_ABSENT)
    if isinstance(e, KindIs):
        c = _eval_cell(plan, e.e, env)
        hit = None
        for k in e.kinds:
            t = c.kind == k
            hit = t if hit is None else lor(hit, t)
        return BPair.exact(hit if hit is not None else env.b(False))
    if isinstance(e, And):
        out = None
        for x in e.items:
            v = _eval_bool(plan, x, env)
            out = v if out is None else _band(out, v)
        return out if out is not None else BPair.exact(env.b(True))
    if isinstance(e, Or):
        out = None
        for x in e.items:
            v = _eval_bool(plan, x, env)
            out = v if out is None else _bor(out, v)
        return out if out is not None else BPair.exact(env.b(False))
    if isinstance(e, Not):
        inner = _eval_bool(plan, e.e, env)
        for ax in e.local_axes:
            inner = _bany(inner, plan.presence(ax, env), plan.axpos[ax])
        return _bnot(inner)
    if isinstance(e, OrReduce):
        inner = _eval_bool(plan, e.e, env)
        return _bany(inner, plan.presence(e.axis, env), plan.axpos[e.axis])
    if isinstance(e, SumReduce):
        slo, shi, _, _ = _eval_num(plan, e, env)
        lo = slo != 0
        hi = lo if shi is slo else shi != 0
        return BPair(lo, hi)
    if isinstance(e, Const):
        if e.kind == "bool":
            return BPair.exact(env.b(e.value))
        return BPair.exact(env.b(True))  # any non-false scalar literal
    raise EvalError(f"unsupported expr {type(e).__name__}")


def _eval_clause(plan: ClausePlan, env: _Env, n: int, c: int):
    pair = None
    for g in plan.clause.guards:
        v = _eval_bool(plan, g.expr, env)
        if g.negated:
            v = _bnot(v)
        pair = v if pair is None else _band(pair, v)
    if pair is None:
        pair = BPair.exact(env.b(True))
    success = pair.hi  # the filter verdict: possibly fires
    for a in plan.clause.axes:
        success = torch.logical_and(success, plan.presence(a.name, env))
    if success.dim() > 2:
        success = torch.any(success.reshape(
            success.shape[0], -1, success.shape[-1]), dim=1)
    if success.dim() == 1:
        success = success[None, :]
    elif success.dim() == 0:
        success = success.reshape(1, 1)
    return success.expand(n, c)


def param_c(params: dict) -> int:
    """Leading C dim of the first param array (1 for parameterless
    programs, whose verdicts are constraint-independent)."""
    for arrs in params.values():
        for a in arrs.values():
            return int(a.shape[0])
    return 1


def feat_rows(feats: dict) -> int:
    """Rows of the feature tree (1 for parameter-only programs)."""
    for arrs in feats.values():
        for a in arrs.values():
            return int(a.shape[0])
    return 1


def _axis_size(plan: ClausePlan, axis: str, feats: dict,
               params: dict) -> int:
    """The size of iteration axis `axis` on these inputs: the dim that
    the placement of its slot's presence leaf gives it."""
    ax = plan.axis_table[axis]
    if ax.kind == "param":
        kinds = params[ax.slot]["kind"]
        placed = plan.place_param(torch.empty(kinds.shape, device="meta"),
                                  ax.slot, axis)
    else:
        kinds = feats[ax.slot]["kind"]
        placed = plan.place_obj(torch.empty(kinds.shape, device="meta"),
                                ax.slot, axis)
    return int(placed.shape[plan.axpos[axis]])


def clause_work(plans: list, feats: dict, params: dict, table, derived
                ) -> dict:
    """What one K2 call must do on these inputs, counted from the Program
    IR and the leaf shapes (never from a kernel's code, so no kernel
    design can move it):
      bytes: every input leaf read once, the [N, W] int32 words written
        once;
      pair_trips: for each clause, N x C x the product of the sizes of
        the iteration axes it ranges over — one pass of the clause body
        per (row, constraint, axis trip), as the JAX program's
        [N, axes..., C] layout evaluates it."""
    n = feat_rows(feats)
    c = param_c(params)
    w = max(1, (c + 31) // 32)
    leaves = [a for tree in (feats, params, derived)
              for arrs in tree.values() for a in arrs.values()] + [table]
    nbytes = sum(a.numel() * a.element_size() for a in leaves) + n * w * 4
    trips = 0
    for plan in plans:
        k = 1
        for axis in plan.axis_order:
            k *= _axis_size(plan, axis, feats, params)
        trips += n * c * k
    return {"bytes": int(nbytes), "pair_trips": int(trips)}


def pack_words(fires: torch.Tensor) -> torch.Tensor:
    """bool [n, C] -> int32 [n, ceil(C/32)] (uint32 bits; bit b of word w
    = column 32w+b)."""
    n, c = fires.shape
    w = max(1, (c + 31) // 32)
    pad = w * 32 - c
    if pad:
        fires = torch.nn.functional.pad(fires, (0, pad))
    weights = torch.ones(32, dtype=torch.int64, device=fires.device) << \
        torch.arange(32, dtype=torch.int64, device=fires.device)
    words = (fires.reshape(n, w, 32).to(torch.int64) * weights).sum(-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def unpack_words(words: np.ndarray) -> np.ndarray:
    """int32/uint32 [n, W] host words -> bool [n, 32W]."""
    u = np.asarray(words).view(np.uint32)
    bits = (u[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(u.shape[0], -1).astype(bool)


def clause_words_plain(plans: list, feats: dict, params: dict,
                       table: torch.Tensor, derived: dict,
                       chunk: int = 8192) -> torch.Tensor:
    """The plain version: evaluate every clause in the [N, axes..., C]
    layout, `chunk` rows at a time, OR them and pack the words."""
    device = table.device
    c = param_c(params)
    n_all = feat_rows(feats)
    outs = []
    for start in range(0, n_all, chunk):
        stop = min(n_all, start + chunk)
        sub = ({slot: {nm: a[start:stop] for nm, a in arrs.items()}
                for slot, arrs in feats.items()} if feats else feats)
        env = _Env(sub, params, table, derived, device)
        n = stop - start
        fires = None
        for plan in plans:
            v = _eval_clause(plan, env, n, c)
            fires = v if fires is None else torch.logical_or(fires, v)
        if fires is None:
            fires = torch.zeros((n, c), dtype=torch.bool, device=device)
        outs.append(pack_words(fires))
    return torch.cat(outs, dim=0)


def clause_words(plans: list, feats: dict, params: dict, table: torch.Tensor,
                 derived: dict, chunk: int = 8192,
                 cache: dict | None = None, aot=None) -> torch.Tensor:
    """K2 wrapper: packed verdict words [N, W] int32 for every feature row
    (N = 1 for parameter-only programs). CPU tensors take the plain
    version; CUDA tensors launch the generated Triton kernel (compiled
    once per template and shape signature into `cache`; with `aot`,
    (AotStore, fingerprint, kind), its variants go through the program
    store: clause_triton.launch)."""
    if table.device.type == "cpu":
        return clause_words_plain(plans, feats, params, table, derived,
                                  chunk=chunk)
    if table.device.type != "cuda":
        raise ValueError(f"clause_words: unsupported device {table.device}")
    from . import clause_triton

    out = clause_triton.launch(plans, feats, params, table, derived,
                               cache if cache is not None else {}, aot)
    count_launch(clause_words)
    return out


clause_words.launches = 0
