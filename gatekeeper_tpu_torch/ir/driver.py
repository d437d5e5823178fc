"""TorchDriver: the vectorized evaluation backend on PyTorch.

Drop-in Driver (same seam as client/drivers.py) that compiles templates to
device programs at PutModules time and evaluates Review/Audit queries as
batched tensor sweeps on one device:

    reviews ──extract──▶ feature tensors ─┐
    constraints ─encode─▶ param tensors  ─┤─▶ K2 verdict words  (device)
    match masks (host, grouped)          ─┘        │ K1
                                        firing pairs ──▶ interpreter
                                                         (exact msgs)

The single-device core of the JAX package's TpuDriver: templates outside
the compilable subset (ir/compile.py), and the inventory-join kinds in
this version, keep the inherited interpreter path per template. The
device filter may over-fire; the host materialization re-check is
authoritative, so results equal the interpreter driver's.

Every compiled kind with a non-empty match mask evaluates on the device
(audits always; review batches from MIN_DEVICE_BATCH reviews). A
device-path exception propagates to the caller.
"""

from __future__ import annotations

import logging
import re
import weakref
from typing import Any, Iterable, Optional

import numpy as np
import torch

from ..client.drivers import DriverError, RegoDriver
from ..client.types import Result
from ..ops.derived import (
    DerivedTables,
    builtin_unary,
    interp_pred,
    interp_unary,
    split_part,
    strip_prefix,
)
from ..ops.strtab import MatchTables, StringTable
from ..rego import ast as A
from ..target.batch import match_masks
from ..kernels.clause import EvalError, param_c
from .carry import to_tensor
from .compile import Uncompilable, compile_template
from .evaltorch import CompiledTemplate
from .features import extract_batch
from .params import encode_params

_PREFIX_RE = re.compile(r'^templates\["([^"]+)"\]\["([^"]+)"\]$')

log = logging.getLogger("gatekeeper_tpu_torch.ir.driver")


def merge_template_modules(mods: list) -> Optional[A.Module]:
    """Flatten a template's entry + lib modules into one compile unit.

    The rewriter (client/rewriter.py) namespaces libs under
    `libs.<target>.<Kind>...` and turns lib calls into
    `data.libs...fn(...)` / refs into `data.libs...rule`. For the
    vectorized compiler we flatten each lib rule to a unique local name
    and redirect those data paths to it, so specialization and helper
    inlining see one module. Returns None when the shape is unexpected
    (falls back to the interpreter path)."""
    from dataclasses import replace as dc_replace

    entry = mods[0]
    if not entry.package or entry.package[0] != "templates":
        return None
    renames: dict[tuple, str] = {}
    rules = list(entry.rules)
    for m in mods[1:]:
        for r in m.rules:
            flat = "__lib_" + "_".join(m.package[3:]) + "__" + r.name
            renames[("data",) + tuple(m.package) + (r.name,)] = flat
            rules.append(dc_replace(r, name=flat))

    def fix_term(t):
        if isinstance(t, A.Call):
            if t.fn and t.fn[0] == "data":
                flat = renames.get(tuple(t.fn))
                if flat is not None:
                    return A.Call((flat,), tuple(fix_term(a)
                                                 for a in t.args))
            return A.Call(t.fn, tuple(fix_term(a) for a in t.args))
        if isinstance(t, A.Ref):
            if isinstance(t.base, A.Var) and t.base.name == "data":
                statics = []
                for a in t.args:
                    if isinstance(a, A.Scalar) and isinstance(a.value, str):
                        statics.append(a.value)
                    else:
                        break
                for ln in range(len(statics), 0, -1):
                    flat = renames.get(("data",) + tuple(statics[:ln]))
                    if flat is not None:
                        rest = tuple(fix_term(a) for a in t.args[ln:])
                        if not rest:
                            return A.Var(flat)
                        return A.Ref(base=A.Var(flat), args=rest)
            return A.Ref(base=fix_term(t.base),
                         args=tuple(fix_term(a) for a in t.args))
        if isinstance(t, A.BinOp):
            return A.BinOp(t.op, fix_term(t.lhs), fix_term(t.rhs))
        if isinstance(t, A.UnaryMinus):
            return A.UnaryMinus(fix_term(t.term))
        if isinstance(t, (A.ArrayLit, A.SetLit)):
            return type(t)(tuple(fix_term(x) for x in t.items))
        if isinstance(t, A.ObjectLit):
            return A.ObjectLit(tuple((fix_term(k), fix_term(v))
                                     for k, v in t.items))
        if isinstance(t, (A.ArrayCompr, A.SetCompr)):
            return type(t)(fix_term(t.head),
                           tuple(dc_replace(l, expr=fix_term(l.expr))
                                 for l in t.body))
        if isinstance(t, A.ObjectCompr):
            return A.ObjectCompr(fix_term(t.key), fix_term(t.value),
                                 tuple(dc_replace(l, expr=fix_term(l.expr))
                                       for l in t.body))
        if isinstance(t, (A.Assign, A.Unify)):
            return type(t)(fix_term(t.lhs), fix_term(t.rhs))
        return t

    fixed = [dc_replace(
        r,
        key=fix_term(r.key) if r.key is not None else None,
        value=fix_term(r.value) if r.value is not None else None,
        args=tuple(fix_term(a) for a in r.args),
        body=tuple(dc_replace(l, expr=fix_term(l.expr)) for l in r.body),
    ) for r in rules]
    return dc_replace(entry, rules=tuple(fixed))


def _module_reads_data(module: A.Module) -> bool:
    """Does any rule reference the data document (inventory reads)?
    Decides which compile stage's fallback reason is the actionable one:
    a data-reading template was always headed for the join compiler, so
    its join reason is reported; a review-pure template's dense reason
    is."""
    found = [False]

    def walk(t) -> None:
        if found[0]:
            return
        if isinstance(t, A.Var):
            if t.name == "data":
                found[0] = True
        elif isinstance(t, A.Ref):
            walk(t.base)
            for a in t.args:
                walk(a)
        elif isinstance(t, A.Call):
            if t.fn and t.fn[0] == "data":
                found[0] = True
            for a in t.args:
                walk(a)
        elif isinstance(t, A.BinOp):
            walk(t.lhs)
            walk(t.rhs)
        elif isinstance(t, A.UnaryMinus):
            walk(t.term)
        elif isinstance(t, (A.ArrayLit, A.SetLit)):
            for x in t.items:
                walk(x)
        elif isinstance(t, A.ObjectLit):
            for k, v in t.items:
                walk(k)
                walk(v)
        elif isinstance(t, (A.ArrayCompr, A.SetCompr, A.ObjectCompr)):
            for lit in t.body:
                if not isinstance(lit.expr, A.SomeDecl):
                    walk(lit.expr)
            for h in (getattr(t, "head", None), getattr(t, "key", None),
                      getattr(t, "value", None)):
                if h is not None:
                    walk(h)
        elif isinstance(t, (A.Assign, A.Unify)):
            walk(t.lhs)
            walk(t.rhs)

    for r in module.rules:
        for lit in r.body:
            if not isinstance(lit.expr, A.SomeDecl):
                walk(lit.expr)
        for h in (r.key, r.value):
            if h is not None:
                walk(h)
    return found[0]


def _expand_parameterless(rows, cols, c_dev: int, n_cons: int):
    """A parameterless program has no C axis on device (verdicts are
    [N, 1], constraint-independent); expand each firing row to every
    constraint, preserving row-major order, exactly as the dense
    [N, 1] & mask[N, C] broadcast did."""
    if c_dev == 1 and n_cons > 1:
        n_pairs = len(rows)
        rows = np.repeat(rows, n_cons)
        cols = np.tile(np.arange(n_cons, dtype=cols.dtype), n_pairs)
    return rows, cols


def _pad_cbucket(enc: dict, c: int) -> dict:
    """Pad encoded parameter tensors along the constraint axis to its
    power-of-two bucket, replicating the LAST real constraint into the
    padding columns (their verdicts are sliced off on device via n_cons
    — see evaljax fires_*). The C axis then only changes shape when a
    bucket boundary is crossed, so adding or removing one constraint to
    a library re-hits every cached/AOT device program instead of
    triggering a fresh XLA compile mid-serving (the same trick the
    vocab capacity and extraction axes already use)."""
    from .features import _bucket

    cap = _bucket(c)
    if cap == c or not enc:
        return enc
    pad = cap - c
    return {slot: {nm: np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1),
                              mode="edge")
                   for nm, a in arrs.items()}
            for slot, arrs in enc.items()}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DriverError(
            f"TorchDriver(device={str(device)!r}): no CUDA card is visible "
            "(torch.cuda.is_available() is False); pass device='cpu' to "
            "evaluate with the kernels' plain versions on the CPU")
    return dev


class TorchDriver(RegoDriver):
    # batches below this size never pay a device dispatch
    MIN_DEVICE_BATCH = 4

    # review batches at or above this candidate count take the sparse
    # firing-pair path (K2 + K1 on the device) instead of the dense
    # verdict words
    SPARSE_BATCH_MIN = 4096

    def __init__(self, device="cuda"):
        self.device = _resolve_device(device)
        super().__init__()
        self.strtab = StringTable()
        self.match_tables = MatchTables(self.strtab)
        self.derived_tables = DerivedTables(self.strtab)
        self._compiled: dict[str, Optional[CompiledTemplate]] = {}
        self._programs: dict[str, Any] = {}
        self._modules: dict[str, A.Module] = {}
        self._derived_cols: dict[str, list[int]] = {}  # kind -> global cols
        # generation counters for cache invalidation
        self._constraint_gen = 0
        self._data_gen = 0
        # per-kind caches: {kind: {key: value}} so template updates can
        # invalidate with the bare kind
        self._param_cache: dict[str, dict] = {}
        self._feat_cache: dict[str, dict] = {}
        # host ndarray (by identity, held weakly) -> device tensor:
        # steady-state sweeps must not re-upload cached tensors
        self._dev_cache: dict[int, tuple] = {}
        # audit match-mask cache: (target, kind) -> (gen-key, reviews, mask)
        self._mask_cache: dict = {}
        # vocab-capacity padding cache: id(src) -> (weakref, padded)
        self._vpad_cache: dict = {}
        # per-(kind, path) evaluation counters (device / interp)
        self._eval_counts: dict[tuple, int] = {}
        # vectorized message materialization (ir/vecmat.py): per-kind
        # message plans (None = exact path) and rendered witness columns
        self._msg_plans: dict[str, Any] = {}
        self._witcols: dict = {}
        # interpreter-bound kinds: kind -> {"reason", "dense", "join"}
        self._fallback: dict[str, dict] = {}
        # rows per chunk of the plain version's [chunk, axes..., C]
        # intermediates; also the sweep's slab granularity (_sweep_slab)
        self.sweep_chunk = 8192
        self.last_audit_path: Optional[str] = None
        self.last_review_batch_path: Optional[str] = None

    # ------------------------------------------------------------- modules

    def _forget(self, kind: str) -> None:
        for cache in (self._compiled, self._programs, self._modules,
                      self._derived_cols, self._param_cache,
                      self._feat_cache, self._msg_plans, self._fallback):
            cache.pop(kind, None)

    def put_modules(self, prefix: str, modules: Iterable[A.Module]) -> None:
        mods = list(modules)
        super().put_modules(prefix, mods)
        m = _PREFIX_RE.match(prefix)
        if not m:
            return
        kind = m.group(2)
        self._forget(kind)
        module = mods[0] if len(mods) == 1 else merge_template_modules(mods)
        if module is None:
            self._compiled[kind] = None
            self._note_fallback(
                kind, dense=("module-shape",
                             "template entry/lib module merge failed"))
            return
        try:
            self._programs[kind] = compile_template(module, kind)
            self._modules[kind] = module
        except Uncompilable as de:
            self._compiled[kind] = None
            if _module_reads_data(module):
                # cross-object templates: the inventory-join evaluator is
                # not part of this package yet; the interpreter serves
                self._note_fallback(
                    kind, dense=(de.code, de.detail),
                    join=("join-not-ported",
                          "inventory-join device evaluation is not "
                          "ported; the interpreter serves this kind"),
                    reads_data=True)
            else:
                self._note_fallback(kind, dense=(de.code, de.detail))

    def delete_modules(self, prefix: str) -> int:
        n = super().delete_modules(prefix)
        m = _PREFIX_RE.match(prefix)
        if m:
            self._forget(m.group(2))
        return n

    def compiled_for(self, kind: str) -> Optional[CompiledTemplate]:
        """Lazily wrap the Program in a device evaluator, registering its
        derived columns (host-interpreted unary fns) and interpreted
        predicate ops with the shared tables."""
        if kind in self._compiled:
            return self._compiled[kind]
        prog = self._programs.get(kind)
        if prog is None:
            self._compiled[kind] = None
            return None
        try:
            module = self._modules[kind]
            cols: list[int] = []
            for spec in prog.derived:
                if spec.kind == "fn":
                    key = ("fn", kind, spec.arg)
                    fn = interp_unary(module, spec.arg)
                elif spec.kind == "split":
                    sep, i, k = spec.arg.rsplit("|", 2)
                    key = ("split", spec.arg)
                    fn = split_part(sep, int(i), int(k))
                elif spec.kind == "strip_prefix":
                    key = ("strip_prefix", spec.arg)
                    fn = strip_prefix(spec.arg)
                elif spec.kind == "builtin":
                    key = ("builtin", spec.arg)
                    fn = builtin_unary(spec.arg)
                else:
                    raise EvalError(f"unknown derived kind {spec.kind}")
                cols.append(self.derived_tables.col(key, fn))
            for op, fn_name in prog.pred_ops:
                pat_i = int(op.rsplit(":", 1)[1])
                self.match_tables.register_op(
                    op, interp_pred(module, fn_name, pat_i))
            ct = CompiledTemplate(prog, self.strtab, self.match_tables,
                                  kind=kind)
            self._derived_cols[kind] = cols
        except Exception as e:
            self._demote(kind, "lowering", e)
            ct = None
        self._compiled[kind] = ct
        return ct

    def _note_fallback(self, kind: str, dense: tuple,
                       join: Optional[tuple] = None,
                       reads_data: bool = False) -> None:
        """Record WHY a kind is interpreter-bound (the stable taxonomy
        code per compile stage). The headline reason is the stage the
        template was headed for: the join stage for a data-reading
        template, else the dense compiler."""
        reason = (join[0] if join is not None and reads_data
                  else dense[0])
        self._fallback[kind] = {
            "reason": reason,
            "dense": {"code": dense[0], "detail": dense[1]},
            "join": ({"code": join[0], "detail": join[1]}
                     if join is not None else None),
        }
        log.info("template %s is interpreter-bound (%s): dense=%s join=%s",
                 kind, reason, dense, join)

    def fallback_reasons(self) -> dict:
        """kind -> {"reason", "dense": {code, detail}, "join": {...}}
        for every interpreter-bound kind."""
        return {k: dict(v) for k, v in self._fallback.items()}

    def _demote(self, kind: str, reason: str, exc: Exception) -> None:
        """A device->interpreter demotion must never be silent."""
        log.warning("template %s demoted to interpreter path (%s): %s: %s",
                    kind, reason, type(exc).__name__, exc)

    def compiled_kinds(self) -> list[str]:
        return sorted(self._programs)

    def note_eval(self, kind: str, path: str) -> None:
        """Count one evaluation of `kind` via `path` (device / interp)."""
        self._eval_counts[(kind, path)] = \
            self._eval_counts.get((kind, path), 0) + 1

    def eval_counts(self) -> dict:
        """(kind, path) -> evaluations served, since construction."""
        return dict(self._eval_counts)

    # ---------------------------------------------------------------- data

    def put_data(self, path: tuple, data: Any) -> None:
        super().put_data(path, data)
        self._bump(path)

    def delete_data(self, path: tuple) -> bool:
        out = super().delete_data(path)
        self._bump(path)
        return out

    def drop_inventory_caches(self) -> None:
        """Full re-encode backstop (see RegoDriver): additionally drops
        the encoded feature tensors and match masks."""
        super().drop_inventory_caches()
        self._data_gen += 1
        self._feat_cache.clear()
        self._mask_cache.clear()
        self._witcols.clear()

    def _bump(self, path: tuple) -> None:
        if path and path[0] == "constraints":
            self._constraint_gen += 1
            self._param_cache.clear()
        else:
            self._data_gen += 1

    def _dev(self, tree):
        """Device-resident view of a tree of host ndarrays, cached by leaf
        identity. Entries hold the host array WEAKLY and self-evict when
        the producing cache drops it. CPU tensors share the host memory
        and are not cached."""
        if self.device.type == "cpu":
            return _tree_map(lambda a: to_tensor(a, self.device), tree)
        cache = self._dev_cache
        device = self.device

        def put(arr):
            key = id(arr)
            hit = cache.get(key)
            if hit is not None and hit[0]() is arr:
                return hit[1]
            d = to_tensor(arr, device)
            try:
                ref = weakref.ref(arr, lambda _r, k=key: cache.pop(k, None))
            except TypeError:
                return d  # unweakrefable leaf: use without caching
            cache[key] = (ref, d)
            return d

        return _tree_map(put, tree)

    # --------------------------------------------------------------- audit

    def _eval_audit(self, target: str, trace: Optional[list]) -> list[Result]:
        self._in_audit_sweep = True  # arms the violations cap (when set)
        try:
            return self._eval_audit_inner(target, trace)
        finally:
            self._in_audit_sweep = False

    def _eval_audit_inner(self, target: str,
                          trace: Optional[list]) -> list[Result]:
        """Two phases across kinds: enqueue EVERY compiled kind's device
        sweep first, then sync + materialize kind by kind, so the card
        works through later kinds while the host renders earlier ones."""
        constraints = self._constraints(target)
        if not constraints:
            return []
        lookup_ns = self._namespace_lookup(target)
        inventory = self._inventory_tree(target)
        reviews = self._inventory_reviews(target)
        by_kind: dict[str, list[dict]] = {}
        for c in constraints:
            by_kind.setdefault(c.get("kind"), []).append(c)
        sig_cache = self._audit_sig_cache(target)
        by_res: dict[str, list] = {}
        pending: list = []
        for kind in sorted(by_kind):
            cons = by_kind[kind]
            ct = self.compiled_for(kind)
            if ct is not None and trace is None:
                pending.append((kind, self._audit_dispatch(
                    target, kind, ct, cons, reviews, lookup_ns, sig_cache)))
            elif ct is not None:
                by_res[kind] = self._audit_compiled(target, kind, ct, cons,
                                                    reviews, lookup_ns,
                                                    inventory, trace,
                                                    sig_cache)
            else:
                by_res[kind] = self._audit_interp(target, kind, cons,
                                                  reviews, lookup_ns,
                                                  inventory, trace,
                                                  sig_cache)
        for kind, st in pending:
            by_res[kind] = self._audit_consume(target, kind, st,
                                               by_kind[kind], inventory)
        results: list[Result] = []
        for kind in sorted(by_kind):
            results.extend(by_res.get(kind, []))
        self.last_audit_path = f"single({self.device.type})"
        return results

    @staticmethod
    def _sweep_slab(n_true: int, chunk: int = 8192) -> int:
        half = (n_true + 1) // 2
        return max(chunk * 4, ((half + chunk - 1) // chunk) * chunk)

    def _dispatch_handle(self, ct, feats, enc, table, derived, n_true,
                         n_cons=None):
        chunk = self.sweep_chunk
        return ct.fires_pairs_dispatch(feats, enc, table, derived,
                                       chunk=chunk,
                                       slab=self._sweep_slab(n_true, chunk),
                                       n_true=n_true, n_cons=n_cons)

    def _audit_dispatch(self, target, kind, ct, cons, reviews, lookup_ns,
                        sig_cache):
        """Phase 1 for one compiled kind: mask, feature prep, and the
        enqueue of every slab's kernels. Returns the consume state."""
        mask = self._match_mask(target, kind, cons, reviews, lookup_ns,
                                sig_cache)
        cand = np.flatnonzero(mask.any(axis=1))
        if cand.size == 0:
            return ("empty",)
        cand_reviews = [reviews[int(i)] for i in cand]
        feat_key = (self._data_gen, hash(cand.tobytes()))
        feats, enc, table, derived = self._prepare_eval(
            ct, kind, cand_reviews, cons, feat_key, cand=cand)
        handle = self._dispatch_handle(ct, feats, enc, table, derived,
                                       len(cand_reviews), n_cons=len(cons))
        self.note_eval(kind, "device")
        return ("h", mask, cand, cand_reviews, handle, param_c(enc))

    # ------------------------------------------- vectorized materialize

    def _msg_plan(self, kind: str):
        """The kind's message plan (ir/vecmat.py), or None for the exact
        per-pair path. Cached per template generation."""
        if kind in self._msg_plans:
            return self._msg_plans[kind]
        plan = None
        prog = self._programs.get(kind)
        module = self._modules.get(kind)
        if prog is not None and module is not None:
            from .vecmat import plan_messages
            try:
                plan = plan_messages(module, prog)
            except Exception as e:
                # a planner bug must degrade to the exact path, never
                # break materialization
                log.warning("message plan for %s failed (%s: %s); using "
                            "the exact evaluator", kind,
                            type(e).__name__, e)
                plan = None
        self._msg_plans[kind] = plan
        if plan is not None:
            log.info("template %s messages vectorized (%d witnesses)",
                     kind, len(plan.witnesses))
        return plan

    def _witness_col(self, target: str, w, base_reviews: list):
        """Rendered witness column (+ veto mask) over `base_reviews`,
        cached until the data revision moves or the list is replaced —
        steady-state audits fancy-index resident columns instead of
        re-walking the inventory."""
        key = (target, w)
        base_key = (id(base_reviews), len(base_reviews))
        ent = self._witcols.get(key)
        if ent is not None and ent[0] == self._data_rev and \
                ent[1] == base_key:
            return ent[2], ent[3]
        from .vecmat import build_row_witness

        arr, veto = build_row_witness(base_reviews, w)
        self._witcols[key] = (self._data_rev, base_key, arr, veto)
        return arr, veto

    def _vec_msgs(self, target, kind, cons, pair_reviews, rows, cols,
                  cand):
        """ir/vecmat.py plan evaluation for one pair batch: fill the
        plan's witnesses for every firing pair via numpy fancy-indexing
        and assemble messages as U-dtype concatenation — no per-pair
        Python. Returns (status[P] int8, msgs[P] list, details) or None
        (exact path). status: 1 = message ready, 0 = vetoed to the
        exact evaluator (absent / non-string / oversize witness), 2 =
        provably no violation (msg witness undefined for that
        constraint's parameters)."""
        plan = self._msg_plan(kind)
        if plan is None:
            return None
        program = self._programs.get(kind)
        if program is None:
            return None
        from . import vecmat

        if plan.conditions and not vecmat.check_conditions(
                program, plan.conditions, cons):
            return None
        rows_np = np.asarray(rows, dtype=np.int64)
        cols_np = np.asarray(cols, dtype=np.int64)
        # witness columns build over the STABLE full review list when
        # the caller maps pair rows through `cand` (identity
        # spot-checked), so steady-state sweeps reuse them; otherwise
        # over this call's pair_reviews
        base = pair_reviews
        base_rows = rows_np
        if cand is not None:
            full = self._inventory_reviews(target)
            cand_arr = np.asarray(cand, dtype=np.int64)
            if len(cand_arr) == len(pair_reviews) and (
                    not len(pair_reviews)
                    or (pair_reviews[0] is full[int(cand_arr[0])]
                        and pair_reviews[-1] is full[int(cand_arr[-1])])):
                base = full
                base_rows = cand_arr[rows_np]
        status = np.ones(len(rows_np), dtype=np.int8)
        parts: list = []
        for w in plan.witnesses:
            if w.kind == "const":
                parts.append(None)  # folded into the literal segments
                continue
            if w.kind == "param":
                strs = []
                dead = np.zeros(len(cons), dtype=bool)
                for k, c in enumerate(cons):
                    spec = c.get("spec")
                    spec = spec if isinstance(spec, dict) else {}
                    p = spec.get("parameters")
                    frz = self._freeze_params(c, p if p is not None
                                              else {})
                    s = vecmat.render_param_witness(w, frz)
                    if s is None:
                        dead[k] = True
                        strs.append("")
                    else:
                        strs.append(s)
                col_arr = (np.array(strs, dtype=str) if strs
                           else np.zeros(0, dtype="U1"))
                parts.append(col_arr[cols_np])
                if dead.any():
                    status[dead[cols_np]] = 2
                continue
            arr, veto = self._witness_col(target, w, base)
            status[veto[base_rows]] = 0
            parts.append(arr[base_rows])
        # assembly: literal segments merge into their neighbors; each
        # np.char.add runs as one C loop over the whole pair batch
        msgs = None
        lit = plan.segments[0]
        for w, part, seg in zip(plan.witnesses, parts,
                                plan.segments[1:]):
            if part is None:  # const witness: pure literal
                lit = lit + w.text + seg
                continue
            if lit:
                part = np.char.add(lit, part)
            lit = seg
            msgs = part if msgs is None else np.char.add(msgs, part)
        if msgs is None:
            msg_list = [lit] * len(rows_np)
        else:
            if lit:
                msgs = np.char.add(msgs, lit)
            msg_list = msgs.tolist()
        return status, msg_list, plan.details


    def _match_mask(self, target, kind, cons, reviews, lookup_ns,
                    sig_cache):
        key = (self._data_rev, self._constraint_gen)
        ent = self._mask_cache.get((target, kind))
        if ent is not None and ent[0] == key and ent[1] is reviews:
            return ent[2]
        if ent is not None and ent[1] is reviews and \
                ent[0][1] == self._constraint_gen:
            # replay object replacements onto the cached mask: all dirty
            # rows (last write wins) re-matched in ONE batched call
            notes = self._notes_between(ent[0][0], self._data_rev)
            if notes is not None:
                mask = ent[2]
                dirty: dict[int, dict] = {}
                for n in notes:
                    if n[2] == target:
                        dirty[n[3]] = n[5]
                if dirty:
                    idxs = sorted(dirty)
                    sub = match_masks(cons, [dirty[i] for i in idxs],
                                      lookup_ns, sig_cache)
                    mask[np.asarray(idxs)] = sub
                self._mask_cache[(target, kind)] = (key, reviews, mask)
                return mask
        mask = match_masks(cons, reviews, lookup_ns, sig_cache)
        self._mask_cache[(target, kind)] = (key, reviews, mask)
        return mask


    def _derived_arrays(self, kind: str, ct: CompiledTemplate) -> dict:
        """Program-local derived columns, extended to the current vocab.
        Must run after extraction/encoding interned this batch's strings
        (same ordering contract as materialize_packed). Arrays are padded
        to the vocab capacity bucket so their shapes stay stable under
        vocab growth (see ops.strtab.vocab_cap)."""
        cols = self._derived_cols.get(kind) or []
        if not cols:
            return {}
        global_arrays = self.derived_tables.materialize(cols)
        return {spec.col: {nm: self._pad_vocab(a)
                           for nm, a in global_arrays[g].items()}
                for spec, g in zip(ct.program.derived, cols)}

    def _pad_vocab(self, arr):
        """Pad a vocab-indexed array to the capacity bucket (cached by
        source identity so steady-state audits reuse one padded copy and
        its device buffer). Float pads are NaN (no number), others 0
        (pad sid / K_ABSENT)."""
        from ..ops.strtab import vocab_cap

        cap = vocab_cap(len(self.strtab))
        if arr.shape[0] >= cap:
            return arr
        import weakref

        ent = self._vpad_cache.get(id(arr))
        if ent is not None and ent[0]() is arr and \
                ent[1].shape[0] == cap:
            return ent[1]
        pad = np.zeros((cap,) + arr.shape[1:], dtype=arr.dtype)
        if arr.dtype.kind == "f":
            pad[:] = np.nan
        pad[: arr.shape[0]] = arr
        try:
            ref = weakref.ref(arr,
                              lambda _r, k=id(arr):
                              self._vpad_cache.pop(k, None))
        except TypeError:
            return pad
        self._vpad_cache[id(arr)] = (ref, pad)
        return pad


    def _audit_consume(self, target, kind, st, cons, inventory):
        """Phase 2: sync the dispatched slabs in order, materialize."""
        if st[0] == "empty":
            return []
        _tag, mask, cand, cand_reviews, handle, c_dev = st
        out: list[Result] = []
        for rows, cols in handle.pairs():
            rows, cols = _expand_parameterless(rows, cols, c_dev, len(cons))
            keep = mask[cand[rows], cols]
            out.extend(self.materialize_pairs(
                target, cons, cand_reviews, rows[keep], cols[keep],
                inventory, cand=cand))
        return out

    def _audit_interp(self, target, kind, cons, reviews, lookup_ns,
                      inventory, trace, sig_cache=None) -> list[Result]:
        self.note_eval(kind, "interp")
        out: list[Result] = []
        mask = self._match_mask(target, kind, cons, reviews, lookup_ns,
                                sig_cache)
        for r, review in enumerate(reviews):
            for c, constraint in enumerate(cons):
                if not mask[r, c]:
                    continue
                spec = constraint.get("spec")
                spec = spec if isinstance(spec, dict) else {}
                enforcement = spec.get("enforcementAction") or "deny"
                out.extend(self._eval_template_violations(
                    target, constraint, review, enforcement, inventory, trace))
        return out

    def _audit_compiled(self, target, kind, ct: CompiledTemplate, cons,
                        reviews, lookup_ns, inventory, trace,
                        sig_cache=None) -> list[Result]:
        """The traced audit of one compiled kind: device pairs, then the
        per-pair evaluator with the trace sink."""
        mask = self._match_mask(target, kind, cons, reviews, lookup_ns,
                                sig_cache)
        cand = np.flatnonzero(mask.any(axis=1))
        if cand.size == 0:
            return []
        cand_reviews = [reviews[int(i)] for i in cand]
        feat_key = (self._data_gen, hash(cand.tobytes()))
        rows, cols = self.eval_compiled_pairs(ct, kind, cand_reviews, cons,
                                              feat_key=feat_key, cand=cand)
        self.note_eval(kind, "device")
        keep = mask[cand[rows], cols]
        out = []
        for ri, ci in zip(rows[keep], cols[keep]):
            review = cand_reviews[int(ri)]
            constraint = cons[int(ci)]
            spec = constraint.get("spec")
            spec = spec if isinstance(spec, dict) else {}
            enforcement = spec.get("enforcementAction") or "deny"
            out.extend(self._eval_template_violations(
                target, constraint, review, enforcement, inventory, trace))
        return out

    # ------------------------------------------------------- compiled eval

    def eval_compiled(self, ct: CompiledTemplate, kind: str,
                      reviews: list[dict], cons: list[dict],
                      feat_key=None) -> np.ndarray:
        """fires[len(reviews), len(cons)] via the device kernels.
        feat_key, when given, caches extraction until inventory changes."""
        feats, enc, table, derived = self._prepare_eval(ct, kind, reviews,
                                                        cons, feat_key)
        fires = ct.fires_chunked(feats, enc, table, derived,
                                 chunk=self.sweep_chunk, n_cons=len(cons))
        return fires[: len(reviews)]

    def eval_compiled_pairs(self, ct: CompiledTemplate, kind: str,
                            reviews: list[dict], cons: list[dict],
                            feat_key=None, cand=None) -> tuple:
        """(rows, cols) firing pairs, row-major — the sparse form of
        eval_compiled."""
        feats, enc, table, derived = self._prepare_eval(ct, kind, reviews,
                                                        cons, feat_key,
                                                        cand=cand)
        rows, cols = ct.fires_pairs(feats, enc, table, derived,
                                    chunk=self.sweep_chunk,
                                    n_true=len(reviews), n_cons=len(cons))
        return _expand_parameterless(rows, cols, param_c(enc), len(cons))

    def _prepare_eval(self, ct: CompiledTemplate, kind: str,
                      reviews: list[dict], cons: list[dict], feat_key,
                      cand=None):
        """Encode parameters (cached per constraint generation), extract
        features (cached under feat_key when given), extend the derived
        columns and match table to the vocab, and place all of it on the
        driver's device."""
        params_key = (self._constraint_gen,
                      tuple((c.get("metadata") or {}).get("name", "")
                            for c in cons))
        kind_cache = self._param_cache.setdefault(kind, {})
        enc = kind_cache.get(params_key)
        if enc is None:
            param_dicts = []
            for c in cons:
                spec = c.get("spec")
                spec = spec if isinstance(spec, dict) else {}
                p = spec.get("parameters")
                param_dicts.append(p if p is not None else {})
            enc = encode_params(ct.program, param_dicts, self.strtab,
                                self.match_tables)
            # C-axis power-of-two bucketing: library edits inside a
            # bucket keep every kernel's shape signature
            enc = _pad_cbucket(enc, len(cons))
            kind_cache.clear()
            kind_cache[params_key] = enc
        feats = None
        if feat_key is not None:
            fcache = self._feat_cache.setdefault(kind, {})
            meta = fcache.get("__meta__")
            if meta is not None and meta["key"] == feat_key:
                feats = meta["feats"]
        if feats is None:
            feats, _buckets, _n_pad = extract_batch(ct.program, self.strtab,
                                                    reviews)
            if feat_key is not None:
                fcache.clear()
                fcache["__meta__"] = {"key": feat_key, "feats": feats}
        derived = self._derived_arrays(kind, ct)
        table = self.match_tables.materialize_packed()
        if feat_key is not None:
            # steady-state audit: keep the cached tensors device-resident.
            # One-shot feats (review batches) are not cached: the identity
            # cache would grow one dead entry per request
            feats = self._dev(feats)
        else:
            feats = _tree_map(lambda a: to_tensor(a, self.device), feats)
        return feats, self._dev(enc), self._dev(table), self._dev(derived)

    # ----------------------------------------------------- batched reviews

    def _review_batch_sparse(self, ct, kind, cand, cand_reviews, cons,
                             mask) -> list:
        """(review_index, constraint_index) firing pairs for one kind of a
        large batch, via the audit's slab dispatch (K2 + K1)."""
        feats, enc, table, derived = self._prepare_eval(
            ct, kind, cand_reviews, cons, feat_key=None)
        handle = self._dispatch_handle(ct, feats, enc, table, derived,
                                       len(cand_reviews), n_cons=len(cons))
        c_dev = param_c(enc)
        pairs = []
        for rows, cols in handle.pairs():
            rows, cols = _expand_parameterless(rows, cols, c_dev, len(cons))
            keep = mask[cand[rows], cols]
            pairs.extend(zip((int(x) for x in cand[rows[keep]]),
                             (int(x) for x in cols[keep])))
        return pairs

    def review_batch(self, target: str, reviews: list[dict]
                     ) -> list[list[Result]]:
        """Evaluate many admission reviews at once. Compiled kinds go
        through the device when the batch has at least MIN_DEVICE_BATCH
        reviews; the rest through the interpreter per review."""
        constraints = self._constraints(target)
        lookup_ns = self._namespace_lookup(target)
        inventory = self._inventory_tree(target)
        out: list[list[Result]] = [[] for _ in reviews]
        if not constraints:
            return out
        # autoreject applies per review before matching (regolib/src.go)
        from ..target.matcher import needs_autoreject
        from ..utils.values import freeze, thaw
        by_kind: dict[str, list[dict]] = {}
        for c in constraints:
            by_kind.setdefault(c.get("kind"), []).append(c)
        # results accumulate per (review, constraint) and assemble in
        # GLOBAL constraint order at the end, so a review's result list
        # is ordered exactly as the per-review violation query orders it
        auto: dict[tuple[int, int], Result] = {}
        acc: dict[tuple[int, int], list] = {}
        touched: dict[int, set] = {}  # review -> constraint ids with results
        for r, review in enumerate(reviews):
            for c in constraints:
                spec = c.get("spec")
                spec = spec if isinstance(spec, dict) else {}
                match = spec.get("match")
                match = match if isinstance(match, dict) else {}
                if needs_autoreject(match, review, lookup_ns):
                    touched.setdefault(r, set()).add(id(c))
                    auto[(r, id(c))] = Result(
                        msg="Namespace is not cached in OPA.",
                        metadata={"details": {}},
                        constraint=thaw(freeze(c)),
                        review=review,
                        enforcement_action=spec.get("enforcementAction")
                        or "deny",
                    )
        for kind in sorted(by_kind):
            cons = by_kind[kind]
            mask = match_masks(cons, reviews, lookup_ns)
            ct = self.compiled_for(kind)
            pairs = None
            if ct is not None and mask.any() and \
                    len(reviews) >= self.MIN_DEVICE_BATCH:
                cand = np.flatnonzero(mask.any(axis=1))
                cand_reviews = [reviews[int(i)] for i in cand]
                if len(cand_reviews) >= self.SPARSE_BATCH_MIN:
                    pairs = self._review_batch_sparse(
                        ct, kind, cand, cand_reviews, cons, mask)
                else:
                    fires = self.eval_compiled(ct, kind, cand_reviews, cons)
                    hits = np.logical_and(fires, mask[cand])
                    pairs = [(int(cand[ri]), int(ci))
                             for ri, ci in zip(*np.nonzero(hits))]
                self.note_eval(kind, "device")
            if pairs is None:
                if mask.any():
                    self.note_eval(kind, "interp")
                pairs = [(r, c) for r in range(len(reviews))
                         for c in range(len(cons)) if mask[r, c]]
            for r, ci in pairs:
                constraint = cons[ci]
                spec = constraint.get("spec")
                spec = spec if isinstance(spec, dict) else {}
                enforcement = spec.get("enforcementAction") or "deny"
                res = self._eval_template_violations(
                    target, constraint, reviews[r], enforcement,
                    inventory, None)
                if res:
                    touched.setdefault(r, set()).add(id(constraint))
                    acc.setdefault((r, id(constraint)), []).extend(res)
        # assemble per review over only the POPULATED constraints, ordered
        # by global constraint position (the per-review violation order)
        order = {id(c): k for k, c in enumerate(constraints)}
        for r, cids in touched.items():
            for cid in sorted(cids, key=order.__getitem__):
                a = auto.get((r, cid))
                if a is not None:
                    out[r].append(a)
                out[r].extend(acc.get((r, cid), ()))
        self.last_review_batch_path = f"single({self.device.type})"
        return out
