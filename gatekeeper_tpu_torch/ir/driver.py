"""TorchDriver: the vectorized evaluation backend on PyTorch.

Drop-in Driver (same seam as client/drivers.py) that compiles templates to
device programs at PutModules time and evaluates Review/Audit queries as
batched tensor sweeps on one device:

    reviews ──extract──▶ feature tensors ─┐
    constraints ─encode─▶ param tensors  ─┤─▶ K2 verdict words  (device)
    match masks (host, grouped)          ─┘        │ K1
                                        firing pairs ──▶ interpreter
                                                         (exact msgs)

The single-device core of the JAX package's TpuDriver. Cross-object
templates (inventory joins) go through ir/join.py: review keys against
the inventory's aggregated key table, K4 on the device from
MIN_DEVICE_REVIEWS candidates. Templates outside both compilers keep the
inherited interpreter path per template. The device filter may
over-fire; the host materialization re-check is authoritative, so
results equal the interpreter driver's.

A compiled kind evaluates on the device when the cost model
(_use_device_for_batch) says the device beats the host for its masked
pairs (review batches from MIN_DEVICE_BATCH reviews).

Compile lifecycle, as the JAX package's TpuDriver has it: a sweep shape
whose kernels have never run (_sweep_sig) serves from the host while a
background thread runs the device sweep once, so that Triton compiles
K2 off the serving path (_spawn_warm); an audit or a sparse batch waits
the compile out instead once the host time its cold kinds would take
passes ASYNC_WARM_MAX_HOST_S (_warm_gate). GATEKEEPER_TPU_ASYNC_COMPILE=0
compiles in the foreground. With a program store (aot_dir, or
GATEKEEPER_TPU_AOT_DIR; ir/aot.py) K2's compiled variants and the warm
sweep signatures persist: a warm boot loads the stored variants at
ingestion (_enqueue_prewarm) and adopts the signatures, so its first
sweep at a remembered shape launches on the device under the
no-inline-compile guard (_dispatch_guarded). A device-path or join-eval exception
quarantines the kind behind its own breaker (exponential backoff, one
half-open probe at a time) and the interpreter serves it; a successful
probe restores the device path.

Audits under churn: the parent's patch journal records single-object
replacements. An audit with unchanged constraints serves each review-pure
compiled kind from the delta cache (only the journal's dirty rows are
re-evaluated, on the host). A full sweep after churn replays the dirty
rows onto the kind's cached feature arrays (_patch_feats) and into their
device-resident copies with one K5 launch per kind (_dev_patch_rows)
instead of re-extracting and re-uploading every row.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
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
from ..utils import faults, profiling
from ..kernels import build as kernel_build
from ..kernels.clause import EvalError, feat_rows, param_c
from . import aot as aot_mod
from .aot import AotStore, enable_compile_cache
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


class _ServeHostThisRound(Exception):
    """Internal: a review batch should evaluate on the host path this
    round (its device program is still warming in the background); NOT
    a demotion."""


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

    # below this estimated host cost, a device dispatch can only add tail
    # latency (a probe may even carry a first-launch kernel compile)
    PROBE_FLOOR_S = 0.05

    # review batches at or above this candidate count take the sparse
    # firing-pair path (K2 + K1 on the device) instead of the dense
    # verdict words
    SPARSE_BATCH_MIN = 4096

    # async warm-up serves the host path only while its cost stays under
    # this; beyond it, blocking on the compile once is cheaper than
    # minutes of interpretation. The cold kinds of one audit or review
    # batch share it (_warm_gate): the measured host seconds of those
    # served so far, plus the estimate of the kind being decided
    ASYNC_WARM_MAX_HOST_S = 30.0

    # a half-open probe that never resolves (e.g. the cost model routed
    # it to the host without touching the device) releases its lease
    # after this long, letting another caller probe
    QUARANTINE_PROBE_LEASE_S = 30.0

    def __init__(self, device="cuda", aot_dir=None):
        self.device = _resolve_device(device)
        super().__init__()
        self.compile_cache_enabled = enable_compile_cache()
        self.strtab = StringTable()
        self.match_tables = MatchTables(self.strtab, self.device)
        self.derived_tables = DerivedTables(self.strtab)
        self._compiled: dict[str, Optional[CompiledTemplate]] = {}
        self._programs: dict[str, Any] = {}
        # inventory-join templates (ir/join.py): kind -> JoinProgram /
        # lazily-built JoinCompiled
        self._join_progs: dict[str, Any] = {}
        self._join_compiled: dict[str, Any] = {}
        self._modules: dict[str, A.Module] = {}
        # (shard_id, shard_count) when this driver sweeps one slice of
        # a sharded audit plane (set_audit_shard); None = whole plane
        self._audit_shard = None
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
        # join steady-state caches, one data generation deep:
        # (data_rev, {id(review): (review, frozen)}, {kind: {(ci,
        #  id(frozen)): (keys, ident)}})
        self._join_frz: tuple = (None, {}, {})
        # per-(kind, path) evaluation counters (device / delta / join /
        # interp) for /debug/templates
        self._eval_counts: dict[tuple, int] = {}
        self._eval_counts_lock = threading.Lock()
        # duty cycle: eval wall clock accumulated since the last
        # duty_cycle() sample (device sweeps, batched admission evals,
        # join probes, interpreter fallback), EMA-smoothed per sample
        # window (gatekeeper_tpu_device_duty_cycle{engine})
        self._busy_s = 0.0
        self._busy_t0 = time.monotonic()
        self._duty_ema = 0.0
        self._duty_sampled = False
        # vectorized message materialization (ir/vecmat.py): per-kind
        # message plans (None = exact path) and rendered witness columns
        self._msg_plans: dict[str, Any] = {}
        self._witcols: dict = {}
        # per-kind audit results observer (the streaming status writer):
        # called (target, kind, results) as each kind's sweep completes,
        # so status publishing overlaps the remaining kinds' sweeps
        self.on_kind_results: Optional[Any] = None
        # interpreter-bound kinds: kind -> {"reason", "dense", "join"}
        self._fallback: dict[str, dict] = {}
        # program store (ir/aot.py): K2's compiled variants + warm sweep
        # signatures, persisted under a directory so that a warm boot
        # loads the device programs instead of compiling them.
        # GATEKEEPER_TPU_AOT_DIR points it for bench/test processes.
        self.aot = AotStore()
        aot_dir = aot_dir or os.environ.get("GATEKEEPER_TPU_AOT_DIR", "")
        if aot_dir:
            self.aot.set_dir(aot_dir)
        # delta audit: kind -> "module reads `data`" (never delta-served);
        # (target, kind) -> the last full sweep's results by review row;
        # (reviews, data_rev, {id(review): index})
        self._data_taint: dict[str, bool] = {}
        self._audit_results_cache: dict = {}
        self._review_idx_cache: tuple = (None, None, None)
        # warm restart: kind -> snapshotted feature rows awaiting
        # adoption, valid while _data_gen == _restored_rows_gen
        self._restored_rows: dict = {}
        self._restored_rows_base: Optional[int] = None
        self._restored_rows_gen = -1
        self.restored_rows_adopted = 0
        # rows per chunk of the plain version's [chunk, axes..., C]
        # intermediates; also the sweep's slab granularity (_sweep_slab)
        self.sweep_chunk = 8192
        # cost-based dispatch EMAs (_use_device_for_batch): the device
        # path's latency, and the host's masked pairs per second (initial
        # estimate from the JAX package's driver; refined from real
        # batches and audits)
        self._dev_batch_lat_s: Optional[float] = None
        self._host_pair_rate: float = 100_000.0
        self._dev_skips = 0
        # one audit latency sample, from the first consumed kind
        self._lat_sampled = True
        # the last audit's sample as (taken, or None when a compile
        # dropped it; the JAX package's way: dispatch to first result with
        # the later kinds' host work inside), or None without a sample; a
        # diagnostic, read by no decision
        self.last_audit_lat_s: Optional[tuple] = None
        self.last_audit_path: Optional[str] = None
        self.last_review_batch_path: Optional[str] = None
        # async device warm-up: the FIRST sweep at a new shape serves
        # from the host path while a background thread runs the device
        # sweep once (Triton compiles K2 on its first launch); once warm,
        # sweeps hot-swap to the device. GATEKEEPER_TPU_ASYNC_COMPILE=0
        # restores compile-blocking dispatch (tests pin paths with it)
        self.async_warm = os.environ.get(
            "GATEKEEPER_TPU_ASYNC_COMPILE", "1") != "0"
        self._warm_done: set = set()
        # warm sigs adopted from the program store at a warm boot and not
        # yet dispatched in this process (_mark_stored_sigs_warm): their
        # first dispatch runs under no_inline_compile (_dispatch_guarded)
        self._warm_restored: set = set()
        self._warm_inflight: dict = {}           # sig -> done Event
        self._warm_fail: dict = {}               # sig -> failure count
        self._warm_lock = threading.Lock()       # guards the warm sets
        self._warm_sem = threading.Semaphore(1)  # one compile at a time
        # per thread, the current audit's or batch's cold-kind host
        # budget: .spent (seconds), .pending (the gate just sent a kind
        # to the host); _cold_host_begin / _cold_host_done
        self._cold = threading.local()
        # degraded-mode quarantine: an eval failure benches the kind's
        # device program behind its own breaker (exponential backoff,
        # capped) instead of demoting it forever; its reviews serve from
        # the interpreter, and a half-open probe restores the device path
        # once it succeeds. kind -> {"until", "fails", "reason",
        # "probe_at"}, guarded by its own lock
        self._quarantine: dict[str, dict] = {}
        self._quarantine_lock = threading.Lock()
        # failure-history memory: kind -> (fails, cleared_at). A kind
        # that re-quarantines shortly after clearing resumes its backoff
        # ladder instead of restarting at base
        self._quarantine_hist: dict[str, tuple] = {}
        self.quarantine_base_s = float(os.environ.get(
            "GATEKEEPER_TPU_QUARANTINE_BASE_S", "30"))
        self.quarantine_max_s = float(os.environ.get(
            "GATEKEEPER_TPU_QUARANTINE_MAX_S", "600"))
        # optional observer (kind, reason or None), called off the
        # serving thread on every quarantine and recovery
        self.on_quarantine: Optional[Any] = None

    # ------------------------------------------------------------- modules

    def _forget(self, kind: str) -> None:
        for cache in (self._compiled, self._programs, self._modules,
                      self._derived_cols, self._param_cache,
                      self._feat_cache, self._msg_plans, self._fallback,
                      self._join_progs, self._join_compiled,
                      self._join_frz[2],  # template update: stale keys
                      self._data_taint):
            cache.pop(kind, None)
        self._drop_audit_results(kind)
        self._drop_warm(kind)  # new CompiledTemplate = cold kernel caches

    def _drop_audit_results(self, kind: str) -> None:
        for key in [k for k in self._audit_results_cache if k[1] == kind]:
            del self._audit_results_cache[key]

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
            # cross-object templates: try the inventory-join compiler
            from .join import compile_join
            try:
                self._join_progs[kind] = compile_join(module, kind)
            except Uncompilable as je:
                self._note_fallback(kind, dense=(de.code, de.detail),
                                    join=(je.code, je.detail),
                                    reads_data=_module_reads_data(module))
        # off-path work starts at INGESTION: build the device evaluator
        # now (cheap host work on the ingesting thread — the intern table
        # is not thread-safe, so resolve_consts must not run from a
        # background thread) and load any stored K2 variants for it in
        # the background, so the first sweep at a remembered shape
        # launches with no compile on its path
        self._enqueue_prewarm(kind)

    def delete_modules(self, prefix: str) -> int:
        n = super().delete_modules(prefix)
        m = _PREFIX_RE.match(prefix)
        if m:
            self._forget(m.group(2))
        return n

    def _drop_warm(self, kind: str) -> None:
        """Template update/delete: a fresh CompiledTemplate starts with
        an empty kernel cache, so its sweep shapes are NOT warm even when
        the tensor shapes match a previous generation's signature."""
        with self._warm_lock:
            self._warm_done = {s for s in self._warm_done
                               if self._sig_kind(s) != kind}
            self._warm_restored = {s for s in self._warm_restored
                                   if self._sig_kind(s) != kind}
            self._warm_fail = {s: c for s, c in self._warm_fail.items()
                               if self._sig_kind(s) != kind}

    @staticmethod
    def _sig_kind(sig: tuple):
        """The kind a sweep signature belongs to (dense-batch sigs are
        prefixed with "dense"; see _sweep_sig)."""
        return sig[1] if sig and sig[0] == "dense" else sig[0]

    def _enqueue_prewarm(self, kind: str) -> None:
        """Ingest-time off-path work: build the device evaluator for
        `kind` inline (host-only work — program compile, const
        resolution), then load its stored K2 variants and mark the
        store's remembered sweep signatures warm on a background thread.
        After this, a warm boot's first sweep at a remembered shape
        launches straight on the device — no compile, no host-fallback
        round."""
        if not self.async_warm:
            return  # deterministic-dispatch mode (tests) stays lazy
        try:
            ct = self.compiled_for(kind)
            jc = self.join_for(kind) if ct is None else None
        except Exception:  # the lazy path will surface/demote properly
            return
        if (ct is None and jc is None) or not self.aot.enabled:
            return

        def run():
            try:
                if ct is not None:
                    loaded = ct.preload_aot()
                    n = sum(loaded.values())
                    if n:
                        self._mark_stored_sigs_warm(ct.fingerprint,
                                                    loaded)
                        log.info(
                            "%d stored K2 variants for %s loaded at "
                            "ingestion (warm sweep shapes launch with no "
                            "compile)", n, kind)
                elif jc is not None:
                    jc.preload_aot()
            except Exception as e:  # prewarm is best-effort
                log.warning("AOT prewarm for %s failed: %s: %s", kind,
                            type(e).__name__, e)

        threading.Thread(target=run, daemon=True,
                         name=f"aot-prewarm-{kind}").start()

    def prewarm_templates(self, kinds) -> int:
        """Re-run the ingest-time prewarm for the given template kinds
        (the control plane's churn-triggered actuation: after a burst of
        library ops settles, every known kind's stored variants load in
        the background so the first post-churn evaluation launches
        warm). Best-effort and cheap to repeat — kinds already warm
        re-adopt idempotently. Returns how many kinds were enqueued."""
        n = 0
        for kind in kinds:
            self._enqueue_prewarm(kind)
            n += 1
        return n

    def _mark_stored_sigs_warm(self, fingerprint: str,
                               loaded: dict) -> None:
        """Adopt the store's remembered sweep signatures as warm (the
        reference adopts a mesh signature only when mesh programs
        loaded; the port has no mesh, so every signature is adopted)."""
        sigs = self.aot.sigs_for(fingerprint)
        with self._warm_lock:
            for sig in sigs:
                self._warm_done.add(sig)
                # adoption is optimistic: the sig's exact variant may not
                # have been stored (store evicted, a save failed), so its
                # first dispatch runs no-inline-compile guarded and
                # un-adopts on a miss rather than compiling inline
                self._warm_restored.add(sig)

    def compiled_for(self, kind: str) -> Optional[CompiledTemplate]:
        """Lazily wrap the Program in a device evaluator, registering its
        derived columns (host-interpreted unary fns) and interpreted
        predicate ops with the shared tables. A quarantined kind answers
        None (interpreter fallback) until its breaker half-opens. Only a
        kind with a Program asks the breaker here: a join kind's probe
        lease is join_for's to take (callers ask compiled_for first)."""
        if self._quarantine and kind in self._programs and \
                self._quarantined(kind):
            return None
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
                                  aot=self.aot, kind=kind)
            self._derived_cols[kind] = cols
        except Exception as e:
            self._demote(kind, "lowering", e)
            ct = None
        self._compiled[kind] = ct
        return ct

    def join_for(self, kind: str):
        """Lazily wrap a JoinProgram in its runtime evaluator (None for a
        kind that is not a join). A quarantined kind answers None
        (interpreter fallback) until its breaker half-opens, as in
        compiled_for."""
        if self._quarantine and self._quarantined(kind):
            return None
        if kind in self._join_compiled:
            return self._join_compiled[kind]
        prog = self._join_progs.get(kind)
        jc = None
        if prog is not None:
            from .join import JoinCompiled
            jc = JoinCompiled(prog, self.strtab, self.device, kind=kind)
        self._join_compiled[kind] = jc
        return jc

    # ------------------------------------------------------ audit sharding

    def set_audit_shard(self, shard_id: Optional[int],
                        shard_count: int = 1, vnodes: int = 64) -> None:
        """Scope this driver's audit review set to one consistent-hash
        slice of the inventory (control/shardmap.py). shard_id=None or
        shard_count<=1 clears the filter. The data TREE is not filtered
        here — the sharded plane feeds each shard its owned objects
        plus the join/namespace broadcast set, and review building is
        what decides which objects this shard actually sweeps."""
        if shard_id is None or shard_count <= 1:
            self._audit_shard = None
            self.set_audit_review_filter(None)
            return
        from ..control.shardmap import ShardMap

        smap = ShardMap(shard_count, vnodes)
        sid = int(shard_id)
        self._audit_shard = (sid, int(shard_count))

        def owns(gv: str, kind: str, namespace: str) -> bool:
            group, _, version = gv.rpartition("/")
            return smap.owner((group, version, kind), namespace) == sid

        self.set_audit_review_filter(owns)

    def audit_broadcast_spec(self) -> dict:
        """What the leader must replicate to EVERY shard for non-owned
        objects, derived from the loaded templates:

          {"full": bool,             # give up: broadcast all, whole
           "kinds": {kind: columns}} # kind "*" = any kind; columns:
                                     # list of path tuples, or None =
                                     # whole object

        Join templates (ir/join.py) reach other objects only through
        data.inventory generator bindings (`other := data.inventory.
        namespace[ns][apiv][kind][name]`) and then read a handful of
        columns off the bound object — directly (`other.spec.selector`)
        or through helper functions (`selector_key(other)`). Tracing
        those reads (including one level of helper-param dataflow)
        yields exactly the columns a foreign shard's copy must carry —
        the sik join-key inputs — so 10M-object broadcasts ship pruned
        skeletons, not manifests. Anything the walk cannot prove
        degrades conservatively (whole object, or full-inventory
        broadcast for interpreted data-reading templates): sharding
        must never change a verdict. Namespace objects are always
        broadcast whole — namespaceSelector matching reads their
        labels on every shard."""
        from .join import _split_inv_ref as _join_split

        spec: dict = {"full": False, "kinds": {"Namespace": None}}

        def add_kind(kind: str, columns) -> None:
            cur = spec["kinds"].get(kind)
            if kind not in spec["kinds"]:
                cur = []
                spec["kinds"][kind] = cur
            if columns is None or cur is None:
                spec["kinds"][kind] = None
                return
            for c in columns:
                if c not in cur:
                    cur.append(c)

        for prog in self._join_progs.values():
            if prog is None:
                continue
            rules_by_name: dict[str, list] = {}
            for r in prog.module.rules:
                rules_by_name.setdefault(r.name, []).append(r)
            memo: dict = {}

            def var_columns(rule, vname: str, stack):
                """Column paths `rule` reads off the object bound to
                `vname`; None when the object escapes the analysis
                (used bare, aliased, or fed to an unknown function)."""
                cols: list = []
                whole = [False]

                def walk(t) -> None:
                    if isinstance(t, A.Ref) and \
                            isinstance(t.base, A.Var) and \
                            t.base.name == vname:
                        prefix = []
                        for a in t.args:
                            if isinstance(a, A.Scalar) and \
                                    isinstance(a.value, str):
                                prefix.append(a.value)
                            else:
                                break
                        if prefix:
                            cols.append(tuple(prefix))
                        else:
                            whole[0] = True
                        for a in t.args:
                            walk(a)
                        return
                    if isinstance(t, A.Call):
                        for i, a in enumerate(t.args):
                            if isinstance(a, A.Var) and a.name == vname:
                                c = param_columns(t.fn, i, stack)
                                if c is None:
                                    whole[0] = True
                                else:
                                    cols.extend(c)
                            else:
                                walk(a)
                        return
                    if isinstance(t, A.Var):
                        if t.name == vname:
                            whole[0] = True
                        return
                    if isinstance(t, (list, tuple)):
                        for x in t:
                            walk(x)
                    elif hasattr(t, "__dataclass_fields__"):
                        for f in t.__dataclass_fields__:
                            walk(getattr(t, f))

                walk(rule.key)
                walk(rule.value)
                for lit in rule.body or ():
                    e = lit.expr
                    if isinstance(e, (A.Assign, A.Unify)):
                        # skip the generator binding itself; flag any
                        # OTHER alias of the object as an escape
                        sides = (e.lhs, e.rhs)
                        if any(isinstance(s, A.Var) and s.name == vname
                               for s in sides):
                            if any(_inv_gen_of(s) for s in sides):
                                continue
                            whole[0] = True
                            continue
                    walk(lit)
                return None if whole[0] else cols

            def param_columns(fn, idx: int, stack):
                """Columns function `fn` reads off positional param
                `idx`, across all its clauses; None = escapes."""
                if len(fn) != 1 or fn[0] not in rules_by_name:
                    return None
                key = (fn[0], idx)
                if key in memo:
                    return memo[key]
                if key in stack:
                    return []  # recursive clause adds nothing new
                cols: list = []
                for r in rules_by_name[fn[0]]:
                    if not r.args or idx >= len(r.args) or \
                            not isinstance(r.args[idx], A.Var):
                        memo[key] = None
                        return None
                    c = var_columns(r, r.args[idx].name, stack + (key,))
                    if c is None:
                        memo[key] = None
                        return None
                    cols.extend(c)
                memo[key] = cols
                return cols

            def _inv_gen_of(t):
                """(kind-or-*, ok) when t is an inventory object ref
                addressing exactly one object; None otherwise."""
                if not (isinstance(t, A.Ref) and isinstance(t.base, A.Var)
                        and t.base.name == "data" and t.args
                        and isinstance(t.args[0], A.Scalar)
                        and t.args[0].value == "inventory"):
                    return None
                split = _join_split(t)
                if split is None or split[1]:
                    return ("*", False)  # odd shape: give up later
                scope = t.args[1].value
                kind_arg = t.args[4 if scope == "namespace" else 3]
                if isinstance(kind_arg, A.Scalar) and \
                        isinstance(kind_arg.value, str):
                    return (kind_arg.value, True)
                return ("*", True)

            bound_refs: set = set()
            for rule in prog.module.rules:
                for lit in rule.body or ():
                    e = lit.expr
                    if not isinstance(e, (A.Assign, A.Unify)):
                        continue
                    for var_side, ref_side in ((e.lhs, e.rhs),
                                               (e.rhs, e.lhs)):
                        gen = _inv_gen_of(ref_side)
                        if gen is None or not isinstance(var_side,
                                                         A.Var):
                            continue
                        bound_refs.add(id(ref_side))
                        kind, ok = gen
                        if not ok:
                            spec["full"] = True
                            continue
                        add_kind(kind, var_columns(rule, var_side.name,
                                                   ()))
            # any inventory ref NOT consumed as a generator binding
            # (inline residual reads, negated absence checks, odd
            # shapes) is handled from its own split — or gives up

            def sweep(t) -> None:
                if isinstance(t, A.Ref) and isinstance(t.base, A.Var) \
                        and t.base.name == "data" and t.args \
                        and isinstance(t.args[0], A.Scalar) \
                        and t.args[0].value == "inventory":
                    if id(t) not in bound_refs:
                        split = _join_split(t)
                        kind = None
                        if split is not None:
                            scope = t.args[1].value
                            ka = t.args[4 if scope == "namespace"
                                        else 3]
                            kind = ka.value \
                                if isinstance(ka, A.Scalar) and \
                                isinstance(ka.value, str) else "*"
                        if split is None:
                            spec["full"] = True
                        else:
                            prefix = []
                            for a in split[1]:
                                if isinstance(a, A.Scalar) and \
                                        isinstance(a.value, str):
                                    prefix.append(a.value)
                                else:
                                    break
                            add_kind(kind,
                                     [tuple(prefix)] if prefix
                                     else None)
                if isinstance(t, (list, tuple)):
                    for x in t:
                        sweep(x)
                elif hasattr(t, "__dataclass_fields__"):
                    for f in t.__dataclass_fields__:
                        sweep(getattr(t, f))

            sweep(prog.module.rules)
        # interpreted (non-join) templates that read `data` see the raw
        # tree — a shard's partial tree would change their answers
        for kind in self._modules:
            if kind not in self._join_progs and \
                    self._template_reads_data(kind):
                spec["full"] = True
        return spec

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
        try:
            from ..control.metrics import report_compile_fallback

            report_compile_fallback(kind, reason)
        except Exception:  # metrics backend optional in embedders
            pass

    def fallback_reasons(self) -> dict:
        """kind -> {"reason", "dense": {code, detail}, "join": {...}}
        for every interpreter-bound kind."""
        return {k: dict(v) for k, v in self._fallback.items()}

    def _demote(self, kind: str, reason: str, exc: Exception) -> None:
        """A device->interpreter demotion must never be silent (each one
        is logged and counted)."""
        from ..control.metrics import report_device_demotion

        log.warning("template %s demoted to interpreter path (%s): %s: %s",
                    kind, reason, type(exc).__name__, exc)
        report_device_demotion(kind, reason)

    # -------------------------------------------------- eval quarantine

    def _quarantine_kind(self, kind: str, reason: str,
                         exc: Exception) -> None:
        """Bench one kind's device program after an eval failure: the
        quarantine (NOT a permanent demotion) has exponential backoff
        with a cap, so one bad template degrades that template's latency
        — never the process's availability — and the device path heals
        itself when the failure was transient."""
        why = f"{reason}: {type(exc).__name__}: {exc}"
        with self._quarantine_lock:
            ent = self._quarantine.get(kind)
            if ent is None:
                hist = self._quarantine_hist.pop(kind, None)
                base_fails = 0
                if hist is not None and \
                        time.monotonic() - hist[1] < self.quarantine_max_s:
                    base_fails = hist[0]  # resume the backoff ladder
                ent = {"fails": base_fails}
            ent["fails"] += 1
            backoff = min(self.quarantine_base_s
                          * (2 ** (ent["fails"] - 1)),
                          self.quarantine_max_s)
            ent["until"] = time.monotonic() + backoff
            ent["reason"] = why
            ent["probe_at"] = None
            self._quarantine[kind] = ent
            fails = ent["fails"]
        # forget the wrapper (compiled_for re-wraps from the kept
        # Program after the quarantine lifts) and its warm state
        self._compiled.pop(kind, None)
        self._drop_warm(kind)
        self._demote(kind, reason, exc)
        from ..control.metrics import report_template_quarantine

        report_template_quarantine(kind, True)
        log.warning("template %s quarantined %.0fs (failure #%d); its "
                    "reviews serve from the interpreter until a probe "
                    "sweep succeeds", kind, backoff, fails)
        self._notify_quarantine(kind, why)

    def _quarantined(self, kind: str) -> bool:
        """True while the kind's device program is benched. After the
        backoff expires the state is HALF-OPEN: ONE caller at a time
        takes the probe lease and attempts the device path — success
        clears, failure re-quarantines with a doubled backoff — while
        every other caller stays on the interpreter."""
        with self._quarantine_lock:
            ent = self._quarantine.get(kind)
            if ent is None:
                return False
            now = time.monotonic()
            if now < ent["until"]:
                return True
            probe_at = ent.get("probe_at")
            if probe_at is not None and \
                    now - probe_at < self.QUARANTINE_PROBE_LEASE_S:
                # a probe is in flight; stay on the interpreter
                return True
            ent["probe_at"] = now
            return False

    def _quarantine_clear(self, kind: str) -> None:
        """A device eval of this kind succeeded: close the breaker — but
        ONLY for a sanctioned half-open probe (probe_at set). An eval
        that was already in flight when another thread quarantined the
        kind must not wipe the fresh entry."""
        with self._quarantine_lock:
            ent = self._quarantine.get(kind)
            if ent is None or ent.get("probe_at") is None:
                return
            del self._quarantine[kind]
            self._quarantine_hist[kind] = (ent["fails"], time.monotonic())
        from ..control.metrics import report_template_quarantine

        report_template_quarantine(kind, False)
        log.info("template %s recovered: device path restored after "
                 "quarantine (%d failures)", kind, ent["fails"])
        self._notify_quarantine(kind, None)

    def _notify_quarantine(self, kind: str, reason) -> None:
        """Run the on_quarantine observer OFF the serving thread: a
        quarantine raised mid-batch must never make co-batched verdicts
        wait on the observer's I/O."""
        cb = self.on_quarantine
        if cb is None:
            return

        def run():
            try:
                cb(kind, reason)
            except Exception as e:
                # observability loss, not correctness: say so instead
                # of silently dropping the status update
                log.warning("quarantine status notification for %s "
                            "failed: %s: %s", kind, type(e).__name__, e)

        threading.Thread(target=run, daemon=True,
                         name=f"quarantine-note-{kind}").start()

    def quarantine_status(self) -> dict:
        """Currently-benched kinds with reason, failure count, and
        remaining backoff."""
        now = time.monotonic()
        with self._quarantine_lock:
            return {k: {"reason": e.get("reason"),
                        "fails": e.get("fails", 0),
                        "remaining_s": max(0.0, e.get("until", now) - now)}
                    for k, e in self._quarantine.items()}

    def compiled_kinds(self) -> list[str]:
        return sorted(set(self._programs) | set(self._join_progs))

    def note_eval(self, kind: str, path: str,
                  seconds: Optional[float] = None) -> None:
        """Count one evaluation of `kind` via `path` (device / delta /
        interp / join): the per-template eval breakdown /debug/templates
        reports. `seconds` (eval wall clock, when the call site timed
        it) accumulates into the engine's busy fraction."""
        with self._eval_counts_lock:
            self._eval_counts[(kind, path)] = \
                self._eval_counts.get((kind, path), 0) + 1
        if seconds:
            self.note_busy(seconds)

    def eval_counts(self) -> dict:
        """(kind, path) -> evaluations served, since construction."""
        with self._eval_counts_lock:
            return dict(self._eval_counts)

    def note_busy(self, seconds: float) -> None:
        """Accumulate eval wall clock toward the duty-cycle sample."""
        if seconds <= 0:
            return
        with self._eval_counts_lock:
            self._busy_s += seconds

    def duty_cycle(self, ema_alpha: float = 0.3,
                   min_window_s: float = 0.05) -> float:
        """Busy-fraction EMA of this engine's evaluator, sampled per
        call (the metrics scrape probe): busy eval seconds since the
        last sample over elapsed wall clock, EMA-smoothed so one idle
        scrape interval doesn't zero a busy engine's reading. Concurrent
        evals can push a raw window past 1.0; the fraction clamps,
        because the gauge answers "is the engine busy"."""
        now = time.monotonic()
        with self._eval_counts_lock:
            elapsed = now - self._busy_t0
            if elapsed < min_window_s:
                return self._duty_ema  # scrape storm: keep the sample
            raw = min(1.0, self._busy_s / elapsed) if elapsed > 0 else 0.0
            self._busy_s = 0.0
            self._busy_t0 = now
            if not self._duty_sampled:
                # the first sample seeds the EMA instead of decaying a
                # meaningless zero
                self._duty_ema = raw
                self._duty_sampled = True
            else:
                self._duty_ema = (ema_alpha * raw
                                  + (1.0 - ema_alpha) * self._duty_ema)
            return self._duty_ema

    def templates_debug(self) -> dict:
        """Per-template compile/serve state for /debug/templates: how
        each kind evaluates right now (device program, join program, or
        interpreter), its quarantine state, eval counts by path, its
        recent K2 acquisitions, and where K2's source is rendered."""
        quarantined = self.quarantine_status()
        with self._eval_counts_lock:
            counts = dict(self._eval_counts)
        out = {}
        # the program maps mutate from compile/eval threads (lazy
        # compiled_for inserts, background warms) with no shared lock;
        # snapshotting can race a resize mid-iteration, so retry the
        # cheap copy instead of failing the endpoint
        for _attempt in range(5):
            try:
                programs = set(self._programs)
                joins = set(self._join_progs)
                kinds = (set(self._compiled) | programs | joins
                         | {k for (k, _p) in counts})
                break
            except RuntimeError:
                continue
        else:
            programs = joins = set()
            kinds = {k for (k, _p) in counts}
        for kind in sorted(kinds):
            if kind in programs:
                state = "compiled"
            elif kind in joins:
                state = "join"
            else:
                state = "interpreter"
            evals = {p: n for (k, p), n in sorted(counts.items())
                     if k == kind}
            out[kind] = {
                "state": state,
                # why an interpreter-bound kind didn't compile (None for
                # device-compiled kinds)
                "fallback": self._fallback.get(kind),
                "quarantine": quarantined.get(kind),
                "eval_counts": evals,
                # recent K2 acquisitions: source (aot / cache / fresh),
                # seconds and the sweep-shape key
                "compile": self.aot.events_for(kind),
                "hlo_dump": ("gatekeeper_tpu_torch.utils.profiling."
                             "compiled_hlo(driver.compiled_for("
                             f"{kind!r}), ...) renders K2's Triton source "
                             "(stage='optimized': its PTX)"),
            }
        # one card: no mesh (the JAX package's audit mesh is ROADMAP A8)
        return {"templates": out, "warm": self.warm_status(),
                "mesh": None}

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
        self._join_frz = (None, {}, {})
        self._audit_results_cache.clear()
        self._review_idx_cache = (None, None, None)
        self._witcols.clear()

    # --------------------------------------------- warm-restart snapshots

    def vocab_snapshot(self) -> dict:
        """The intern table, for the durable state snapshot. Restoring
        it on boot keeps string ids identical across restarts, so the
        persisted encoded rows stay valid."""
        return {"strings": self.strtab.dump()}

    def vocab_restore(self, snap: dict) -> None:
        """Replay a vocab snapshot onto this driver's FRESH strtab
        (boot-time only; StringTable.restore refuses otherwise)."""
        self.strtab.restore(snap.get("strings") or [])

    def encoded_rows_snapshot(self) -> Optional[dict]:
        """Per-kind encoded feature arrays whose cache provably matches
        the current data tree (meta rev == data rev: no unapplied
        journal entries). Restored rows let the first warm audit skip
        re-extraction entirely. None when nothing is current."""
        out = {}
        for kind, fcache in self._feat_cache.items():
            meta = fcache.get("__meta__")
            if meta is None or meta.get("cand") is None:
                continue
            if meta.get("rev") != self._data_rev:
                continue  # stale vs the tree; next audit refreshes it
            out[kind] = {"feats": meta["feats"], "cand": meta["cand"],
                         "buckets": meta["buckets"],
                         "n_pad": meta["n_pad"]}
        return out or None

    def mark_rows_restore_base(self) -> None:
        """Pin the no-writes-since-restore generation NOW (called
        synchronously right after inventory_restore, BEFORE the rows
        blob loads on a background thread): a delta applied while the
        blob is still loading must invalidate the stashed rows, so the
        guard generation cannot be captured at load-completion time."""
        self._restored_rows_base = self._data_gen

    def encoded_rows_restore(self, rows: dict) -> None:
        """Stash snapshotted feature arrays for lazy adoption: the
        first audit adopts a kind's rows iff its freshly-computed
        candidate set matches the snapshot AND no inventory write
        happened since the restore BASE (mark_rows_restore_base, or
        now for synchronous callers — any delta means the rows may be
        stale; extraction rebuilds them, the safe cold path). Requires
        the vocab snapshot to have been restored first: the arrays
        hold interned string ids."""
        self._restored_rows = dict(rows or {})
        base = self._restored_rows_base
        self._restored_rows_gen = \
            base if base is not None else self._data_gen
        self.restored_rows_adopted = 0

    def _adopt_restored_rows(self, kind: str, cand, feat_key,
                             fcache: dict):
        stash_all = self._restored_rows
        if not stash_all or cand is None:
            return None
        if self._data_gen != self._restored_rows_gen:
            # inventory changed since restore: every stashed kind is
            # suspect — drop the lot and let extraction rebuild
            self._restored_rows = {}
            return None
        stash = stash_all.pop(kind, None)
        if stash is None:
            return None
        try:
            if not np.array_equal(np.asarray(stash["cand"]),
                                  np.asarray(cand)):
                return None  # constraints/inventory drifted: re-extract
            feats = stash["feats"]
        except (KeyError, TypeError):  # a malformed snapshot: re-extract
            return None
        fcache.clear()
        fcache["__meta__"] = {
            "key": feat_key, "feats": feats,
            "cand": np.asarray(cand), "buckets": stash["buckets"],
            "n_pad": stash["n_pad"], "rev": self._data_rev,
        }
        self.restored_rows_adopted += 1
        return feats

    def _bump(self, path: tuple) -> None:
        if path and path[0] == "constraints":
            self._constraint_gen += 1
            self._param_cache.clear()
        else:
            self._data_gen += 1
            # feature/device caches survive: single-object replacements
            # replay through the patch journal (_notes_between) against
            # the cached arrays; uncovered ranges rebuild lazily on the
            # next audit. Device copies of superseded host arrays
            # self-evict via their weakrefs.

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
        # one latency sample per audit, from the FIRST consumed kind:
        # later kinds' dispatch->consume gaps include earlier kinds' host
        # materialization, which would overstate device latency
        self._lat_sampled = False
        self.last_audit_lat_s = None
        self._cold_host_begin()
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
        delta_served: set = set()
        # host seconds the loop below spends on each kind: a kind's
        # latency sample leaves out the host work done for the kinds after
        # it (masks, feature encodes, host-served kinds), which its device
        # path did not cause
        host_s = 0.0
        # per-kind completion observer (the streaming status writer):
        # fired as soon as a kind's results exist, so constraint-status
        # publishing overlaps the remaining kinds' device sweeps
        cb = self.on_kind_results if trace is None else None

        def emit(k: str) -> None:
            if cb is None:
                return
            try:
                cb(target, k, by_res.get(k, []))
            except Exception as e:  # observer only; never fail the sweep
                log.warning("audit kind-results observer failed for %s: "
                            "%s: %s", k, type(e).__name__, e)

        for kind in sorted(by_kind):
            t0 = time.monotonic()
            cons = by_kind[kind]
            ct = self.compiled_for(kind)
            served = None
            if ct is not None and trace is None and \
                    not self._template_reads_data(kind):
                with profiling.timers().phase("delta_serve"):
                    served = self._audit_delta_serve(target, kind, cons,
                                                     reviews, lookup_ns,
                                                     sig_cache, inventory)
            if served is not None:
                by_res[kind] = served
                delta_served.add(kind)
                self.note_eval(kind, "delta")
            elif ct is not None and trace is None:
                st = self._audit_dispatch(target, kind, ct, cons, reviews,
                                          lookup_ns, sig_cache)
                if st is not None:
                    t1 = time.monotonic()
                    pending.append((kind, st, t1, host_s + t1 - t0,
                                    kernel_build.thread_stamp()))
                else:
                    t1 = time.monotonic()
                    by_res[kind] = self._audit_interp(
                        target, kind, cons, reviews, lookup_ns, inventory,
                        trace, sig_cache)
                    self._cold_host_done(time.monotonic() - t1)
            elif ct is not None:
                by_res[kind] = self._audit_compiled(target, kind, ct, cons,
                                                    reviews, lookup_ns,
                                                    inventory, trace,
                                                    sig_cache)
            elif (jc := self.join_for(kind)) is not None:
                by_res[kind] = self._audit_join(target, kind, jc, cons,
                                                reviews, lookup_ns,
                                                inventory, trace, sig_cache)
            else:
                by_res[kind] = self._audit_interp(target, kind, cons,
                                                  reviews, lookup_ns,
                                                  inventory, trace,
                                                  sig_cache)
            host_s += time.monotonic() - t0
            if kind in by_res:  # a dispatched kind emits when consumed
                emit(kind)
        for kind, st, t1, at_s, stamp in pending:
            by_res[kind] = self._audit_consume(
                target, kind, st, by_kind[kind], reviews, lookup_ns,
                inventory, sig_cache, (t1, t1 + host_s - at_s, stamp))
            emit(kind)
        if trace is None:
            for kind in sorted(by_kind):
                # seed/refresh the delta cache from this full sweep, for
                # the kinds that stayed compiled and are review-pure
                if kind not in delta_served and \
                        self._compiled.get(kind) is not None and \
                        not self._template_reads_data(kind):
                    self._audit_delta_store(target, kind,
                                            by_res.get(kind, []), reviews)
        results: list[Result] = []
        for kind in sorted(by_kind):
            results.extend(by_res.get(kind, []))
        self.last_audit_path = (
            f"delta({len(delta_served)}/{len(by_kind)})" if delta_served
            else f"single({self.device.type})")
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

    # ------------------------------------------------ async device warm

    def _sweep_sig(self, ct, kind, feats, enc, table, derived, n_true,
                   dense: bool = False) -> tuple:
        """Signature of the K2 variants one sweep launches
        (CompiledTemplate.sweep_key, which owns the slab and row rules):
        a sweep shape is "warm" once a sweep with this signature ran, so
        that Triton's in-memory cache holds every variant the next one
        launches. The audit's slab sweep and the sparse batch's take
        `_sweep_slab`; the dense batch path (`dense`) sweeps every row at
        once, and its sigs are prefixed with "dense"."""
        slab = None if dense else self._sweep_slab(n_true, self.sweep_chunk)
        sig = (kind, ct.sweep_key(feats, enc, table, derived, slab=slab,
                                  n_true=n_true))
        return ("dense",) + sig if dense else sig

    def _unadopt(self, sig) -> None:
        """A warm-boot-adopted sweep signature turned out not to be
        backed by a stored variant: forget the adoption so the normal
        cold-sig machinery (background warm + host fallback, or
        block-when-cheaper) takes over."""
        with self._warm_lock:
            self._warm_done.discard(sig)
            self._warm_restored.discard(sig)

    def _dispatch_guarded(self, sig, ct, feats, enc, table, derived,
                          n_true, n_cons):
        """_dispatch_handle, but when `sig` was adopted from the program
        store (never run in THIS process) the dispatch runs under the
        no-inline-compile guard: a store miss returns None (the caller
        re-gates the sig as cold) instead of stalling the serving thread
        on a Triton compile. Parameter-only programs defer their launch
        to consume time, outside the guard — one row of verdicts."""
        with self._warm_lock:
            restored = sig in self._warm_restored
        if not restored:
            return self._dispatch_handle(ct, feats, enc, table, derived,
                                         n_true, n_cons=n_cons)
        try:
            with aot_mod.no_inline_compile():
                h = self._dispatch_handle(ct, feats, enc, table, derived,
                                          n_true, n_cons=n_cons)
        except aot_mod.WouldCompile:
            log.info("adopted sweep signature for %s not backed by a "
                     "stored variant after all; re-warming it off the "
                     "serving path", self._sig_kind(sig))
            self._unadopt(sig)
            return None
        with self._warm_lock:
            self._warm_restored.discard(sig)
        return h

    def _spawn_warm(self, sig, kind, run_fn, fingerprint=None, what=""):
        """Run one cold device program (`run_fn`: a full sweep or batch
        evaluation thunk) on a background thread, so that its kernels
        compile off the serving path; results are discarded (the
        foreground already answered from the host path this round). On
        success the sweep signature is persisted to the program store, so
        a future warm boot marks this shape warm BEFORE its first sweep.
        Returns the completion Event (callers whose host alternative is
        worse than the compile may wait on it).

        The thunk holds only the device tensors its caller prepared, and
        the kernels it reaches (K2 through the template's kernel cache,
        K1) keep their shared state under locks (kernels/build.py,
        clause_triton); it touches none of the driver's caches. It runs
        on the current (default) stream, so its kernels and the serving
        thread's run in stream order."""
        with self._warm_lock:
            ev = self._warm_inflight.get(sig)
            if ev is not None or sig in self._warm_done:
                return ev
            ev = threading.Event()
            self._warm_inflight[sig] = ev

        def run():
            t0 = time.monotonic()
            try:
                with self._warm_sem:
                    run_fn()
                with self._warm_lock:
                    self._warm_done.add(sig)
                if fingerprint:
                    self.aot.record_sig(fingerprint, sig)
                log.info("device program for %s warm after %.1fs (%s); "
                         "the next sweep hot-swaps off the host path",
                         kind, time.monotonic() - t0, what or "sweep")
            except Exception as e:
                # do NOT demote from here: the warm sweep runs beside
                # foreground device work, so a transient resource failure
                # may be contention the serving path would never see.
                # Retry once; after that, mark warm so the FOREGROUND
                # dispatch surfaces the real error through its own
                # quarantine path
                with self._warm_lock:
                    n_fail = self._warm_fail.get(sig, 0) + 1
                    self._warm_fail[sig] = n_fail
                    if n_fail >= 2:
                        self._warm_done.add(sig)
                log.warning(
                    "background warm sweep for %s failed (attempt %d)%s: "
                    "%s: %s", kind, n_fail,
                    "; next sweep dispatches in the foreground"
                    if n_fail >= 2 else "; will retry",
                    type(e).__name__, e)
            finally:
                with self._warm_lock:
                    self._warm_inflight.pop(sig, None)
                ev.set()

        threading.Thread(target=run, daemon=True,
                         name=f"warm-{kind}").start()
        return ev

    def warm_status(self) -> dict:
        """How many device programs are warm and how many are compiling
        in the background, plus the program store's acquisition stats
        (aot/cache/fresh counts and seconds)."""
        with self._warm_lock:
            out = {"warm": len(self._warm_done),
                   "compiling": len(self._warm_inflight)}
        out["aot"] = self.aot.stats_snapshot()
        return out

    def _cold_host_begin(self) -> None:
        """An audit or review batch starts: its cold kinds' host budget
        is empty."""
        self._cold.spent = 0.0
        self._cold.pending = False

    def _cold_host_done(self, seconds: float) -> None:
        """The host path just served a kind: when _warm_gate sent it
        there, its seconds count against the call's budget."""
        if getattr(self._cold, "pending", False):
            self._cold.pending = False
            self._cold.spent += seconds

    def _warm_gate(self, sig, kind, run_fn, n_masked_pairs,
                   fingerprint=None, what="") -> bool:
        """Shared block-when-cheaper policy for a cold sweep shape: kick
        the background warm and return False (serve host) when the host
        alternative is tolerable, else wait the compile out and return
        whether the program is now warm. True = dispatch on the device.

        Tolerable is per call, not per kind: the host seconds this
        audit's or batch's cold kinds have taken so far (measured), plus
        this kind's estimate, stay within ASYNC_WARM_MAX_HOST_S. A kind
        alone rarely passes it (config 6's take about 7 s each on the
        host), but sixteen of them served in a row cost minutes that the
        compiles, about 2 s a kind, would not."""
        with self._warm_lock:
            if sig in self._warm_done:
                return True
        ev = self._spawn_warm(sig, kind, run_fn, fingerprint=fingerprint,
                              what=what)
        spent = getattr(self._cold, "spent", 0.0)
        if spent + n_masked_pairs / self._host_pair_rate <= \
                self.ASYNC_WARM_MAX_HOST_S:
            self._cold.pending = True
            return False
        if ev is not None:
            ev.wait(timeout=600)
        with self._warm_lock:
            return sig in self._warm_done

    def _audit_dispatch(self, target, kind, ct, cons, reviews, lookup_ns,
                        sig_cache):
        """Phase 1 for one compiled kind: mask, feature prep, and the
        enqueue of every slab's kernels. A sweep shape that has never run
        serves from the host path while a background thread warms it
        (_warm_gate). Returns the consume state, or None for the host
        path; an exception quarantines the kind (host path)."""
        try:
            faults.fire("eval.device", kind=kind)
            mask = self._match_mask(target, kind, cons, reviews, lookup_ns,
                                    sig_cache)
            cand = np.flatnonzero(mask.any(axis=1))
            if cand.size == 0:
                return ("empty",)
            # the webhook's cost model: a small audit's masked pairs clear
            # the host path faster than one device round trip; None keeps
            # the kind on the host for this audit WITHOUT demoting it
            if not self._use_device_for_batch(int(mask.sum())):
                return None
            cand_reviews = [reviews[int(i)] for i in cand]
            feat_key = (self._data_gen, hash(cand.tobytes()))
            with profiling.timers().phase("encode"):
                feats, enc, table, derived = self._prepare_eval(
                    ct, kind, cand_reviews, cons, feat_key, cand=cand,
                    target=target)
            n_cons = len(cons)
            sig = self._sweep_sig(ct, kind, feats, enc, table, derived,
                                  len(cand_reviews))

            def warm_run():
                h = self._dispatch_handle(ct, feats, enc, table, derived,
                                          len(cand_reviews), n_cons=n_cons)
                for _ in h.pairs():
                    pass
            if self.async_warm:
                # host fallback only when it is actually cheaper than
                # waiting out the compile: at audit scale (e.g. 50M masked
                # pairs) minutes of interpretation would be far worse than
                # blocking on the compile once
                if not self._warm_gate(sig, kind, warm_run,
                                       int(mask.sum()),
                                       fingerprint=ct.fingerprint,
                                       what="sweep"):
                    return None  # host path serves this audit
            handle = self._dispatch_guarded(sig, ct, feats, enc, table,
                                            derived, len(cand_reviews),
                                            n_cons)
            if handle is None:
                # the adopted signature didn't hold: re-gate it as cold
                # (background warm + host fallback, or block-when-cheaper)
                if self.async_warm and not self._warm_gate(
                        sig, kind, warm_run, int(mask.sum()),
                        fingerprint=ct.fingerprint, what="sweep"):
                    return None
                handle = self._dispatch_handle(ct, feats, enc, table,
                                               derived, len(cand_reviews),
                                               n_cons=n_cons)
            # the kernels for this shape are compiled or loaded by now:
            # remember the signature so a restarted process marks it warm
            # before its first sweep
            self.aot.record_sig(ct.fingerprint, sig)
            self.note_eval(kind, "device")
            return ("h", mask, cand, cand_reviews, handle, param_c(enc))
        except DriverError:
            raise
        except Exception as e:
            self._quarantine_kind(kind, "audit-eval", e)
            return None

    # ------------------------------------------- vectorized materialize

    def _msg_plan(self, kind: str):
        """The kind's message plan (ir/vecmat.py), or None for the exact
        per-pair path. Cached per template generation; metrics count the
        cache so plan-compile churn is visible."""
        if kind in self._msg_plans:
            self._note_msg_cache("hit")
            return self._msg_plans[kind]
        self._note_msg_cache("miss")
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

    @staticmethod
    def _note_msg_cache(outcome: str) -> None:
        try:
            from ..control.metrics import report_msg_template_cache

            report_msg_template_cache(outcome)
        except Exception:  # metrics backend optional in embedders
            pass

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


    # ------------------------------------------------- audit results delta

    def _template_reads_data(self, kind: str) -> bool:
        """Conservative taint check: does the (merged) template module
        reference `data` anywhere — e.g. a head-only binding reading
        data.inventory that the compiler skipped? Such a template's
        MESSAGES can change when other objects change, so its audit
        results must not be delta-served. Cached per compiled module."""
        tainted = self._data_taint.get(kind)
        if tainted is not None:
            return tainted
        module = self._modules.get(kind)

        def walk(t) -> bool:
            if isinstance(t, A.Var):
                return t.name == "data"
            if isinstance(t, (list, tuple)):
                return any(walk(x) for x in t)
            if hasattr(t, "__dataclass_fields__"):
                return any(walk(getattr(t, f))
                           for f in t.__dataclass_fields__)
            return False

        tainted = module is None or any(
            walk(r.key) or walk(r.value) or walk(r.args) or walk(r.body)
            for r in module.rules)
        self._data_taint[kind] = tainted
        return tainted

    def _review_index(self, reviews) -> dict:
        """id(review) -> global index map for the current review list,
        cached per (list identity, data revision) — rebuilding it costs
        one O(N) pass per sweep only when something changed."""
        ent = self._review_idx_cache
        if ent[0] is reviews and ent[1] == self._data_rev:
            return ent[2]
        idx = {id(rv): i for i, rv in enumerate(reviews)}
        self._review_idx_cache = (reviews, self._data_rev, idx)
        return idx

    def _audit_delta_serve(self, target, kind, cons, reviews, lookup_ns,
                           sig_cache, inventory):
        """Serve one kind's audit results from the delta cache: valid
        when constraints are unchanged, the review list is the same
        (patched-in-place) object, and the patch journal covers every
        write since the cached sweep. Only journal-dirty rows re-
        evaluate (on the host — the dirty set is orders of magnitude
        below the device-dispatch crossover); everything else, including
        the materialization tail, is reused. Returns the ordered result
        list or None when a full sweep is required."""
        ent = self._audit_results_cache.get((target, kind))
        if ent is None or ent["con_gen"] != self._constraint_gen or \
                ent["reviews"] is not reviews:
            return None
        if ent.get("capped") and self.audit_violations_cap is None:
            # cached results carry count-only (capped) messages from a
            # capped sweep: an UNCAPPED caller must re-materialize
            return None
        notes = self._notes_between(ent["rev"], self._data_rev)
        if notes is None:
            return None
        dirty: dict[int, dict] = {}
        for n in notes:
            if n[2] == target:
                dirty[n[3]] = n[5]
        by_row = ent["by_row"]
        if dirty:
            mask = self._match_mask(target, kind, cons, reviews, lookup_ns,
                                    sig_cache)
            for r_idx in sorted(dirty):
                review = reviews[r_idx]
                out: list[Result] = []
                for ci in np.flatnonzero(mask[r_idx]):
                    constraint = cons[int(ci)]
                    spec = constraint.get("spec")
                    spec = spec if isinstance(spec, dict) else {}
                    out.extend(self._eval_template_violations(
                        target, constraint, review,
                        spec.get("enforcementAction") or "deny",
                        inventory, None))
                if out:
                    by_row[r_idx] = out
                else:
                    by_row.pop(r_idx, None)
        ent["rev"] = self._data_rev
        flat: list[Result] = []
        for r_idx in sorted(by_row):
            flat.extend(by_row[r_idx])
        return flat

    def _audit_delta_store(self, target, kind, results, reviews) -> None:
        """Populate the delta cache from a full sweep's per-kind results
        (already row-major: grouping by the review object each Result
        carries preserves the exact order a delta-served sweep emits)."""
        idx = self._review_index(reviews)
        by_row: dict[int, list] = {}
        for res in results:
            i = idx.get(id(res.review))
            if i is None:
                return  # foreign review object: do not cache
            by_row.setdefault(i, []).append(res)
        self._audit_results_cache[(target, kind)] = {
            "con_gen": self._constraint_gen, "reviews": reviews,
            "rev": self._data_rev, "by_row": by_row,
            # capped sweeps cache count-only messages past the per-
            # constraint limit; delta-serve refuses them to uncapped
            # callers (the reverse — full messages to a capped sweep —
            # is a superset and serves fine)
            "capped": self.audit_violations_cap is not None}

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


    def _audit_consume(self, target, kind, st, cons, reviews, lookup_ns,
                       inventory, sig_cache, clock):
        """Phase 2: sync the dispatched slabs in order, materialize.
        `clock` is (dispatch time, the sample's t0, the dispatching
        thread's kernel_build.thread_stamp()) for the latency sample. A
        kernel's failure surfaces here, at the sync, as often as at its
        launch: it quarantines the kind, and the interpreter serves it.
        The wait for each slab's pairs (the device sync and the copy to
        the host) is timed as "device_sweep", the host's work on them as
        "materialize" (profiling.timers())."""
        if st[0] == "empty":
            return []
        _tag, mask, cand, cand_reviews, handle, c_dev = st
        out: list[Result] = []
        t_consume = time.monotonic()
        t_dev = t_mat = 0.0
        try:
            try:
                it = iter(handle.pairs())
                while True:
                    t0 = time.monotonic()
                    try:
                        rows, cols = next(it)
                    except StopIteration:
                        t_dev += time.monotonic() - t0
                        break
                    t_dev += time.monotonic() - t0
                    if not self._lat_sampled:
                        # DISPATCH -> first-result latency, sampled only for
                        # the audit's first consumed kind
                        self._lat_sampled = True
                        t_dispatch, t0, stamp = clock
                        sample = self._observe_latency(t0, stamp)
                        self.last_audit_lat_s = (
                            sample, time.monotonic() - t_dispatch)
                    t0 = time.monotonic()
                    rows, cols = _expand_parameterless(rows, cols, c_dev,
                                                       len(cons))
                    keep = mask[cand[rows], cols]
                    out.extend(self.materialize_pairs(
                        target, cons, cand_reviews, rows[keep], cols[keep],
                        inventory, cand=cand))
                    t_mat += time.monotonic() - t0
            finally:
                # the device syncs and the host materialization, failed
                # or not
                timers = profiling.timers()
                if t_dev > 0:
                    timers.add("device_sweep", t_dev)
                if t_mat > 0:
                    timers.add("materialize", t_mat)
                self.note_busy(time.monotonic() - t_consume)
        except DriverError:
            raise
        except Exception as e:
            self._quarantine_kind(kind, "audit-eval", e)
            return self._audit_interp(target, kind, cons, reviews,
                                      lookup_ns, inventory, None, sig_cache)
        if self._quarantine:
            self._quarantine_clear(kind)
        return out

    def _audit_interp(self, target, kind, cons, reviews, lookup_ns,
                      inventory, trace, sig_cache=None) -> list[Result]:
        self.note_eval(kind, "interp")
        out: list[Result] = []
        mask = self._match_mask(target, kind, cons, reviews, lookup_ns,
                                sig_cache)
        n_masked = 0
        t0 = time.monotonic()
        for r, review in enumerate(reviews):
            for c, constraint in enumerate(cons):
                if not mask[r, c]:
                    continue
                n_masked += 1
                spec = constraint.get("spec")
                spec = spec if isinstance(spec, dict) else {}
                enforcement = spec.get("enforcementAction") or "deny"
                out.extend(self._eval_template_violations(
                    target, constraint, review, enforcement, inventory, trace))
        # feed the cost model in its own units (masked pairs per second)
        el = time.monotonic() - t0
        if el > 0:
            profiling.timers().add("interp_eval", el)
        self.note_busy(el)
        if trace is None and el > 0.005 and n_masked >= 256:
            self._observe("_host_pair_rate", n_masked / el)
        return out

    def _audit_join(self, target, kind, jc, cons, reviews, lookup_ns,
                    inventory, trace, sig_cache=None) -> list[Result]:
        """Audit one inventory-join kind: exact aggregated-key join on
        device/host (ir/join.py) selects firing reviews; materialization
        re-checks and renders each firing pair exactly."""
        from ..utils.values import freeze

        mask = self._match_mask(target, kind, cons, reviews, lookup_ns,
                                sig_cache)
        cand = np.flatnonzero(mask.any(axis=1))
        if cand.size == 0:
            return []
        self.note_eval(kind, "join")
        t_join0 = time.monotonic()
        cand_reviews = [reviews[int(i)] for i in cand]
        if self._join_frz[0] != self._data_rev:
            self._join_frz = (self._data_rev, {}, {})
        rev_cache = self._join_frz[1]
        key_cache = self._join_frz[2].setdefault(kind, {})
        frz = []
        for r in cand_reviews:
            ent = rev_cache.get(id(r))
            if ent is None or ent[0] is not r:
                ent = (r, freeze(r))
                rev_cache[id(r)] = ent
            frz.append(ent[1])
        try:
            try:
                fires = jc.fires(frz, self._inventory_tree(target),
                                 self._data_gen, key_cache=key_cache)
            finally:
                # a failed eval still burned wall clock
                self.note_busy(time.monotonic() - t_join0)
        except Exception as e:
            # transient-capable quarantine, not a permanent demotion:
            # join templates heal the same way compiled ones do
            self._join_compiled.pop(kind, None)
            self._quarantine_kind(kind, "join-eval", e)
            return self._audit_interp(target, kind, cons, reviews,
                                      lookup_ns, inventory, trace,
                                      sig_cache)
        if self._quarantine:
            self._quarantine_clear(kind)
        hit = np.flatnonzero(fires)
        if hit.size == 0:
            return []
        # join programs are parameter-independent: expand each firing
        # review to every constraint its match allows
        sub = mask[cand[hit]]
        rows_rep, cols = np.nonzero(sub)
        rows = hit[rows_rep]
        if trace is None:
            return self.materialize_pairs(target, cons, cand_reviews,
                                          rows, cols, inventory,
                                          cand=cand)
        out: list[Result] = []
        for ri, ci in zip(rows, cols):
            constraint = cons[int(ci)]
            spec = constraint.get("spec")
            spec = spec if isinstance(spec, dict) else {}
            out.extend(self._eval_template_violations(
                target, constraint, cand_reviews[int(ri)],
                spec.get("enforcementAction") or "deny", inventory, trace))
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
        try:
            rows, cols = self.eval_compiled_pairs(ct, kind, cand_reviews,
                                                  cons, feat_key=feat_key,
                                                  cand=cand, target=target)
        except Exception as e:
            # eval-time failures quarantine the template's device program
            self._quarantine_kind(kind, "audit-eval", e)
            return self._audit_interp(target, kind, cons, reviews,
                                      lookup_ns, inventory, trace, sig_cache)
        if self._quarantine:
            self._quarantine_clear(kind)
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
        faults.fire("eval.device", kind=kind)
        feats, enc, table, derived = self._prepare_eval(ct, kind, reviews,
                                                        cons, feat_key)
        fires = ct.fires_chunked(feats, enc, table, derived,
                                 chunk=self.sweep_chunk, n_cons=len(cons))
        return fires[: len(reviews)]

    def _eval_compiled_gated(self, ct: CompiledTemplate, kind: str,
                             reviews: list[dict],
                             cons: list[dict]) -> np.ndarray:
        """eval_compiled with the off-path compile gate: a dense batch
        shape whose kernels have never run serves from the host THIS
        round (raises _ServeHostThisRound) while a background thread
        warms it — an admission batch never blocks on a compile."""
        faults.fire("eval.device", kind=kind)
        feats, enc, table, derived = self._prepare_eval(ct, kind, reviews,
                                                        cons, None)
        if self.async_warm:
            sig = self._sweep_sig(ct, kind, feats, enc, table, derived,
                                  len(reviews), dense=True)

            def warm_run():
                ct.fires_chunked(feats, enc, table, derived,
                                 chunk=self.sweep_chunk, n_cons=len(cons))
            with self._warm_lock:
                warm = sig in self._warm_done
                restored = sig in self._warm_restored
            if not warm:
                self._spawn_warm(sig, kind, warm_run,
                                 fingerprint=ct.fingerprint,
                                 what="dense batch")
                raise _ServeHostThisRound()
            if restored:
                # adopted from the program store, never run here: run
                # no-inline-compile guarded — if the stored variant is
                # missing after all, serve host and warm off-path rather
                # than stall this admission batch on a compile
                try:
                    with aot_mod.no_inline_compile():
                        fires = ct.fires_chunked(feats, enc, table,
                                                 derived,
                                                 chunk=self.sweep_chunk,
                                                 n_cons=len(cons))
                except aot_mod.WouldCompile:
                    self._unadopt(sig)
                    self._spawn_warm(sig, kind, warm_run,
                                     fingerprint=ct.fingerprint,
                                     what="dense batch")
                    raise _ServeHostThisRound()
                with self._warm_lock:
                    self._warm_restored.discard(sig)
                return fires[: len(reviews)]
        fires = ct.fires_chunked(feats, enc, table, derived,
                                 chunk=self.sweep_chunk, n_cons=len(cons))
        return fires[: len(reviews)]

    def eval_compiled_pairs(self, ct: CompiledTemplate, kind: str,
                            reviews: list[dict], cons: list[dict],
                            feat_key=None, cand=None, target=None) -> tuple:
        """(rows, cols) firing pairs, row-major — the sparse form of
        eval_compiled."""
        feats, enc, table, derived = self._prepare_eval(ct, kind, reviews,
                                                        cons, feat_key,
                                                        cand=cand,
                                                        target=target)
        rows, cols = ct.fires_pairs(feats, enc, table, derived,
                                    chunk=self.sweep_chunk,
                                    n_true=len(reviews), n_cons=len(cons))
        return _expand_parameterless(rows, cols, param_c(enc), len(cons))

    def eval_compiled_pairs_slabbed(self, ct: CompiledTemplate, kind: str,
                                    reviews: list[dict], cons: list[dict],
                                    feat_key=None, cand=None, target=None):
        """Iterator form of eval_compiled_pairs over N-axis slabs, with
        every slab's device work dispatched before the first yield (see
        CompiledTemplate.fires_pairs_slabbed) — the audit's
        sweep/materialize pipeline."""
        feats, enc, table, derived = self._prepare_eval(ct, kind, reviews,
                                                        cons, feat_key,
                                                        cand=cand,
                                                        target=target)
        c_dev = param_c(enc)
        chunk = self.sweep_chunk
        slab = self._sweep_slab(len(reviews), chunk)
        for rows, cols in ct.fires_pairs_slabbed(feats, enc, table, derived,
                                                 chunk=chunk, slab=slab,
                                                 n_true=len(reviews),
                                                 n_cons=len(cons)):
            yield _expand_parameterless(rows, cols, c_dev, len(cons))

    def _prepare_eval(self, ct: CompiledTemplate, kind: str,
                      reviews: list[dict], cons: list[dict], feat_key,
                      cand=None, target=None):
        """Encode parameters (cached per constraint generation), extract
        features (cached under feat_key when given: reused for the same
        key, patched from the journal for the same candidates, adopted
        from restored rows when there is no cache yet), extend the
        derived columns and match table to the vocab, and place all of it
        on the driver's device."""
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
            elif meta is not None and cand is not None and \
                    target is not None:
                # replay single-object replacements onto the cached
                # arrays: patch the changed rows (host + device) instead
                # of re-extracting and re-uploading everything
                feats = self._patch_feats(ct, meta, cand, target)
                if feats is not None:
                    meta["key"] = feat_key
                    meta["rev"] = self._data_rev
            elif meta is None:
                # warm restart: adopt snapshotted rows when the
                # candidate set still matches
                feats = self._adopt_restored_rows(kind, cand, feat_key,
                                                  fcache)
        if feats is None:
            feats, buckets, n_pad = extract_batch(ct.program, self.strtab,
                                                  reviews)
            if feat_key is not None:
                fcache.clear()
                fcache["__meta__"] = {
                    "key": feat_key, "feats": feats,
                    "cand": None if cand is None else np.asarray(cand),
                    "buckets": buckets, "n_pad": n_pad,
                    "rev": self._data_rev,
                }
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

    def _patch_feats(self, ct: CompiledTemplate, meta: dict, cand,
                     target: str):
        """Apply journaled object replacements to the cached feature
        arrays as ONE batched patch: the dirty rows (last write wins
        per row) are re-extracted together with the ORIGINAL buckets —
        overflow falls back to a full rebuild, since _fill truncates
        silently — and scattered into the host arrays and, with one K5
        launch for the whole kind, into their device-resident copies.
        Returns the patched arrays or None when a rebuild is required."""
        if meta["cand"] is None or not np.array_equal(meta["cand"], cand):
            return None
        notes = self._notes_between(meta["rev"], self._data_rev)
        if notes is None:
            return None
        # dirty row positions, deduped keeping the LATEST replacement
        by_pos: dict[int, dict] = {}
        for n in notes:
            if n[2] != target:
                continue
            i, new = n[3], n[5]
            pos = int(np.searchsorted(cand, i))
            if not (pos < len(cand) and int(cand[pos]) == i):
                continue  # never a candidate: no feature row
            by_pos[pos] = new
        feats = meta["feats"]
        if not by_pos:
            return feats
        from .features import Extractor, _bucket

        ex = Extractor(ct.program, self.strtab)
        buckets = meta["buckets"]
        positions = sorted(by_pos)
        dirty = [by_pos[p] for p in positions]
        sizes = ex.axis_sizes(dirty)
        if any(sizes.get(a, 0) > buckets.get(a, 0) for a in sizes):
            return None  # outgrew a bucket: rebuild
        m = len(dirty)
        rows = ex.extract(dirty, _bucket(m), buckets)
        pos_arr = np.asarray(positions, dtype=np.int32)
        leaves = []
        for slot, arrs in rows.items():
            dst = feats[slot]
            for nm, a in arrs.items():
                dst[nm][pos_arr] = a[:m]
                leaves.append((dst[nm], a[:m]))
        self._dev_patch_rows(leaves, pos_arr)
        return feats

    def _dev_patch_rows(self, leaves: list, pos: np.ndarray) -> None:
        """Refresh the device-resident copies of patched host leaves:
        transfer only the dirty ROWS and scatter them into every
        resident buffer of the kind with ONE K5 launch. `leaves` holds
        (host array, its m new rows). On the CPU the tensors are views
        of the host arrays (`_dev` caches nothing), so the host patch
        is all there is."""
        if self.device.type == "cpu" or len(pos) == 0:
            return
        dsts, rows = [], []
        for arr, r in leaves:
            ent = self._dev_cache.get(id(arr))
            if ent is not None and ent[0]() is arr:
                dsts.append(ent[1])
                rows.append(r)
        if dsts:
            from ..kernels.rows_update import rows_update

            rows_update(dsts, pos, rows)

    # ----------------------------------------------------- batched reviews

    def _use_device_for_batch(self, n_masked_pairs: int) -> bool:
        """Cost-based dispatch: a device sweep has a fixed per-call
        latency while the host path costs per evaluated pair. Both are
        measured as EMAs at runtime, so the crossover adapts to wherever
        the card actually is. Probing (the first device sample, and the
        periodic re-probe that keeps a skewed EMA from shunning the
        device forever) happens ONLY on batches the host would take
        >= PROBE_FLOOR_S to clear."""
        host_est = n_masked_pairs / self._host_pair_rate
        if self._dev_batch_lat_s is not None and \
                self._dev_batch_lat_s < host_est:
            self._dev_skips = 0
            return True
        if host_est < self.PROBE_FLOOR_S:
            return False
        if self._dev_batch_lat_s is None:
            return True  # measure the device once, then decide from data
        self._dev_skips += 1
        if self._dev_skips >= 256:
            self._dev_skips = 0
            return True
        return False

    def _observe(self, attr: str, value: float, alpha: float = 0.3) -> None:
        prev = getattr(self, attr)
        setattr(self, attr, value if prev is None
                else prev + alpha * (value - prev))

    def _observe_latency(self, t0: float, stamp: tuple) -> Optional[float]:
        """One device-latency sample, from t0 (time.monotonic) to now;
        returns it. Dropped (None) when the calling thread compiled or
        built a kernel, or waited for a kernel lock another thread held,
        since its kernels/build.py thread_stamp() was `stamp`. With
        async_warm off the foreground compiles each new shape itself, and
        a compile wait folded into the EMA would steer batches to the host
        for ages; with it on, the foreground's dispatches are warm and the
        warm thread's compiles are not the foreground's, unless a launch
        of the foreground waited one out."""
        if kernel_build.thread_stamp() != stamp:
            return None
        sample = time.monotonic() - t0
        self._observe("_dev_batch_lat_s", sample)
        return sample

    def _review_batch_sparse(self, ct, kind, cand, cand_reviews, cons,
                             mask) -> list:
        """(review_index, constraint_index) firing pairs for one kind of a
        large batch, via the audit's slab dispatch (K2 + K1) and its
        block-when-cheaper warm gate (raises _ServeHostThisRound for the
        host path)."""
        faults.fire("eval.device", kind=kind)
        feats, enc, table, derived = self._prepare_eval(
            ct, kind, cand_reviews, cons, feat_key=None)
        n_cons = len(cons)
        sig = self._sweep_sig(ct, kind, feats, enc, table, derived,
                              len(cand_reviews))

        def warm_run():
            h = self._dispatch_handle(ct, feats, enc, table, derived,
                                      len(cand_reviews), n_cons=n_cons)
            for _ in h.pairs():
                pass
        if self.async_warm:
            if not self._warm_gate(sig, kind, warm_run, int(mask.sum()),
                                   fingerprint=ct.fingerprint,
                                   what="batch"):
                raise _ServeHostThisRound()
        # latency measured from DISPATCH to the first pairs
        t0, stamp = time.monotonic(), kernel_build.thread_stamp()
        handle = self._dispatch_guarded(sig, ct, feats, enc, table, derived,
                                        len(cand_reviews), n_cons)
        if handle is None:
            # the adopted signature didn't hold: this is a cold shape —
            # serve host while it warms in the background (an admission
            # batch never blocks on a compile)
            if self.async_warm:
                self._spawn_warm(sig, kind, warm_run,
                                 fingerprint=ct.fingerprint, what="batch")
                raise _ServeHostThisRound()
            handle = self._dispatch_handle(ct, feats, enc, table, derived,
                                           len(cand_reviews), n_cons=n_cons)
        self.aot.record_sig(ct.fingerprint, sig)
        c_dev = param_c(enc)
        pairs = []
        first = True
        for rows, cols in handle.pairs():
            if first:
                self._observe_latency(t0, stamp)
                first = False
            rows, cols = _expand_parameterless(rows, cols, c_dev, len(cons))
            keep = mask[cand[rows], cols]
            pairs.extend(zip((int(x) for x in cand[rows[keep]]),
                             (int(x) for x in cols[keep])))
        return pairs

    def review_batch(self, target: str, reviews: list[dict]
                     ) -> list[list[Result]]:
        """Evaluate many admission reviews at once (the webhook
        micro-batcher's entry point). Compiled kinds go through the device
        when the measured device latency beats the measured host per-pair
        rate for this batch's workload (_use_device_for_batch) and the
        batch has at least MIN_DEVICE_BATCH reviews; the rest through the
        interpreter per review."""
        t0 = time.monotonic()
        try:
            return self._review_batch(target, reviews)
        finally:
            # finally, not the happy path: an engine burning its wall
            # clock on FAILING evals must still read busy
            self.note_busy(time.monotonic() - t0)

    def _review_batch(self, target: str, reviews: list[dict]
                      ) -> list[list[Result]]:
        constraints = self._constraints(target)
        lookup_ns = self._namespace_lookup(target)
        inventory = self._inventory_tree(target)
        out: list[list[Result]] = [[] for _ in reviews]
        if not constraints:
            return out
        self._cold_host_begin()
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
        batch_frz: dict = {}  # id(review) -> frozen, shared across kinds
        for kind in sorted(by_kind):
            cons = by_kind[kind]
            mask = match_masks(cons, reviews, lookup_ns)
            ct = self.compiled_for(kind)
            pairs = None
            n_masked = int(mask.sum())
            jc = self.join_for(kind) if ct is None and n_masked else None
            if jc is not None:
                jcand = np.flatnonzero(mask.any(axis=1))
                frz = []
                for i in jcand:
                    r = reviews[int(i)]
                    f = batch_frz.get(id(r))
                    if f is None:
                        f = batch_frz[id(r)] = freeze(r)
                    frz.append(f)
                try:
                    fires = jc.fires(frz, inventory, self._data_gen)
                    pairs = [(int(jcand[k]), c)
                             for k in np.flatnonzero(fires)
                             for c in range(len(cons))
                             if mask[int(jcand[k]), c]]
                    if self._quarantine:
                        self._quarantine_clear(kind)
                    self.note_eval(kind, "join")
                except Exception as e:
                    self._join_compiled.pop(kind, None)
                    self._quarantine_kind(kind, "join-eval", e)
                    pairs = None
            if ct is not None and n_masked and \
                    len(reviews) >= self.MIN_DEVICE_BATCH and \
                    self._use_device_for_batch(n_masked):
                cand = np.flatnonzero(mask.any(axis=1))
                cand_reviews = [reviews[int(i)] for i in cand]
                try:
                    if len(cand_reviews) >= self.SPARSE_BATCH_MIN:
                        pairs = self._review_batch_sparse(
                            ct, kind, cand, cand_reviews, cons, mask)
                    else:
                        t0 = time.monotonic()
                        stamp = kernel_build.thread_stamp()
                        fires = self._eval_compiled_gated(ct, kind,
                                                          cand_reviews, cons)
                        self._observe_latency(t0, stamp)
                        hits = np.logical_and(fires, mask[cand])
                        pairs = [(int(cand[ri]), int(ci))
                                 for ri, ci in zip(*np.nonzero(hits))]
                    if self._quarantine:
                        self._quarantine_clear(kind)
                    self.note_eval(kind, "device")
                except _ServeHostThisRound:
                    pass  # host path below; the warm continues
                except Exception as e:
                    self._quarantine_kind(kind, "review-eval", e)
            if pairs is None:
                if n_masked:
                    self.note_eval(kind, "interp")
                pairs = [(r, c) for r in range(len(reviews))
                         for c in range(len(cons)) if mask[r, c]]
                t0 = time.monotonic()
            else:
                t0 = None
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
            if t0 is not None:
                host_s = time.monotonic() - t0
                self._cold_host_done(host_s)
                if pairs and host_s > 0:
                    self._observe("_host_pair_rate", len(pairs) / host_s)
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

    # ---------------------------------------------------- what-if preview

    def audit_kind(self, target: str, kind: str,
                   cons: list[dict]) -> tuple[list, str]:
        """Sweep ONE kind's constraints over the full cached inventory
        — the what-if preview's evaluation core. `kind` is normally a
        preview ALIAS (control/preview.py compiles the candidate
        template under a content-hashed alias kind), so every per-kind
        cache this rides — match mask, extracted feature rows, device
        programs, delta patching — is isolated from (and shaped exactly
        like) the serving library's. Reuses the audit dispatch/consume
        pipeline (K2 + K1 on the card, K4 for a join kind) and its warm
        gate. Returns (results, path) with path in
        device|join|interp|empty.

        The device-latency EMA is NOT sampled here: preview sweeps may
        carry one-off compiles and must not steer admission batches to
        the host."""
        self._lat_sampled = True
        self._cold_host_begin()
        lookup_ns = self._namespace_lookup(target)
        inventory = self._inventory_tree(target)
        reviews = self._inventory_reviews(target)
        sig_cache = self._audit_sig_cache(target)
        if not reviews:
            return [], "empty"
        ct = self.compiled_for(kind)
        if ct is not None:
            st = self._audit_dispatch(target, kind, ct, cons, reviews,
                                      lookup_ns, sig_cache)
            if st is not None:
                return (self._audit_consume(target, kind, st, cons,
                                            reviews, lookup_ns,
                                            inventory, sig_cache, None),
                        "empty" if st[0] == "empty" else "device")
            return (self._audit_interp(target, kind, cons, reviews,
                                       lookup_ns, inventory, None,
                                       sig_cache), "interp")
        jc = self.join_for(kind)
        if jc is not None:
            return (self._audit_join(target, kind, jc, cons, reviews,
                                     lookup_ns, inventory, None,
                                     sig_cache), "join")
        return (self._audit_interp(target, kind, cons, reviews,
                                   lookup_ns, inventory, None,
                                   sig_cache), "interp")
