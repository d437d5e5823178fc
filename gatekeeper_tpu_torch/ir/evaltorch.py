"""PyTorch evaluation of compiled Programs (the JAX package's evaljax).

One CompiledTemplate per template answers `fires[N, C]` — does any
violation clause possibly fire for each (object, constraint) pair — and
its sparse form, the row-major firing (row, constraint) pairs. The device
work is two hand-written kernels:

    feature/param tensors ─K2 clause_words─▶ verdict words [N, W]
                                              │
                     K1 pair_compact ◀────────┘ (masked rows/columns)
                          │
                 [pcap+1, 2] pair block ──▶ host (one fetch per slab)

Tri-state semantics and the never-under-fire contract are those of
evaljax.py (see kernels/clause.py); the host re-check of firing pairs is
authoritative. The C axis may carry power-of-two bucket padding
(`n_cons` masks it) and the N axis extraction padding (`n_true` masks
it). Large sweeps run in slabs whose arithmetic equals evaljax's
`_slab_pairs_jit`, so pairs come out in the same row-major order.
"""

from __future__ import annotations

import logging
from dataclasses import replace as dc_replace
from typing import Optional

import numpy as np

from ..kernels.clause import (
    ClausePlan,
    clause_words,
    feat_rows,
    param_c,
    unpack_words,
)
from ..kernels import clause_triton
from ..kernels.pair_compact import build as build_pair_compact
from ..kernels.pair_compact import pair_compact
from ..ops.strtab import MatchTables, StringTable, canon_num
from .aot import AotStore, program_fingerprint
from .prog import (
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
    Program,
    SumReduce,
    Truthy,
)


log = logging.getLogger("gatekeeper_tpu_torch.ir.evaltorch")


def resolve_consts(program: Program, table: StringTable,
                   match: MatchTables) -> Program:
    """Replace string/pattern constants by interned ids / match rows.
    Must run before the match table is materialized."""

    def fix(e):
        if isinstance(e, Const):
            if e.kind == "str":
                return Const("id", table.intern(e.value))
            if e.kind == "row":
                op, pattern = e.value
                return Const("rowidx", match.row(op, pattern))
            if e.kind == "num":
                return Const("numc",
                             (float(e.value), table.intern(canon_num(e.value))))
            return e
        if isinstance(e, Cmp):
            return Cmp(e.op, fix(e.lhs), fix(e.rhs), e.dtype)
        if isinstance(e, Arith):
            return Arith(e.op, fix(e.lhs), fix(e.rhs))
        if isinstance(e, MatchLookup):
            return MatchLookup(fix(e.row), fix(e.sid))
        if isinstance(e, Truthy):
            return Truthy(fix(e.e))
        if isinstance(e, Exists):
            return Exists(fix(e.e))
        if isinstance(e, And):
            return And(tuple(fix(x) for x in e.items))
        if isinstance(e, Or):
            return Or(tuple(fix(x) for x in e.items))
        if isinstance(e, Not):
            return Not(fix(e.e), e.local_axes)
        if isinstance(e, OrReduce):
            return OrReduce(e.axis, fix(e.e))
        if isinstance(e, SumReduce):
            return SumReduce(e.axis, fix(e.e))
        if isinstance(e, DerivedVal):
            return DerivedVal(e.col, fix(e.base))
        if isinstance(e, KindIs):
            return KindIs(fix(e.e), e.kinds)
        return e

    clauses = tuple(
        dc_replace(c, guards=tuple(
            dc_replace(g, expr=fix(g.expr)) for g in c.guards))
        for c in program.clauses
    )
    return dc_replace(program, clauses=clauses)


def _next_cap(pcount: int) -> int:
    return 1 << (pcount - 1).bit_length()


def _fetch(block) -> np.ndarray:
    """Device pair block -> host int64 array (the sync point)."""
    return block.cpu().numpy().astype(np.int64)


class _EagerPairs:
    """Dispatch handle for sweeps below the slab threshold: the whole
    sweep (K2 + K1) is enqueued at CONSTRUCTION, so a multi-template audit
    overlaps every kind's device work; parameter-only programs stay lazy
    (one row of verdicts)."""

    def __init__(self, ct, feats, params, table, derived, chunk, n_true,
                 n_cons=None):
        self._ct = ct
        self._args = (feats, params, table, derived, chunk, n_true, n_cons)
        self._st = None
        if feats:
            n_feat = feat_rows(feats)
            n = n_feat if n_true is None else min(n_feat, n_true)
            c = param_c(params)
            if n_cons is not None:
                c = min(c, n_cons)
            self._st = ct._pairs_dispatch_mono(feats, params, table, derived,
                                               chunk, n, c)

    def pairs(self):
        if self._st is not None:
            yield self._ct._pairs_consume_mono(self._st)
            return
        feats, params, table, derived, chunk, n_true, n_cons = self._args
        yield self._ct.fires_pairs(feats, params, table, derived,
                                   chunk=chunk, n_true=n_true, n_cons=n_cons)


class _SlabPairs:
    """Pending slab sweeps; .pairs() syncs them in dispatch order with the
    capacity-retry loop."""

    def __init__(self, ct, pend, feats, params, table, derived, chunk, slab,
                 n, c):
        self._ct = ct
        self._pend = pend
        self._args = (feats, params, table, derived, chunk, slab, n, c)

    def pairs(self):
        ct = self._ct
        feats, params, table, derived, chunk, slab, n, c = self._args
        for k, (used_pcap, dev) in enumerate(self._pend):
            arr = _fetch(dev)
            pcount = int(arr[0, 0])
            while pcount > used_pcap:
                used_pcap = max(used_pcap, _next_cap(pcount))
                arr = _fetch(ct._slab_pairs(feats, params, table, derived,
                                            chunk, slab, used_pcap, k * slab,
                                            n, c))
                pcount = int(arr[0, 0])
            ct._rows_cap = max(ct._rows_cap,
                               _next_cap(pcount) if pcount > 1 else 256)
            yield _decode_pair_blocks(arr, pcount)


def _slabbed(n_feat: int, n_true: Optional[int], slab: int) -> bool:
    """Whether fires_pairs_dispatch sweeps in slabs (one K2 launch over
    `slab` feature rows per slab, the last slab's start clamped so that
    it is full) or whole (one launch over every feature row)."""
    n = n_feat if n_true is None else min(n_feat, n_true)
    return n > slab and n_feat >= slab


def _decode_pair_blocks(arr: np.ndarray, pcount: int):
    """(rows, cols) from one pair block (row-major, invalid columns and
    rows already masked on the device)."""
    if pcount == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy()
    body = arr[1:1 + pcount]
    return body[:, 0].astype(np.int64), body[:, 1].astype(np.int64)


class CompiledTemplate:
    """Device-evaluable filter for one template."""

    def __init__(self, program: Program, table: StringTable,
                 match: MatchTables, aot=None, kind: str = ""):
        self.table = table
        self.match = match
        self.program = resolve_consts(program, table, match)
        self.plans = [ClausePlan(self.program, c)
                      for c in self.program.clauses]
        # program store (ir/aot.py): K2's compiled variants persist
        # across processes and a warm boot loads them instead of
        # compiling. The fingerprint is over the RESOLVED program —
        # interned ids are embedded in the constants, so vocab skew
        # changes it and safely misses.
        self.kind = kind
        self.aot = aot if aot is not None else AotStore()
        self.fingerprint = program_fingerprint(self.program, kind)
        # generated K2 kernels, by shape signature (kernels/clause_triton)
        self._kernels: dict = {}
        # remembered firing-pair capacity (see fires_pairs)
        self._rows_cap = 256

    def preload_aot(self) -> dict:
        """Ingest-time background prewarm: load every stored K2 variant
        recorded for this program's fingerprint into its JIT function
        (clause_triton.preload), and K1's library (one nvcc library for
        every shape, so no entry of its own), so the first sweep or batch
        at a remembered shape launches with no compile on its path.
        Returns programs loaded, by tag."""
        loaded: dict[str, int] = {}
        if not self.aot.enabled:
            return loaded
        for ent in self.aot.entries_for(self.fingerprint):
            if ent["tag"] != "eval":
                continue
            key = self.aot.entry_key(self.fingerprint, "eval",
                                     ent["static"], ent["asig"])
            try:
                ok = clause_triton.preload(self.aot, key, ent["asig"],
                                           self.kind)
            except Exception as e:  # prewarm is best-effort
                log.warning("AOT preload of %s entry %s failed: %s: %s",
                            self.kind, key, type(e).__name__, e)
                continue
            if ok:
                loaded["eval"] = loaded.get("eval", 0) + 1
        if loaded:
            build_pair_compact()
        return loaded

    def words(self, feats: dict, params: dict, table, derived: dict,
              chunk: int = 8192):
        """K2: packed verdict words [N, W] int32 on the inputs' device."""
        return clause_words(self.plans, feats, params, table, derived or {},
                            chunk=chunk, cache=self._kernels,
                            aot=(self.aot, self.fingerprint, self.kind))

    def fires(self, feats: dict, params: dict, match_table,
              derived: Optional[dict] = None) -> np.ndarray:
        """-> bool [N, C] (N = 1 for parameter-only programs)."""
        c = param_c(params)
        words = self.words(feats, params, match_table, derived)
        return unpack_words(words.cpu().numpy())[:, :c]

    def fires_chunked(self, feats: dict, params: dict, match_table,
                      derived: Optional[dict] = None, chunk: int = 8192,
                      n_cons: Optional[int] = None) -> np.ndarray:
        """bool [N, c]: the dense verdicts with the C-bucket padding
        columns (>= n_cons) sliced off. `chunk` bounds the plain
        version's [chunk, axes..., C] intermediates; the kernel needs
        none."""
        c = param_c(params)
        if n_cons is not None:
            c = min(c, n_cons)
        words = self.words(feats, params, match_table, derived, chunk)
        return unpack_words(words.cpu().numpy())[:, :c]

    # ------------------------------------------------------ sparse verdicts

    def fires_pairs(self, feats: dict, params: dict, match_table,
                    derived: Optional[dict] = None, chunk: int = 8192,
                    n_true: Optional[int] = None,
                    n_cons: Optional[int] = None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (rows, cols): row-major firing (object, constraint) pairs.

        The pairs are compacted ON THE DEVICE (K1) and only they cross to
        the host; the capacity is remembered from the previous sweep and a
        miss re-gathers at the exact count. Rows >= n_true (extraction
        padding, which can legitimately fire absence clauses) and columns
        >= n_cons are masked before the count. evaljax takes a dense
        host nonzero below one chunk of rows; here every sweep with
        object slots compacts on the device (same pairs, same order)."""
        derived = derived or {}
        c = param_c(params)
        if n_cons is not None:
            c = min(c, n_cons)
        if not feats:
            fires = self.fires(feats, params, match_table, derived)
            rows, cols = np.nonzero(fires[:, :c])
            return rows.astype(np.int64), cols.astype(np.int64)
        n = feat_rows(feats)
        if n_true is not None:
            n = min(n, n_true)
        st = self._pairs_dispatch_mono(feats, params, match_table, derived,
                                       chunk, n, c)
        return self._pairs_consume_mono(st)

    def _pairs_dispatch_mono(self, feats, params, match_table, derived,
                             chunk: int, n: int, c: Optional[int] = None):
        """Enqueue the whole sweep (K2) and its pair compaction (K1);
        _pairs_consume_mono syncs, with the capacity-retry loop."""
        words = self.words(feats, params, match_table, derived, chunk)
        if c is None:
            c = param_c(params)
        rcap = self._rows_cap
        dev = pair_compact(words, 0, n, 0, c, rcap)
        return (words, n, rcap, dev, c)

    def _pairs_consume_mono(self, st):
        words, n, rcap, dev, c = st
        arr = _fetch(dev)
        pcount = int(arr[0, 0])
        while pcount > rcap:
            rcap = max(rcap, _next_cap(pcount))
            arr = _fetch(pair_compact(words, 0, n, 0, c, rcap))
            pcount = int(arr[0, 0])
        self._rows_cap = max(256, _next_cap(pcount) if pcount > 1 else 256)
        return _decode_pair_blocks(arr, pcount)

    def _slab_pairs(self, feats, params, table, derived, chunk: int,
                    slab: int, pcap: int, start: int, n_valid: int, c: int):
        """One slab: K2 over the `slab` feature rows from the clamped
        start cs = min(start, n_feat - slab), then K1 with the rows that
        are extraction padding (>= n_valid) or already emitted by the
        previous slab (< start) masked — evaljax._slab_pairs_jit's
        arithmetic, so pairs keep the global row-major order."""
        n_feat = feat_rows(feats)
        cs = min(start, n_feat - slab)
        sub = {slot: {nm: a[cs:cs + slab] for nm, a in arrs.items()}
               for slot, arrs in feats.items()}
        words = self.words(sub, params, table, derived, chunk)
        return pair_compact(words, start - cs, min(slab, n_valid - cs), cs,
                            c, pcap)

    def sweep_key(self, feats: dict, params: dict, match_table,
                  derived: Optional[dict] = None,
                  slab: Optional[int] = None,
                  n_true: Optional[int] = None) -> tuple:
        """The K2 variants one sweep launches (clause_triton.variant_key):
        fires_pairs_dispatch's with `slab`, the dense sweep's
        (fires_chunked, every feature row at once) without. Once a sweep
        with this key has run, the next launches only compiled kernels;
        K1 is built once and specializes on nothing."""
        rows = feat_rows(feats)
        if slab is not None and _slabbed(rows, n_true, slab):
            rows = slab
        return clause_triton.variant_key(feats, params, match_table,
                                         derived or {}, rows)

    def fires_pairs_dispatch(self, feats: dict, params: dict, match_table,
                             derived: Optional[dict] = None,
                             chunk: int = 8192, slab: int = 32768,
                             n_true: Optional[int] = None,
                             n_cons: Optional[int] = None):
        """Enqueue every slab's kernels NOW; the handle's .pairs() syncs
        and decodes slab by slab, so callers can dispatch many templates'
        sweeps before consuming any."""
        derived = derived or {}
        n_feat = feat_rows(feats) if feats else 0
        n = n_feat
        if n_true is not None:
            n = min(n, n_true)
        if not feats or not _slabbed(n_feat, n_true, slab):
            return _EagerPairs(self, feats, params, match_table, derived,
                               chunk, n_true, n_cons)
        c = param_c(params)
        if n_cons is not None:
            c = min(c, n_cons)
        n_slabs = (n + slab - 1) // slab
        rcap = self._rows_cap
        pend = [(rcap, self._slab_pairs(feats, params, match_table, derived,
                                        chunk, slab, rcap, k * slab, n, c))
                for k in range(n_slabs)]
        return _SlabPairs(self, pend, feats, params, match_table, derived,
                          chunk, slab, n, c)

    def fires_pairs_slabbed(self, feats: dict, params: dict, match_table,
                            derived: Optional[dict] = None,
                            chunk: int = 8192, slab: int = 32768,
                            n_true: Optional[int] = None,
                            n_cons: Optional[int] = None):
        """Yield row-major (rows, cols) firing pairs per N-axis slab
        (fires_pairs_dispatch, then consume)."""
        yield from self.fires_pairs_dispatch(
            feats, params, match_table, derived, chunk=chunk, slab=slab,
            n_true=n_true, n_cons=n_cons).pairs()
