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

Over a mesh (parallel/mesh.py) the sweep shards the N axis over "data":
each shard runs K2 on its contiguous row block (or on its slabs) and K1
with its global row offset, on its own device, and the host decodes the
per-shard pair blocks in mesh order (fires_pairs_mesh_dispatch: the
arithmetic of evaljax's `_mesh_pairs_jit` and `_mesh_slab_pairs_jit`).
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
from ..parallel.mesh import block_tree, on_device, replicate, shard_features
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


def _mesh_shards(feats, params, table, derived, mesh) -> list:
    """Per data shard d: (device, feats, params, table, derived) on mesh
    device (d, 0) — feature leaves split on "data" (a Sharded placement
    passes through), the rest replicated."""
    feats = shard_features(feats, mesh)
    params, table, derived = (replicate(x, mesh)
                              for x in (params, table, derived))
    return [(mesh.device(d), block_tree(feats, d), block_tree(params, d),
             table.block(d), block_tree(derived, d))
            for d in range(mesh.shape["data"])]


def _mesh_compact(dev, words, r_begin: int, row0: int, n_valid: int,
                  c: int, pcap: int):
    """K1 for one shard's words on its device: local rows below r_begin
    (a slab's clamp overlap) and at or past global row n_valid
    (extraction padding) masked, rows numbered from global row0."""
    r_end = max(0, min(words.shape[0], n_valid - row0))
    with on_device(dev):
        return pair_compact(words, r_begin, r_end, row0, c, pcap)


def _fetch_shards(ct, pend: list, args: tuple):
    """Fetch each shard's pair block (pend: (words, r_begin, row0,
    block) per shard, dispatched at capacity `rcap`); a shard over its
    capacity re-runs every shard's K1 at the next power of two (rare;
    ratcheted into ct._rows_cap_mesh). Returns the host blocks and
    counts."""
    devs, n_valid, c, rcap = args
    arrs = [_fetch(blk) for _w, _b, _r, blk in pend]
    counts = [int(a[0, 0]) for a in arrs]
    while max(counts, default=0) > rcap:
        rcap = max(rcap, _next_cap(max(counts)))
        arrs = [_fetch(_mesh_compact(dev, w, rb, row0, n_valid, c, rcap))
                for dev, (w, rb, row0, _blk) in zip(devs, pend)]
        counts = [int(a[0, 0]) for a in arrs]
    # RATCHET, like _SlabPairs does for _rows_cap: alternating small and
    # large mesh sweeps must not re-trip the overflow re-run on each grow
    top = max(counts, default=0)
    ct._rows_cap_mesh = max(ct._rows_cap_mesh, 256,
                            _next_cap(top) if top > 1 else 256)
    return arrs, counts


class _MeshPairs:
    """Pending mesh sweep: every shard's K2 and K1 enqueued at
    construction, before any fetch; .pairs() syncs and decodes shard row
    blocks in mesh order (global row-major, since the data axis shards
    the N axis into contiguous ordered blocks)."""

    def __init__(self, ct, shards, n_loc, n_valid, c, chunk):
        self._ct = ct
        rcap = ct._rows_cap_mesh
        self._pend = []
        for k, (dev, f, p, t, dv) in enumerate(shards):
            with on_device(dev):
                words = ct.words(f, p, t, dv, chunk)
            row0 = k * n_loc
            self._pend.append((words, 0, row0, _mesh_compact(
                dev, words, 0, row0, n_valid, c, rcap)))
        self._args = ([s[0] for s in shards], n_valid, c, rcap)

    def pairs(self):
        for _shard, rows, cols in self.pairs_labeled():
            yield rows, cols

    def pairs_labeled(self):
        """(shard, rows, cols) per data shard — the shard index feeds
        the per-shard audit stage histograms."""
        arrs, counts = _fetch_shards(self._ct, self._pend, self._args)
        for k, (arr, n) in enumerate(zip(arrs, counts)):
            rows, cols = _decode_pair_blocks(arr, n)
            yield k, rows, cols


class _MeshSlabPairs:
    """Pending DOUBLE-BUFFERED mesh slab sweeps.

    Slabbing the LOCAL row axis lets the host materialize slab s's pairs
    while the devices sweep slab s+1: each slab is every shard's next
    `lslab` local rows (K2 at the clamped start, then K1), at most WINDOW
    slabs are in flight, and the only syncs are at slab boundaries.
    Yield order is (slab, shard): blocks are NOT globally row-major
    (shard d's slab-s rows are d*n_loc + [s*lslab, ...)), so
    order-sensitive consumers reassemble by each block's first global
    row (the driver's audit consume does)."""

    WINDOW = 2  # double-buffered: one slab syncing, one in flight

    def __init__(self, ct, shards, n_loc, lslab, n_slabs, n_valid, c,
                 chunk):
        self._ct = ct
        self._shards = shards
        self._n_loc = n_loc
        self._lslab = lslab
        self._n_slabs = n_slabs
        self._n_valid = n_valid
        self._c = c
        self._chunk = chunk
        # prime the pipeline NOW: the audit's cross-kind window consumes
        # handles long after construction
        self._pend = [(s, ct._rows_cap_mesh, self._dispatch(s))
                      for s in range(min(self.WINDOW, n_slabs))]
        self._next = len(self._pend)

    def _dispatch(self, s: int) -> list:
        """Slab s on every shard: K2 over the lslab local rows from the
        clamped start cs, then K1 with the rows before `start` (already
        emitted by the previous slab) and past n_valid masked."""
        ct, lslab = self._ct, self._lslab
        start = s * lslab
        cs = min(start, self._n_loc - lslab)
        pcap = ct._rows_cap_mesh
        out = []
        for k, (dev, f, p, t, dv) in enumerate(self._shards):
            sub = {slot: {nm: a[cs:cs + lslab] for nm, a in arrs.items()}
                   for slot, arrs in f.items()}
            with on_device(dev):
                words = ct.words(sub, p, t, dv, self._chunk)
            row0 = k * self._n_loc + cs
            out.append((words, start - cs, row0, _mesh_compact(
                dev, words, start - cs, row0, self._n_valid, self._c,
                pcap)))
        return out

    def pairs(self):
        for _shard, rows, cols in self.pairs_labeled():
            yield rows, cols

    def pairs_labeled(self):
        devs = [s[0] for s in self._shards]
        while self._pend:
            _s, rcap, pend = self._pend.pop(0)
            if self._next < self._n_slabs:
                # keep the window full BEFORE blocking: the refill slab
                # overlaps this slab's fetch and materialization
                self._pend.append((self._next, self._ct._rows_cap_mesh,
                                   self._dispatch(self._next)))
                self._next += 1
            arrs, counts = _fetch_shards(
                self._ct, pend, (devs, self._n_valid, self._c, rcap))
            for k, (arr, n) in enumerate(zip(arrs, counts)):
                rows, cols = _decode_pair_blocks(arr, n)
                yield k, rows, cols


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
        # per-shard capacity for the mesh sweep (fires_pairs_mesh_dispatch)
        self._rows_cap_mesh = 256

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

    # the mesh slab loop engages once each shard holds at least this
    # many multiples of the chunk (below it, one dispatch is cheaper than
    # the per-slab fetch round trips); slabs aim for ~MESH_SLABS a sweep
    MESH_SLAB_MIN_CHUNKS = 8
    MESH_SLABS = 8

    def _mesh_plan(self, n_feat: int, n_data: int, chunk: int,
                   slab: Optional[int]) -> tuple:
        """(n_loc, chunk_eff, local slab or None for one dispatch) of a
        mesh sweep over n_feat rows; raises on shapes evaljax refuses."""
        if n_feat % n_data:
            raise ValueError(f"N={n_feat} not shardable over data={n_data}")
        n_loc = n_feat // n_data
        chunk_eff = min(chunk, n_loc)
        if n_loc % chunk_eff:
            raise ValueError(f"n_loc={n_loc} not divisible by "
                             f"chunk={chunk_eff}")
        lslab = slab
        if lslab is None and \
                n_loc >= self.MESH_SLAB_MIN_CHUNKS * chunk_eff:
            # power-of-two extraction buckets make this exact: aim for
            # MESH_SLABS slabs, never below one chunk each
            lslab = max(chunk_eff, n_loc // self.MESH_SLABS)
        if lslab is not None and lslab < n_loc:
            if n_loc % lslab or lslab % chunk_eff:
                raise ValueError(
                    f"slab={lslab} must divide n_loc={n_loc} and be a "
                    f"multiple of chunk={chunk_eff}")
            return n_loc, chunk_eff, lslab
        return n_loc, chunk_eff, None

    def mesh_sweep_key(self, feats: dict, params: dict, match_table,
                       mesh, derived: Optional[dict] = None,
                       chunk: int = 8192,
                       slab: Optional[int] = None) -> tuple:
        """The K2 variants a mesh sweep launches: one shard's, at the
        per-shard row count (the local slab when the slab loop runs), with
        the mesh's data width (a mesh sweep is warm once it ran, not once
        a single-device sweep of that shape did)."""
        n_loc, _chunk, lslab = self._mesh_plan(
            feat_rows(feats), mesh.shape["data"], chunk, slab)
        _dev, f, p, t, dv = _mesh_shards(feats, params, match_table,
                                         derived or {}, mesh)[0]
        return (("mesh", mesh.shape["data"]),
                clause_triton.variant_key(f, p, t, dv, lslab or n_loc))

    def fires_pairs_mesh_dispatch(self, feats: dict, params: dict,
                                  match_table, mesh,
                                  derived: Optional[dict] = None,
                                  chunk: int = 8192,
                                  n_true: Optional[int] = None,
                                  slab: Optional[int] = None,
                                  n_cons: Optional[int] = None):
        """Mesh-sharded form of fires_pairs_dispatch: enqueue the sweep
        on every shard NOW and return a handle whose .pairs() syncs and
        yields per-shard (rows, cols), and .pairs_labeled() (shard, rows,
        cols). Requires the feature N axis divisible by the mesh's "data"
        axis size (callers pad to a power-of-two bucket and gate on
        divisibility). Feature leaves may be host arrays or Sharded
        placements on the mesh (the driver keeps those resident).

        Large sweeps take the double-buffered SLAB loop (_MeshSlabPairs);
        small ones one dispatch (_MeshPairs). `slab` overrides the LOCAL
        (per-shard) slab size — it must divide the per-shard row count and
        be a multiple of the chunk."""
        derived = derived or {}
        n_data = mesh.shape["data"]
        if not feats:
            raise ValueError(f"N=0 not shardable over data={n_data}")
        n_feat = feat_rows(feats)
        n = n_feat if n_true is None else min(n_feat, n_true)
        n_loc, chunk_eff, lslab = self._mesh_plan(n_feat, n_data, chunk,
                                                  slab)
        c = param_c(params)
        if n_cons is not None:
            c = min(c, n_cons)
        shards = _mesh_shards(feats, params, match_table, derived, mesh)
        if lslab is not None:
            return _MeshSlabPairs(self, shards, n_loc, lslab,
                                  n_loc // lslab, n, c, chunk_eff)
        return _MeshPairs(self, shards, n_loc, n, c, chunk_eff)

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
