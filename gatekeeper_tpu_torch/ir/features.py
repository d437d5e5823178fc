"""Host-side extraction: review dicts → fixed-shape feature tensors.

Turns ragged JSON into the dense arrays the device program consumes
(SURVEY.md §7 hard part 3): per object slot, cell arrays (string id /
number / kind code) shaped [N, K...] with per-axis pow2 bucketing so jit
recompiles are bounded (shapes only change when a bucket grows).

This is the ingest hot path; the C flattener (native/flatten.c) walks
the review dicts and fills the cell arrays ~an order of magnitude faster,
interning directly into the shared StringTable. This Python
implementation is the semantic reference and the fallback when no
compiler is available (differential tests pin exact equivalence,
including intern-id assignment order).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from ..ops.strtab import StringTable, canon_num
from .prog import (
    K_ABSENT,
    K_ARR,
    K_FALSE,
    K_NULL,
    K_NUM,
    K_OBJ,
    K_STR,
    K_TRUE,
    Program,
)

_MISSING = object()


def _bucket(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def kind_of(v: Any) -> int:
    if v is _MISSING:
        return K_ABSENT
    if v is None:
        return K_NULL
    if isinstance(v, bool):
        return K_TRUE if v else K_FALSE
    if isinstance(v, (int, float)):
        return K_NUM
    if isinstance(v, str):
        return K_STR
    if isinstance(v, (list, tuple)):
        return K_ARR
    if isinstance(v, dict):
        return K_OBJ
    return K_ABSENT


class Cells:
    """Column-major cell builder for one slot."""

    def __init__(self, shape: tuple, with_keys: bool):
        self.ids = np.zeros(shape, dtype=np.int32)
        self.nums = np.full(shape, np.nan, dtype=np.float32)
        self.nids = np.zeros(shape, dtype=np.int32)
        self.kinds = np.zeros(shape, dtype=np.int8)
        self.keys = np.zeros(shape, dtype=np.int32) if with_keys else None
        self.key_nums = (np.full(shape, np.nan, dtype=np.float32)
                         if with_keys else None)
        self.key_nids = np.zeros(shape, dtype=np.int32) if with_keys else None

    def put(self, idx: tuple, v: Any, table: StringTable):
        k = kind_of(v)
        self.kinds[idx] = k
        if k == K_STR:
            self.ids[idx] = table.intern(v)
        elif k == K_NUM:
            self.nums[idx] = float(v)
            self.nids[idx] = table.intern(canon_num(v))
        elif k in (K_TRUE, K_FALSE):
            self.nums[idx] = 1.0 if k == K_TRUE else 0.0

    def arrays(self) -> dict:
        out = {"id": self.ids, "num": self.nums, "nid": self.nids,
               "kind": self.kinds}
        if self.keys is not None:
            out["key_id"] = self.keys
            out["key_num"] = self.key_nums
            out["key_nid"] = self.key_nids
        return out


def _descend_fields(node: Any, segs, i: int):
    """Follow consecutive field segs; returns value or _MISSING."""
    while i < len(segs) and segs[i].kind == "field":
        if not isinstance(node, dict):
            return _MISSING, i
        node = node.get(segs[i].name, _MISSING)
        if node is _MISSING:
            return _MISSING, i
        i += 1
    return node, i


def _entries(node: Any):
    """(key, value) children of a collection, list indices as keys."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return []


class Extractor:
    """Extracts one Program's object slots from a batch of reviews."""

    def __init__(self, program: Program, table: StringTable,
                 native: Optional[bool] = None):
        self.program = program
        self.table = table
        # axis -> list position per slot computed from segs on the fly
        if native is False:
            self._native = None
        else:
            from ..native import flatten_ext

            self._native = flatten_ext()

    @staticmethod
    def _segs_wire(segs) -> tuple:
        return tuple((1, None) if s.kind == "iter" else (0, s.name)
                     for s in segs)

    def _root(self, review: dict, root: str) -> Any:
        if root == "review":
            return review
        v = review.get(root, _MISSING)
        return v if isinstance(v, dict) else _MISSING

    def axis_sizes(self, reviews: list[dict]) -> dict[str, int]:
        """Max collection length per axis over the batch (pre-pass)."""
        sizes: dict[str, int] = {}
        for spec in self.program.obj_slots:
            iters = [s for s in spec.segs if s.kind == "iter"]
            if not iters:
                continue
            if self._native is not None and isinstance(reviews, list):
                maxes = self._native.slot_sizes(
                    reviews, spec.root, self._segs_wire(spec.segs))
                for s, m in zip(iters, maxes):
                    if m > sizes.get(s.axis, 0):
                        sizes[s.axis] = m
                continue
            for review in reviews:
                node = self._root(review, spec.root)
                self._walk_sizes(node, spec.segs, 0, sizes)
        return sizes

    def _walk_sizes(self, node, segs, i, sizes: dict) -> None:
        node, i = _descend_fields(node, segs, i)
        if node is _MISSING or i >= len(segs):
            return
        seg = segs[i]
        if seg.kind != "iter":
            return
        kids = _entries(node)
        if len(kids) > sizes.get(seg.axis, 0):
            sizes[seg.axis] = len(kids)
        for _, v in kids:
            self._walk_sizes(v, segs, i + 1, sizes)

    def extract(self, reviews: list[dict], n_pad: int,
                axis_buckets: dict[str, int]) -> dict:
        """-> {slot: {id, num, kind[, key_id, key_num]}} arrays, N padded to
        n_pad, axis dims padded to their buckets."""
        out: dict[int, dict] = {}
        for spec in self.program.obj_slots:
            iter_axes = [s.axis for s in spec.segs if s.kind == "iter"]
            dims = tuple(axis_buckets.get(a, 1) for a in iter_axes)
            native = self._native if isinstance(reviews, list) else None
            if spec.mode == "count":
                counts = np.zeros((n_pad,), dtype=np.float32)
                kinds = np.zeros((n_pad,), dtype=np.int8)
                if native is not None:
                    if len(reviews) > n_pad:
                        raise IndexError(
                            f"{len(reviews)} reviews exceed n_pad={n_pad}")
                    native.fill_count(reviews, spec.root,
                                      self._segs_wire(spec.segs), counts,
                                      kinds)
                else:
                    for n, review in enumerate(reviews):
                        node, i = _descend_fields(
                            self._root(review, spec.root), spec.segs, 0)
                        if node is _MISSING or i < len(spec.segs):
                            continue
                        k = kind_of(node)
                        kinds[n] = k
                        if k in (K_ARR, K_OBJ, K_STR):
                            counts[n] = len(node)
                out[spec.slot] = {"count": counts, "kind": kinds}
                continue
            cells = Cells((n_pad,) + dims, with_keys=bool(iter_axes))
            if native is not None:
                if len(reviews) > n_pad:
                    raise IndexError(
                        f"{len(reviews)} reviews exceed n_pad={n_pad}")
                # epoch syncs from the actual table growth even if the
                # fill raises mid-batch (partial interns must not leave a
                # stale materialize_packed cache key behind)
                before = len(self.table._strs)
                try:
                    native.fill_slot(
                        reviews, spec.root, self._segs_wire(spec.segs),
                        tuple(int(d) for d in dims),
                        cells.ids, cells.nums, cells.nids, cells.kinds,
                        cells.keys, cells.key_nums, cells.key_nids,
                        self.table._ids, self.table._strs)
                finally:
                    self.table.epoch += len(self.table._strs) - before
            else:
                for n, review in enumerate(reviews):
                    self._fill(cells, (n,), self._root(review, spec.root),
                               spec.segs, 0, dims, 0)
            out[spec.slot] = cells.arrays()
        return out

    def _fill(self, cells: Cells, idx: tuple, node, segs, i, dims,
              depth: int) -> None:
        node, i = _descend_fields(node, segs, i)
        if node is _MISSING:
            return
        if i == len(segs):
            cells.put(idx, node, self.table)
            return
        # segs[i] is an iter seg
        last = i == len(segs) - 1
        for j, (k, v) in enumerate(_entries(node)):
            if j >= dims[depth]:
                break  # bucket overflow; caller sizes buckets from the batch
            sub = idx + (j,)
            if last:
                cells.put(sub, v, self.table)
                self._put_key(cells, sub, k, depth, len(dims))
            else:
                self._put_key(cells, sub, k, depth, len(dims))
                self._fill(cells, sub, v, segs, i + 1, dims, depth + 1)

    def _put_key(self, cells: Cells, idx: tuple, k, depth: int,
                 ndims: int) -> None:
        """Keys are recorded for the innermost axis only (the compiler
        rejects key-var bindings on outer axes of multi-axis slots)."""
        if cells.keys is None or depth != ndims - 1:
            return
        if isinstance(k, str):
            cells.keys[idx] = self.table.intern(k)
        else:
            cells.key_nums[idx] = float(k)
            cells.key_nids[idx] = self.table.intern(canon_num(k))


def extract_batch(program: Program, table: StringTable,
                  reviews: list[dict], n_bucket: int | None = None):
    """Convenience: size axes, bucket, extract. Returns (features,
    axis_buckets, n_pad)."""
    ex = Extractor(program, table)
    sizes = ex.axis_sizes(reviews)
    buckets = {a: _bucket(s) for a, s in sizes.items()}
    n_pad = n_bucket or _bucket(len(reviews))
    feats = ex.extract(reviews, n_pad, buckets)
    return feats, buckets, n_pad
