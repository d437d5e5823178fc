"""Constraint-parameter encoding: spec.parameters dicts → tensors.

Constraints are DATA, not code (SURVEY.md §7 P0): one compiled program per
template, with the C (constraint) axis carried entirely by these encoded
parameter tensors — adding/removing a constraint never recompiles anything
(the reference's code/data split between PutModules and PutData,
client.go:362-578).

For parameter values used as string-match patterns (allowedRegex, repo
prefixes, …) the encoder allocates match-table rows (ops/strtab.py) and
stores row indices per cell, so the device evaluates dynamic per-constraint
patterns with one gather.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..ops.strtab import MatchTables, StringTable, canon_num
from .features import _MISSING, _bucket, _descend_fields, _entries, kind_of
from .prog import K_ARR, K_FALSE, K_NUM, K_OBJ, K_STR, K_TRUE, Program


class ParamEncodeError(Exception):
    pass


def encode_params(program: Program, param_dicts: list[Any],
                  table: StringTable, match: MatchTables) -> dict:
    """-> {slot: arrays}; list slots [C, P], scalars [C], counts [C]."""
    C = len(param_dicts)
    out: dict[int, dict] = {}
    for spec in program.param_slots:
        iters = [s for s in spec.segs if s.kind == "iter"]
        if len(iters) > 1:
            raise ParamEncodeError("nested parameter list iteration")
        if spec.mode == "count" or not iters:
            arrs = _encode_scalar(spec, param_dicts, table, match, C)
        else:
            arrs = _encode_list(spec, param_dicts, table, match, C)
        out[spec.slot] = arrs
    return out


def _cell(v: Any, table: StringTable):
    k = kind_of(v)
    sid = table.intern(v) if k == K_STR else 0
    num = np.nan
    nid = 0
    if k == K_NUM:
        num = float(v)
        nid = table.intern(canon_num(v))
    elif k in (K_TRUE, K_FALSE):
        num = 1.0 if k == K_TRUE else 0.0
    return sid, num, nid, k


def _rows(v: Any, k: int, spec, match: MatchTables) -> dict[str, int]:
    out = {}
    for op in spec.pattern_ops:
        out[op] = match.row(op, v) if k == K_STR else -1
    return out


def _encode_scalar(spec, param_dicts, table, match, C):
    ids = np.zeros((C,), dtype=np.int32)
    nums = np.full((C,), np.nan, dtype=np.float32)
    nids = np.zeros((C,), dtype=np.int32)
    kinds = np.zeros((C,), dtype=np.int8)
    counts = np.zeros((C,), dtype=np.float32)
    rows = {op: np.full((C,), -1, dtype=np.int32) for op in spec.pattern_ops}
    for c, params in enumerate(param_dicts):
        node, i = _descend_fields(params if isinstance(params, dict) else {},
                                  [s for s in spec.segs], 0)
        if node is _MISSING or i < len(spec.segs):
            continue
        k = kind_of(node)
        kinds[c] = k
        if spec.mode == "count":
            if k in (K_ARR, K_OBJ):
                counts[c] = len(node)
            elif k == K_STR:
                counts[c] = len(node)
            continue
        sid, num, nid, _ = _cell(node, table)
        ids[c], nums[c], nids[c] = sid, num, nid
        for op, r in _rows(node, k, spec, match).items():
            rows[op][c] = r
    out = {"id": ids, "num": nums, "nid": nids, "kind": kinds,
           "count": counts}
    for op, arr in rows.items():
        out[f"row:{op}"] = arr
    return out


def _encode_list(spec, param_dicts, table, match, C):
    # pass 1: sizes
    prefix = []
    suffix = []
    seen_iter = False
    for s in spec.segs:
        if s.kind == "iter":
            seen_iter = True
            continue
        (suffix if seen_iter else prefix).append(s)
    lists: list[list] = []
    maxp = 0
    for params in param_dicts:
        node, i = _descend_fields(params if isinstance(params, dict) else {},
                                  prefix, 0)
        kids = _entries(node) if node is not _MISSING and i == len(prefix) else []
        lists.append(kids)
        maxp = max(maxp, len(kids))
    P = _bucket(maxp)
    ids = np.zeros((C, P), dtype=np.int32)
    nums = np.full((C, P), np.nan, dtype=np.float32)
    nids = np.zeros((C, P), dtype=np.int32)
    kinds = np.zeros((C, P), dtype=np.int8)
    keys = np.zeros((C, P), dtype=np.int32)
    key_nums = np.full((C, P), np.nan, dtype=np.float32)
    key_nids = np.zeros((C, P), dtype=np.int32)
    counts = np.zeros((C,), dtype=np.float32)
    rows = {op: np.full((C, P), -1, dtype=np.int32) for op in spec.pattern_ops}
    for c, kids in enumerate(lists):
        counts[c] = len(kids)
        for p, (key, v) in enumerate(kids):
            if suffix:
                v, j = _descend_fields(v, suffix, 0)
                if v is _MISSING or j < len(suffix):
                    continue
            sid, num, nid, k = _cell(v, table)
            ids[c, p], nums[c, p], nids[c, p], kinds[c, p] = sid, num, nid, k
            if isinstance(key, str):
                keys[c, p] = table.intern(key)
            else:
                key_nums[c, p] = float(key)
                key_nids[c, p] = table.intern(canon_num(key))
            for op, r in _rows(v, k, spec, match).items():
                rows[op][c, p] = r
    out = {"id": ids, "num": nums, "nid": nids, "kind": kinds,
           "count": counts, "key_id": keys, "key_num": key_nums,
           "key_nid": key_nids}
    for op, arr in rows.items():
        out[f"row:{op}"] = arr
    return out
