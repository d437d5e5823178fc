"""K5: resident feature-row scatter, dst_l[pos[i]] = rows_l[i] per leaf.

Replaces the JAX package's row-patch program (gatekeeper_tpu/ir/driver.py,
`TpuDriver._dev_patch_rows`'s `upd`: `d.at[p].set(r)`, one dispatch per
feature leaf). When an audit replays journaled object replacements onto
a kind's cached feature arrays (`TorchDriver._patch_feats`), the host
arrays are patched in place and this writes the same m dirty rows into
every device-resident copy of the kind's leaves, in one launch.

The kernel is CUDA C++ for sm_90a (csrc/rows_update.cu), built with nvcc
at first use and bound with ctypes. Rows are copied as raw bytes, so a
leaf may be int8, int32 or float32 (NaN payloads kept bit for bit), and a
uint32 host leaf patches its int32-view resident copy (ir/carry.py).
`pack` lays out the kernel's unit plan (each leaf's unit width and units,
their prefix), `pos` and every leaf's rows in one pinned host buffer;
`stage` copies it with one non-blocking H2D copy on the current stream,
and the kernel launches behind it on the same stream, so stream order
puts the scatter before the next sweep reads the leaves. The pinned
buffer is held until an event recorded after its copy has completed.
`rows_update_plain` is `index_copy_` per leaf.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import LOAD_LOCK, build_so, count_launch

_lib = None
# (pinned host buffer, event recorded after its H2D copy): a buffer is
# released only once its copy has completed
_inflight: list = []
# csrc/rows_update.cu LeafDesc
_DESC = np.dtype([("dst", "<u8"), ("src", "<u8"), ("w", "<u4"),
                  ("c", "<u4")])
# the descriptor table (4 + 24 bytes a leaf) stays under the 48 KB of
# shared memory a block takes without opting in to more
MAX_LEAVES = 1536
_MAX_UNITS = 1 << 31  # unit indices are 32-bit in the kernel


def build() -> str:
    """Build (or reuse) and load the library; returns nvcc's ptxas report
    (empty when the library was already built)."""
    global _lib
    path, report = build_so("rows_update")
    with LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(path)
            fn = lib.rows_update
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                           ctypes.c_uint, ctypes.c_ulonglong, ctypes.c_uint,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return report


def _host_rows(r) -> np.ndarray:
    a = np.ascontiguousarray(r)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _check(dsts, pos: np.ndarray, rows) -> None:
    if len(dsts) != len(rows):
        raise ValueError(f"rows_update: {len(dsts)} leaves but {len(rows)} "
                         "row blocks")
    if len(dsts) > MAX_LEAVES:
        raise ValueError(f"rows_update: {len(dsts)} leaves in one call, "
                         f"above MAX_LEAVES ({MAX_LEAVES}, the descriptor "
                         "table in shared memory)")
    m = len(pos)
    dev = dsts[0].device
    for k, (d, r) in enumerate(zip(dsts, rows)):
        if d.device != dev or not d.is_contiguous() or d.dim() < 1:
            raise ValueError(
                f"rows_update: leaf {k} must be a contiguous tensor of at "
                f"least one dim on {dev}, got {tuple(d.shape)} on {d.device}")
        if r.shape != (m,) + tuple(d.shape[1:]) or \
                r.dtype.itemsize != d.element_size():
            raise ValueError(
                f"rows_update: leaf {k} {d.dtype} {tuple(d.shape)} cannot "
                f"take rows {r.dtype} {r.shape} at {m} positions")
    if m and (int(pos.min()) < 0 or
              int(pos.max()) >= min(d.shape[0] for d in dsts)):
        k = int(np.argmin([d.shape[0] for d in dsts]))
        raise ValueError(f"rows_update: a position is outside leaf {k}'s "
                         f"{dsts[k].shape[0]} rows")


def rows_update(dsts: list, pos, rows: list) -> None:
    """K5 wrapper: write rows[l][i] into dsts[l][pos[i]] for every leaf l.

    `pos` is a host int array [m]; `rows` are host arrays [m, ...] of the
    leaves' row shapes and item sizes. The plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (no fallback between them)."""
    if not dsts:
        return
    pos = np.ascontiguousarray(pos, dtype=np.int32)
    rows = [_host_rows(r) for r in rows]
    _check(dsts, pos, rows)
    dev = dsts[0].device
    if dev.type == "cpu":
        rows_update_plain(dsts, torch.from_numpy(pos),
                          [torch.from_numpy(r) for r in rows])
        return
    if dev.type != "cuda":
        raise ValueError(f"rows_update: unsupported device {dev}")
    if len(pos) == 0:
        return
    launch(*stage(dsts, pos, rows))


def unit_plan(base: np.ndarray, row_bytes: np.ndarray, m: int) -> tuple:
    """K5's unit plan for `m` rows into each leaf, from the leaves' base
    addresses and row sizes (uint64 [L]): (w, c, prefix) with w[l] the
    widest of 16/8/4/2/1 bytes dividing both, c[l] = row_bytes[l] / w[l]
    units a row and prefix[L + 1] the exclusive prefix of the m c[l]
    units of each leaf (prefix[L] = U, all units)."""
    low = row_bytes | base | np.uint64(16)
    w = low & (~low + np.uint64(1))  # the lowest set bit, at most 16
    c = row_bytes // w
    prefix = np.zeros(len(base) + 1, dtype=np.uint64)
    np.cumsum(c * np.uint64(m), out=prefix[1:])
    return w, c, prefix


def pack(dsts: list, pos: np.ndarray, rows: list, pin: bool) -> tuple:
    """Lay out everything K5 reads (csrc/rows_update.cu): the unit prefix
    and the leaf descriptors, `pos` (int32) and every leaf's rows (checked
    by the caller) at 16-byte boundaries, in one host buffer (pinned when
    `pin`); m > 0. Returns (buffer, (L, table_bytes, desc_off, pos_off,
    U))."""
    m, L = len(pos), len(dsts)
    base = np.fromiter((d.data_ptr() for d in dsts), np.uint64, L)
    sizes = np.fromiter((r.nbytes for r in rows), np.int64, L)
    row_bytes = (sizes // m).astype(np.uint64)
    w, c, prefix = unit_plan(base, row_bytes, m)
    U = int(prefix[-1])
    if U >= _MAX_UNITS:
        raise ValueError(f"rows_update: {U} units in one call")
    desc_off = (4 * (L + 1) + 7) & ~7
    table_bytes = (desc_off + _DESC.itemsize * L + 15) & ~15
    pos_off = table_bytes
    rows_off = (pos_off + 4 * m + 15) & ~15
    padded = (sizes + 15) & ~15
    src = np.empty(L, dtype=np.int64)
    src[0] = rows_off
    np.cumsum(padded[:-1], out=src[1:])
    src[1:] += rows_off
    end = rows_off + int(padded.sum())
    buf = torch.empty(end, dtype=torch.uint8, pin_memory=pin)
    hb = buf.numpy()
    desc = np.zeros(L, dtype=_DESC)
    desc["dst"], desc["src"], desc["w"], desc["c"] = base, src, w, c
    hb[:table_bytes] = 0
    hb[:4 * (L + 1)] = prefix.astype(np.uint32).view(np.uint8)
    hb[desc_off:desc_off + desc.nbytes] = desc.view(np.uint8)
    hb[pos_off:pos_off + 4 * m] = pos.view(np.uint8)
    # every leaf's rows, and the zero pads around them, in one copy
    zeros = np.zeros(16, dtype=np.uint8)
    pieces = [zeros[:rows_off - pos_off - 4 * m]]
    for r, n, p in zip(rows, sizes.tolist(), padded.tolist()):
        pieces += (r.reshape(-1).view(np.uint8), zeros[:p - n])
    np.concatenate(pieces, out=hb[pos_off + 4 * m:end])
    return buf, (L, table_bytes, desc_off, pos_off, U)


def stage(dsts: list, pos: np.ndarray, rows: list) -> tuple:
    """Pack K5's inputs into one pinned host buffer and copy it to the
    leaves' card with one non-blocking copy on the current stream.
    Returns K5's arguments (staged buffer, L, table_bytes, desc_off,
    pos_off, U)."""
    dev = dsts[0].device
    buf, meta = pack(dsts, pos, rows, pin=True)
    staged = torch.empty(buf.shape[0], dtype=torch.uint8, device=dev)
    staged.copy_(buf, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    _inflight[:] = [(b, e) for b, e in _inflight if not e.query()]
    _inflight.append((buf, done))
    return (staged,) + meta


def launch(staged: torch.Tensor, L: int, table_bytes: int, desc_off: int,
           pos_off: int, U: int) -> None:
    """Launch K5 on the current stream over a buffer `stage` made."""
    if _lib is None:
        build()
    rc = _lib.rows_update(staged.data_ptr(), L, table_bytes, desc_off,
                          pos_off, U, torch.cuda.current_stream(
                              staged.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rows_update kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(rows_update)


rows_update.launches = 0


def rows_update_plain(dsts: list, pos: torch.Tensor, rows: list) -> None:
    """The same scatter in plain PyTorch: `index_copy_` per leaf, with
    `pos` and the rows already on the leaves' device."""
    idx = pos.long()
    for d, r in zip(dsts, rows):
        d.index_copy_(0, idx, r.view(d.dtype))
