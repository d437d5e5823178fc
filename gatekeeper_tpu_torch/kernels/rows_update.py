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
The wrapper stages the leaf descriptors, `pos` and every leaf's rows in
one pinned host buffer, copies it with one non-blocking H2D copy on the
current stream and launches the kernel behind it on the same stream, so
stream order puts the scatter before the next sweep reads the leaves.
The pinned buffer is held until an event recorded after its copy has
completed. `rows_update_plain` is `index_copy_` per leaf.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import build_so

_lib = None
# (pinned host buffer, event recorded after its H2D copy): a buffer is
# released only once its copy has completed
_inflight: list = []
_DESC_BYTES = 32  # csrc/rows_update.cu LeafDesc


def build() -> str:
    """Build (or reuse) and load the library; returns nvcc's ptxas report
    (empty when the library was already built)."""
    global _lib
    path, report = build_so("rows_update")
    if _lib is None:
        lib = ctypes.CDLL(path)
        fn = lib.rows_update
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_ulonglong, ctypes.c_void_p]
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
    if len(dsts) > 65535:  # the grid's y dimension
        raise ValueError(f"rows_update: {len(dsts)} leaves in one call")
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
        if m and (int(pos.min()) < 0 or int(pos.max()) >= d.shape[0]):
            raise ValueError(f"rows_update: a position is outside leaf {k}'s "
                             f"{d.shape[0]} rows")


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


def stage(dsts: list, pos: np.ndarray, rows: list) -> tuple:
    """Pack the leaf descriptors, `pos` (int32) and every leaf's rows
    (checked by the caller) into one pinned host buffer and copy it to
    the leaves' card with one non-blocking copy on the current stream.
    Returns K5's arguments (staged buffer, L, m, pos offset)."""
    m, L = len(pos), len(dsts)
    dev = dsts[0].device
    # layout (csrc/rows_update.cu): descriptors, pos, then each leaf's
    # rows at a 16-byte boundary
    pos_off = _DESC_BYTES * L
    off = (pos_off + 4 * m + 15) & ~15
    src_offs = []
    for r in rows:
        src_offs.append(off)
        off = (off + r.nbytes + 15) & ~15
    buf = torch.empty(off, dtype=torch.uint8, pin_memory=True)
    hb = buf.numpy()
    desc = hb[:pos_off].view(np.uint64).reshape(L, 4)
    for k, (d, r, so) in enumerate(zip(dsts, rows, src_offs)):
        desc[k] = (d.data_ptr(), so, r.nbytes // m, d.shape[0])
        hb[so:so + r.nbytes] = r.reshape(-1).view(np.uint8)
    hb[pos_off:pos_off + 4 * m] = pos.view(np.uint8)
    staged = torch.empty(off, dtype=torch.uint8, device=dev)
    staged.copy_(buf, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    _inflight[:] = [(b, e) for b, e in _inflight if not e.query()]
    _inflight.append((buf, done))
    return staged, L, m, pos_off


def launch(staged: torch.Tensor, L: int, m: int, pos_off: int) -> None:
    """Launch K5 on the current stream over a buffer `stage` made."""
    if _lib is None:
        build()
    rc = _lib.rows_update(staged.data_ptr(), L, m, pos_off,
                          torch.cuda.current_stream(
                              staged.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rows_update kernel launch failed: CUDA error "
                           f"{rc}")
    rows_update.launches += 1


rows_update.launches = 0


def rows_update_plain(dsts: list, pos: torch.Tensor, rows: list) -> None:
    """The same scatter in plain PyTorch: `index_copy_` per leaf, with
    `pos` and the rows already on the leaves' device."""
    idx = pos.long()
    for d, r in zip(dsts, rows):
        d.index_copy_(0, idx, r.view(d.dtype))
