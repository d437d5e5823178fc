"""K6: the audit step's per-shard epilogue, one launch.

Replaces what `make_audit_step` in gatekeeper_tpu/parallel/collectives.py
does on each data shard after eval_fn (its `local`): the verdicts masked
to the valid rows, kept as the step's fires, and their column sums
(`jnp.sum(fires, axis=0, dtype=int32)`) before the psum over "data";
taken here over PACKED verdict words. Input: packed[R, W] int32 (the
int32 view of uint32; bit b of word w is constraint 32w+b), the valid
local row range [r_begin, r_end) (rows at or past the batch's true count
lie outside it), the true constraint count `c` (columns >= c are C-bucket
padding), a bool destination fires[R, F] (F <= 32W; any row stride, unit
column stride: a shard's block of the step's [N, C] fires, written in
place) and an int32 out[C]. Output: fires[r, j] = bit j of row r if r is
in the range and j < c, else False, for every r < R and j < F; and
out[j] += the number of rows in the range whose bit j is set, for
j < min(c, C, 32W). The counts only add: the caller zeroes each device's
partial once a step, and the shards one card holds sum into it.

The kernel is CUDA C++ for sm_90a (csrc/shard_counts.cu), built with nvcc
at first use and bound with ctypes: one launch over (row tile, word tile)
blocks; each block stages its rows' words in shared memory, counts
columns by a 32x32 bit transpose in registers, and writes the block's
bytes with 16-byte stores (then, in a pass of their own, the bytes a
row's first and last columns cut off a chunk), then adds each nonzero
column count to out with one atomic. It is bound by bytes (the words
read once, the bool block written once). The psum's cross-card half is
a collective, not a kernel: the caller sums the per-card partials
(parallel/collectives.py).
`shard_counts_plain` is the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LOAD_LOCK, build_so, count_launch

_lib = None

THREADS = 256       # the kernel's block size
WORD_TILE = 32      # words per block (csrc kWordTile)
SUB_ROWS = 32       # rows a block stages at a time (csrc kSubRows)
MAX_TILES = 2112    # row tiles per call: sixteen blocks per SM of an H100


def build() -> str:
    """Build (or reuse) and load the library; returns nvcc's ptxas report
    (empty when the library was already built)."""
    global _lib
    path, report = build_so("shard_counts")
    with LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(path)
            fn = lib.shard_counts
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return report


def tiling(rows: int) -> tuple[int, int]:
    """(rows per tile, tiles) for `rows` rows: tiles of a multiple of
    SUB_ROWS rows, at most MAX_TILES of them."""
    rows = max(rows, 1)
    per = -(-rows // MAX_TILES)
    per = max(SUB_ROWS, -(-per // SUB_ROWS) * SUB_ROWS)
    return per, -(-rows // per)


def _check(packed: torch.Tensor, fires: torch.Tensor,
           out: torch.Tensor) -> None:
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise ValueError("shard_counts: packed must be int32 [R, W], got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    R, W = packed.shape
    if fires.dtype != torch.bool or fires.dim() != 2 or \
            fires.shape[0] != R or fires.shape[1] > 32 * W or \
            (fires.shape[1] > 1 and fires.stride(1) != 1):
        raise ValueError(f"shard_counts: fires must be bool [{R}, F <= "
                         f"{32 * W}] with unit column stride, got "
                         f"{fires.dtype} {tuple(fires.shape)} strides "
                         f"{fires.stride()}")
    if out.dtype != torch.int32 or out.dim() != 1:
        raise ValueError("shard_counts: out must be int32 [C], got "
                         f"{out.dtype} {tuple(out.shape)}")
    for t, what in ((fires, "fires"), (out, "out")):
        if t.device != packed.device:
            raise ValueError(f"shard_counts: {what} on {t.device}, packed "
                             f"on {packed.device}")


def shard_counts(packed: torch.Tensor, r_begin: int, r_end: int, c: int,
                 fires: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K6 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them). Writes `fires`, adds into
    `out` and returns `out`."""
    if packed.device.type == "cpu":
        return shard_counts_plain(packed, r_begin, r_end, c, fires, out)
    if packed.device.type != "cuda":
        raise ValueError(f"shard_counts: unsupported device {packed.device}")
    _check(packed, fires, out)
    if not packed.is_contiguous() or not out.is_contiguous():
        raise ValueError("shard_counts: packed and out must be contiguous")
    R, W = packed.shape
    if R == 0 or W == 0:
        return out  # nothing to write or count: no launch
    if _lib is None:
        build()
    per, tiles = tiling(R)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = _lib.shard_counts(packed.data_ptr(), int(R), int(W), int(r_begin),
                           int(r_end), int(c), fires.data_ptr(),
                           int(fires.stride(0)), int(fires.shape[1]),
                           out.data_ptr(), int(out.shape[0]), per, tiles,
                           stream)
    if rc != 0:
        raise RuntimeError(f"shard_counts kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(shard_counts)
    return out


shard_counts.launches = 0


def shard_counts_plain(packed: torch.Tensor, r_begin: int, r_end: int,
                       c: int, fires: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch. Bits unpack in int64: torch
    has no shifts on uint32 on the CPU."""
    _check(packed, fires, out)
    dev = packed.device
    R, W = packed.shape
    F, C = fires.shape[1], out.shape[0]
    words = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(R, 32 * W).bool()
    rows = torch.arange(R, device=dev)
    bits &= ((rows >= r_begin) & (rows < r_end))[:, None]
    bits &= (torch.arange(32 * W, device=dev) < c)[None, :]
    fires.copy_(bits[:, :F])
    k = min(int(c), C, 32 * W)
    if k > 0:
        out[:k] += bits[:, :k].sum(0, dtype=torch.int32)
    return out
