"""K6: masked per-constraint counts of bit-packed verdicts.

Replaces the compute half of `make_audit_step` in
gatekeeper_tpu/parallel/collectives.py: each data shard's
`jnp.sum(fires & row_mask, axis=0, dtype=int32)` before the psum over
"data", taken here over PACKED verdict words. Input: packed[R, W] int32
(the int32 view of uint32; bit b of word w is constraint 32w+b), the
valid local row range [r_begin, r_end) (rows at or past the batch's true
count lie outside it), the true constraint count `c` (columns >= c are
C-bucket padding) and an int32 output out[C]. Output: out[j] = the number
of rows in the range whose bit j is set, for j < min(c, C, 32W), and 0
past it; with `accumulate` the counts add into out instead, so that the
shards one card holds sum into one tensor with no extra launch. The
signature mirrors K1's (pair_compact).

The kernel is CUDA C++ for sm_90a (csrc/shard_counts.cu), built with nvcc
at first use and bound with ctypes: one launch over (row tile, word tile)
blocks, per-column counts in registers and shared memory, one atomic add
per column per block. It is bound by bytes (the words read once). The
psum's cross-card half is a collective, not a kernel: the caller sums the
per-card partials (parallel/collectives.py). `shard_counts_plain` is the
same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LOAD_LOCK, build_so, count_launch

_lib = None

THREADS = 256       # the kernel's block size
WORD_TILE = 32      # words per block (csrc kWordTile)
MAX_TILES = 264     # row tiles per call: two blocks per SM of an H100


def build() -> str:
    """Build (or reuse) and load the library; returns nvcc's ptxas report
    (empty when the library was already built)."""
    global _lib
    path, report = build_so("shard_counts")
    with LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(path)
            fn = lib.shard_counts
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [
                ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return report


def tiling(rows: int) -> tuple[int, int]:
    """(rows per tile, tiles) for `rows` valid rows: tiles of at least
    THREADS rows, at most MAX_TILES of them."""
    rows = max(rows, 1)
    tiles = min(MAX_TILES, -(-rows // THREADS))
    per = -(-rows // tiles)
    return per, -(-rows // per)


def shard_counts(packed: torch.Tensor, r_begin: int, r_end: int, c: int,
                 out: torch.Tensor, accumulate: bool = False
                 ) -> torch.Tensor:
    """K6 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them). Returns `out`."""
    if packed.device.type == "cpu":
        return shard_counts_plain(packed, r_begin, r_end, c, out,
                                  accumulate)
    if packed.device.type != "cuda":
        raise ValueError(f"shard_counts: unsupported device {packed.device}")
    if packed.dtype != torch.int32 or packed.dim() != 2 or \
            not packed.is_contiguous():
        raise ValueError("shard_counts: packed must be contiguous int32 "
                         f"[R, W], got {packed.dtype} {tuple(packed.shape)}")
    if out.device != packed.device or out.dtype != torch.int32 or \
            out.dim() != 1 or not out.is_contiguous():
        raise ValueError("shard_counts: out must be contiguous int32 [C] "
                         f"on {packed.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    R, W = packed.shape
    lo, hi = max(0, int(r_begin)), min(R, int(r_end))
    cc = min(int(c), 32 * W, out.shape[0])
    if hi <= lo or cc <= 0:
        # nothing to count: no launch
        if not accumulate:
            out.zero_()
        return out
    if _lib is None:
        build()
    per, tiles = tiling(hi)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = _lib.shard_counts(packed.data_ptr(), int(R), int(W), lo, hi,
                           int(c), int(out.shape[0]), per, tiles,
                           int(bool(accumulate)), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"shard_counts kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(shard_counts)
    return out


shard_counts.launches = 0


def shard_counts_plain(packed: torch.Tensor, r_begin: int, r_end: int,
                       c: int, out: torch.Tensor,
                       accumulate: bool = False) -> torch.Tensor:
    """The same counts in plain PyTorch. Bits unpack in int64: torch has
    no shifts on uint32 on the CPU."""
    dev = packed.device
    R, W = packed.shape
    C = out.shape[0]
    words = packed.to(torch.int64) & 0xFFFFFFFF
    rows = torch.arange(R, device=dev)
    valid = (rows >= r_begin) & (rows < r_end)
    words = torch.where(valid[:, None], words, torch.zeros_like(words))
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(R, 32 * W)
    bits = bits * (torch.arange(32 * W, device=dev) < c)[None, :]
    counts = bits.sum(0).to(torch.int32)
    k = min(C, 32 * W)
    if not accumulate:
        out.zero_()
    out[:k] += counts[:k]
    return out
