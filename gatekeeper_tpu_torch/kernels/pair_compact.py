"""K1: bit-packed verdicts -> row-major (row, constraint) pair block.

Replaces `_pair_expand` in gatekeeper_tpu/ir/evaljax.py (the tail of the
JAX package's `_pairs_jit` and `_slab_pairs_jit` programs). Input: verdict
words packed[R, W] (int32 view of uint32; bit b of word w is constraint
32w+b), the valid local row range [r_begin, r_end) (extraction padding
and slab overlap lie outside it), the global row offset `row0`, the true
constraint count `c` (columns >= c are C-bucket padding) and the capacity
`pcap`. Output: int32 [pcap+1, 2]; row 0 = (true pair count, 0) — the
count may exceed pcap, and the host then retries at a larger capacity —
and rows 1.. = (row0 + r, col) in row-major order, zero past the count.

The kernel is CUDA C++ for sm_90a (csrc/pair_compact.cu), built with nvcc
at first use and bound with ctypes: two launches over tiles of rows (tile
counts, then offsets and emission), no serial scan. It is bound by bytes:
it reads the verdict words and writes 8 bytes per pair; see the source for
the design. The wrapper allocates the tile-count scratch and raises on a
launch error. `pair_compact_plain` is the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LOAD_LOCK, build_so, count_launch

_lib = None

THREADS = 256      # rows per tile and pass (the kernel's block size)
MAX_TILES = 1024   # tiles per call: every emit block reads each count once


def build() -> str:
    """Build (or reuse) and load the library; returns nvcc's ptxas report
    (empty when the library was already built)."""
    global _lib
    path, report = build_so("pair_compact")
    with LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(path)
            fn = lib.pair_compact
            fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 10 + [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return report


def pair_compact(packed: torch.Tensor, r_begin: int, r_end: int, row0: int,
                 c: int, pcap: int) -> torch.Tensor:
    """K1 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    if packed.device.type == "cpu":
        return pair_compact_plain(packed, r_begin, r_end, row0, c, pcap)
    if packed.device.type != "cuda":
        raise ValueError(f"pair_compact: unsupported device {packed.device}")
    if packed.dtype != torch.int32 or packed.dim() != 2 or \
            not packed.is_contiguous():
        raise ValueError("pair_compact: packed must be contiguous int32 "
                         f"[R, W], got {packed.dtype} {tuple(packed.shape)}")
    if pcap < 1:
        raise ValueError(f"pair_compact: pcap must be >= 1, got {pcap}")
    if _lib is None:
        build()
    R, W = packed.shape
    rpt, tiles = tiling(R)
    vec4 = W % 4 == 0 and packed.data_ptr() % 16 == 0
    out = torch.empty((pcap + 1, 2), dtype=torch.int32, device=packed.device)
    scratch = torch.empty((tiles,), dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = _lib.pair_compact(packed.data_ptr(), int(R), int(W), int(r_begin),
                           int(r_end), int(row0), int(c), int(pcap), rpt,
                           tiles, int(vec4), scratch.data_ptr(),
                           out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pair_compact kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(pair_compact)
    return out


pair_compact.launches = 0
# kernel launches per pair_compact call (tile counts, then emission)
pair_compact.kernels_per_call = 2


def tiling(rows: int) -> tuple[int, int]:
    """(rows per thread, tiles) for `rows` rows: one row per thread per
    pass, as few passes as keep the tiles at most MAX_TILES."""
    rows = max(rows, 1)
    rpt = -(-rows // (THREADS * MAX_TILES))
    return rpt, -(-rows // (THREADS * rpt))


def pair_compact_plain(packed: torch.Tensor, r_begin: int, r_end: int,
                       row0: int, c: int, pcap: int) -> torch.Tensor:
    """The same block in plain PyTorch. Bits unpack in int64: torch has no
    shifts or nonzero on uint32 on the CPU."""
    dev = packed.device
    R, W = packed.shape
    w32 = W * 32
    words = packed.to(torch.int64) & 0xFFFFFFFF
    rows = torch.arange(R, device=dev)
    valid = (rows >= r_begin) & (rows < r_end)
    words = torch.where(valid[:, None], words, torch.zeros_like(words))
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    bits = ((words[:, :, None] >> shifts) & 1).reshape(R, w32).bool()
    bits &= (torch.arange(w32, device=dev) < c)[None, :]
    nz = torch.nonzero(bits)  # row-major
    count = int(nz.shape[0])
    out = torch.zeros((pcap + 1, 2), dtype=torch.int32, device=dev)
    out[0, 0] = count
    k = min(count, pcap)
    out[1:1 + k, 0] = (row0 + nz[:k, 0]).to(torch.int32)
    out[1:1 + k, 1] = nz[:k, 1].to(torch.int32)
    return out
