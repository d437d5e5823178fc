"""K3: P stacked regex DFAs x V vocab strings -> matched[P, V] bool.

Replaces `scan_device` in gatekeeper_tpu/ops/regex_nfa.py (its jitted
`run`). Inputs, as ops/regex_nfa.py's `stack_dfas` and `trim_bytes` make
them: table[P, S, 256] int32 next-state ids, accept_end[P, S] bool,
start[P] int32, matched_id[P] int32 (the absorbing match sink) and the
NUL-padded byte matrix bytes[V, L] uint8 with L a multiple of 16. Each
string walks its pattern's DFA one byte at a time; its state freezes at
the first NUL; it matches when the final state is the sink or accepts at
the end of the string.

The kernel is CUDA C++ for sm_90a (csrc/regex_scan.cu), built with nvcc
at first use and bound with ctypes. A sequential walk per (pattern,
string) with one dependent table load per byte bounds it; see the source
for the design. `regex_scan_plain` is the JAX program step by step in
plain PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from .build import build_so

_lib = None


def build() -> str:
    """Build (or reuse) and load the library; returns nvcc's ptxas report
    (empty when the library was already built)."""
    global _lib
    path, report = build_so("regex_scan")
    if _lib is None:
        lib = ctypes.CDLL(path)
        fn = lib.regex_scan
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return report


def _check(table, accept_end, start, matched_id, bmat) -> None:
    dev = table.device
    for name, t, dtype, dim in (("table", table, torch.int32, 3),
                                ("accept_end", accept_end, torch.bool, 2),
                                ("start", start, torch.int32, 1),
                                ("matched_id", matched_id, torch.int32, 1),
                                ("bytes", bmat, torch.uint8, 2)):
        if t.device != dev or t.dtype != dtype or t.dim() != dim or \
                not t.is_contiguous():
            raise ValueError(
                f"regex_scan: {name} must be a contiguous {dtype} tensor of "
                f"{dim} dims on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    P, S, width = table.shape
    if width != 256 or tuple(accept_end.shape) != (P, S) or \
            start.shape[0] != P or matched_id.shape[0] != P:
        raise ValueError(
            f"regex_scan: shapes disagree: table {tuple(table.shape)}, "
            f"accept_end {tuple(accept_end.shape)}, start "
            f"{tuple(start.shape)}, matched_id {tuple(matched_id.shape)}")
    if bmat.shape[1] % 16:
        raise ValueError(f"regex_scan: bytes width {bmat.shape[1]} is not "
                         "a multiple of 16")


def regex_scan(table: torch.Tensor, accept_end: torch.Tensor,
               start: torch.Tensor, matched_id: torch.Tensor,
               bmat: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    if table.device.type == "cpu":
        return regex_scan_plain(table, accept_end, start, matched_id, bmat)
    if table.device.type != "cuda":
        raise ValueError(f"regex_scan: unsupported device {table.device}")
    _check(table, accept_end, start, matched_id, bmat)
    if bmat.data_ptr() % 16:
        raise ValueError("regex_scan: bytes must be 16-byte aligned")
    P, S, _ = table.shape
    V, L = bmat.shape
    out = torch.empty((P, V), dtype=torch.bool, device=table.device)
    if P == 0 or V == 0:
        return out
    if _lib is None:
        build()
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = _lib.regex_scan(table.data_ptr(), accept_end.data_ptr(),
                         start.data_ptr(), matched_id.data_ptr(),
                         bmat.data_ptr(), int(P), int(S), int(V), int(L),
                         out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"regex_scan kernel launch failed: CUDA error "
                           f"{rc}")
    regex_scan.launches += 1
    return out


regex_scan.launches = 0


def regex_scan_plain(table: torch.Tensor, accept_end: torch.Tensor,
                     start: torch.Tensor, matched_id: torch.Tensor,
                     bmat: torch.Tensor) -> torch.Tensor:
    """The same scan in plain PyTorch, as the JAX program runs it: the
    whole [P, V] state sheet takes one flat gather per byte step, and a
    NUL byte leaves the state where it is."""
    P, S, _ = table.shape
    V, L = bmat.shape
    dev = table.device
    flat = table.reshape(-1)
    p_base = (torch.arange(P, device=dev, dtype=torch.int64) * S)[:, None]
    state = start.to(torch.int64)[:, None].expand(P, V)
    for t in range(L):
        byte = bmat[:, t].to(torch.int64)
        nxt = flat[(p_base + state) * 256 + byte[None, :]].to(torch.int64)
        state = torch.where((byte != 0)[None, :], nxt, state)
    matched = state == matched_id.to(torch.int64)[:, None]
    return matched | accept_end.reshape(-1)[p_base + state]
