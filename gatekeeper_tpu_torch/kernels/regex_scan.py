"""K3: P regex DFAs x V vocab strings -> matched[P, V] bool.

Replaces `scan_device` in gatekeeper_tpu/ops/regex_nfa.py (its jitted
`run`). Inputs, as ops/regex_nfa.py's `scan_prep` and `scan_tables` make
them:
  buf uint8, the strings back to back (NUL-free), zero-padded to a
    multiple of 16 bytes; offsets int32 [V+1], string v is
    buf[offsets[v]:offsets[v+1]], at most MAX_LEN bytes (the kernel
    traps on a block whose strings overflow SPAN_CAP; scan_device checks
    the lengths on the host);
  blob uint8, every pattern's compressed tables, each part 16-byte
    aligned: a byte -> class map cls[256], next states uint16 [S,
    n_classes], accept_end uint8 [S];
  pdesc int32 [P, 6]: (part offset within its group's bytes, n_classes,
    S, start, sink, dead); dead is -1 when the DFA has none;
  gdesc int32 [G, 4]: (first pattern, patterns, blob offset, bytes) of
    each group of consecutive patterns (`pack_tables`: as many as fit a
    block's shared memory, fewer when there are few strings for the
    card's SMs);
  table_smem: the largest group's bytes that a block stages in shared
    memory; a group larger than that is read from global memory.
Each string walks each DFA one byte at a time; the walk stops at the
string's end, at the absorbing match sink or at the dead state (both
absorb every byte); the string matches when its final state is the sink
or accepts at the end of the string.

The kernel is CUDA C++ for sm_90a (csrc/regex_scan.cu), built with nvcc
at first use and bound with ctypes; see the source for its design.
`regex_scan_plain` walks the same inputs the JAX program's way, one
gather a step over the whole [P, V] state sheet, freezing each string's
state past its end.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .build import LOAD_LOCK, build_so, count_launch

THREADS = 256  # strings per block (csrc/regex_scan.cu kThreads)
MAX_LEN = 128  # longest string the kernel takes (kMaxLen)
# one block's string bytes, both ends cut at 16-byte lines (kSpanCap):
# 256 strings of at most MAX_LEN bytes always fit
SPAN_CAP = THREADS * MAX_LEN + 32
# compressed-table bytes one block stages for its group of patterns. Every
# block stages its group again, so a group costs its bytes once per 256
# strings: 8 KB is 32 bytes a string, about one string's own bytes. A
# pattern larger than this alone forms a group read from global memory.
GROUP_TABLE_BYTES = 8192
# blocks the grid should have at least on each of the card's SMs
# (`sm_count`). A thread walks its group's patterns one after another, so
# with few strings a group holds fewer patterns and more walks run side
# by side
MIN_BLOCKS_PER_SM = 4
PDESC = 6  # int32 columns of pdesc
_ALIGN = 16

_lib = None


def build() -> str:
    """Build (or reuse) and load the library; returns nvcc's ptxas report
    (empty when the library was already built)."""
    global _lib
    path, report = build_so("regex_scan")
    with LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(path)
            fn = lib.regex_scan
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return report


def _round16(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def table_part(cls: np.ndarray, nxt: np.ndarray,
               accept_end: np.ndarray) -> np.ndarray:
    """One pattern's compressed tables as the kernel reads them: cls[256]
    uint8, then nxt [S, n_classes] uint16 (little-endian), then
    accept_end[S] uint8, zero-padded to a multiple of 16 bytes."""
    S, n_cls = nxt.shape
    size = 256 + 2 * S * n_cls + S
    part = np.zeros(_round16(size), dtype=np.uint8)
    part[:256] = cls
    part[256:256 + 2 * S * n_cls] = np.ascontiguousarray(
        nxt, dtype="<u2").view(np.uint8).reshape(-1)
    part[256 + 2 * S * n_cls:size] = accept_end
    return part


def sm_count(device) -> int:
    """The SMs of `device`'s card, which scale the group plan; 1 on the
    CPU, where the plain version does not read the plan."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def pack_tables(parts: list, heads: list, n_strings: int,
                n_sms: int) -> tuple:
    """-> (blob uint8, pdesc int32 [P, 6], gdesc int32 [G, 4], table_smem)
    from each pattern's `table_part` and its (n_classes, S, start, sink,
    dead), for a scan of n_strings strings on a card of n_sms SMs.
    Consecutive patterns share a group while their parts fit
    GROUP_TABLE_BYTES and the grid keeps MIN_BLOCKS_PER_SM blocks an SM;
    a part larger than GROUP_TABLE_BYTES forms a group alone, read from
    global memory. table_smem is the largest staged group's bytes (0 when
    no group is staged)."""
    P = len(parts)
    cap = max(1, P * -(-n_strings // THREADS)
              // (MIN_BLOCKS_PER_SM * n_sms))
    pdesc = np.zeros((P, PDESC), dtype=np.int32)
    groups: list[list[int]] = []  # [first, count, offset, bytes]
    at = 0
    for p, (part, head) in enumerate(zip(parts, heads)):
        g = groups[-1] if groups else None
        if g is None or g[1] >= cap or g[3] > GROUP_TABLE_BYTES or \
                g[3] + part.size > GROUP_TABLE_BYTES:
            g = [p, 0, at, 0]
            groups.append(g)
        pdesc[p] = (g[3],) + tuple(head)
        g[1] += 1
        g[3] += part.size
        at += part.size
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    if blob.size == 0:
        blob = np.zeros(_ALIGN, dtype=np.uint8)
    gdesc = np.asarray(groups, dtype=np.int32).reshape(-1, 4)
    staged = gdesc[gdesc[:, 3] <= GROUP_TABLE_BYTES, 3]
    return blob, pdesc, gdesc, int(staged.max()) if staged.size else 0


def _check(buf, offsets, blob, pdesc, gdesc, table_smem) -> None:
    dev = buf.device
    for name, t, dtype, dim in (("buf", buf, torch.uint8, 1),
                                ("offsets", offsets, torch.int32, 1),
                                ("blob", blob, torch.uint8, 1),
                                ("pdesc", pdesc, torch.int32, 2),
                                ("gdesc", gdesc, torch.int32, 2)):
        if t.device != dev or t.dtype != dtype or t.dim() != dim or \
                not t.is_contiguous():
            raise ValueError(
                f"regex_scan: {name} must be a contiguous {dtype} tensor of "
                f"{dim} dims on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if pdesc.shape[1] != PDESC or gdesc.shape[1] != 4 or \
            offsets.shape[0] < 1:
        raise ValueError(
            f"regex_scan: shapes disagree: pdesc {tuple(pdesc.shape)}, "
            f"gdesc {tuple(gdesc.shape)}, offsets {tuple(offsets.shape)}")
    if buf.shape[0] % _ALIGN or blob.shape[0] % _ALIGN or \
            table_smem % _ALIGN or not 0 <= table_smem <= GROUP_TABLE_BYTES:
        raise ValueError(
            f"regex_scan: buf ({buf.shape[0]} B), blob ({blob.shape[0]} B) "
            f"and table_smem ({table_smem}) must be multiples of 16, "
            f"table_smem at most {GROUP_TABLE_BYTES}")


def regex_scan(buf: torch.Tensor, offsets: torch.Tensor, blob: torch.Tensor,
               pdesc: torch.Tensor, gdesc: torch.Tensor,
               table_smem: int) -> torch.Tensor:
    """K3 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them)."""
    if buf.device.type == "cpu":
        return regex_scan_plain(buf, offsets, blob, pdesc, gdesc,
                                table_smem)
    if buf.device.type != "cuda":
        raise ValueError(f"regex_scan: unsupported device {buf.device}")
    _check(buf, offsets, blob, pdesc, gdesc, table_smem)
    if buf.data_ptr() % _ALIGN or blob.data_ptr() % _ALIGN:
        raise ValueError("regex_scan: buf and blob must be 16-byte aligned")
    P, V, G = pdesc.shape[0], offsets.shape[0] - 1, gdesc.shape[0]
    if G > 65535:
        raise ValueError(f"regex_scan: {G} pattern groups (at most 65535)")
    out = torch.empty((P, V), dtype=torch.bool, device=buf.device)
    if P == 0 or V == 0:
        return out
    if _lib is None:
        build()
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    rc = _lib.regex_scan(buf.data_ptr(), offsets.data_ptr(), int(V),
                         blob.data_ptr(), pdesc.data_ptr(),
                         gdesc.data_ptr(), int(P), int(G), int(table_smem),
                         out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"regex_scan kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(regex_scan)
    return out


regex_scan.launches = 0


def regex_scan_plain(buf: torch.Tensor, offsets: torch.Tensor,
                     blob: torch.Tensor, pdesc: torch.Tensor,
                     gdesc: torch.Tensor, table_smem: int = 0
                     ) -> torch.Tensor:
    """The same scan in plain PyTorch, as the JAX program runs it: the
    whole [P, V] state sheet takes one gather per byte step (class, then
    next state), and a string's state freezes past its end. table_smem
    only says where the kernel reads the tables from; the result does not
    depend on it."""
    dev = buf.device
    P, V = pdesc.shape[0], offsets.shape[0] - 1
    if P == 0 or V == 0:
        return torch.zeros((P, V), dtype=torch.bool, device=dev)
    # each pattern's part: its group's blob offset + its offset within
    group = torch.repeat_interleave(
        torch.arange(gdesc.shape[0], device=dev), gdesc[:, 1].long())
    pd = pdesc.long()
    part = (gdesc[group, 2].long() + pd[:, 0])[:, None]
    n_cls, S = pd[:, 1:2], pd[:, 2:3]
    nxt_at = part + 256
    acc_at = nxt_at + 2 * S * n_cls
    sink = pd[:, 4:5]
    b = blob.long()
    start = offsets[:-1].long()
    lens = offsets[1:].long() - start
    state = pd[:, 3:4].expand(P, V)
    for t in range(int(lens.max())):
        live = (t < lens)[None, :]
        byte = b.new_zeros(V)
        byte[live[0]] = buf[start[live[0]] + t].long()
        cls = b[part + byte[None, :]]
        at = nxt_at + 2 * (state * n_cls + cls)
        nxt = b[at] | (b[at + 1] << 8)
        state = torch.where(live, nxt, state)
    return (state == sink) | (b[acc_at + state] != 0)
