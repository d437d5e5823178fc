"""K4: inventory-join membership -> fires[N] bool.

Replaces the join membership program of gatekeeper_tpu/ir/join.py
(`JoinCompiled._jit_wrapper`'s `run`, fed by `_fires_device`). Inputs,
int32, padded as ir/join.py's `pad_inventory` and `pad_reviews` make
them: sorted unique key ids u_p[Kb] (INT32_MAX padding), holder counts
cnt_p[Kb], per-identity-group single-holder ids sik_p[G, Kb], review keys
karr[N, H] (`key_pad` padding) and review identity ids iks[N, G]. Review
n fires when one of its keys is found at its left insertion point
(clipped to Kb - 1) and is held by two or more objects, or by one that
is not the review's own copy under any identity group.

The kernel is CUDA C++ for sm_90a (csrc/join_member.cu), built with nvcc
at first use and bound with ctypes: one thread per review, a two-level
search per key, first over the fences (`join_fences`: every LINE-th key
of u_p, in shared memory), then in the one line of LINE keys of u_p that
the fences name. `join_member_plain` is the same function in plain PyTorch;
only it calls `torch.searchsorted`.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LOAD_LOCK, build_so, count_launch

_lib = None
# int32 keys a fence covers, the line the search ends in: 4, 8, 16 or 32
# (16 measured fastest at the general audit's shape: `chip_smoke.py
# --kernels K4 --tune` sets it by assignment)
LINE = 16
LINES = (4, 8, 16, 32)
# fences staged in a block's shared memory (16 KB); past LINE x this many
# keys, a fence heads a longer segment, halved in u_p down to 32 keys
MAX_FENCES = 4096


def build() -> str:
    """Build (or reuse) and load the library; returns nvcc's ptxas report
    (empty when the library was already built)."""
    global _lib
    path, report = build_so("join_member")
    with LOAD_LOCK:
        if _lib is None:
            lib = ctypes.CDLL(path)
            fn = lib.join_member
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
    return report


def fence_count(kb: int) -> int:
    """Fences for a key table of Kb keys: Kb when Kb <= LINE, else
    min(Kb / LINE, MAX_FENCES)."""
    if LINE not in LINES:
        raise ValueError(f"join_member: LINE {LINE} is not one of {LINES}")
    return kb if kb <= LINE else min(kb // LINE, MAX_FENCES)


def join_fences(u_p: torch.Tensor) -> torch.Tensor:
    """K4's fences for a padded key table u_p[Kb] (Kb a power of two):
    the first key of every segment of Kb / fence_count(Kb) keys (u_p
    itself when Kb <= LINE). Built once per inventory upload (ir/join.py
    caches them beside u_p)."""
    kb = u_p.shape[0]
    nf = fence_count(kb)
    return u_p if nf == kb else u_p[::kb // nf].contiguous()


def _check(u_p, cnt_p, sik_p, karr, iks, fences) -> None:
    dev = u_p.device
    for name, t, dim in (("u_p", u_p, 1), ("cnt_p", cnt_p, 1),
                         ("sik_p", sik_p, 2), ("karr", karr, 2),
                         ("iks", iks, 2), ("fences", fences, 1)):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != dim or \
                not t.is_contiguous():
            raise ValueError(
                f"join_member: {name} must be a contiguous int32 tensor of "
                f"{dim} dims on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    kb = u_p.shape[0]
    G = sik_p.shape[0]
    if kb < 1 or kb & (kb - 1) or cnt_p.shape[0] != kb or \
            sik_p.shape[1] != kb or iks.shape != (karr.shape[0], G):
        raise ValueError(
            f"join_member: shapes disagree (Kb must be a power of two): u_p "
            f"{tuple(u_p.shape)}, cnt_p {tuple(cnt_p.shape)}, sik_p "
            f"{tuple(sik_p.shape)}, karr {tuple(karr.shape)}, iks "
            f"{tuple(iks.shape)}")
    if fences.shape[0] != fence_count(kb) or u_p.data_ptr() % 16 or \
            fences.data_ptr() % 16:
        raise ValueError(
            f"join_member: fences {tuple(fences.shape)} are not "
            f"join_fences of u_p {tuple(u_p.shape)} on 16-byte boundaries")


def join_member(u_p: torch.Tensor, cnt_p: torch.Tensor, sik_p: torch.Tensor,
                karr: torch.Tensor, iks: torch.Tensor, key_pad: int,
                fences: torch.Tensor | None = None) -> torch.Tensor:
    """K4 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors (no fallback between them). `fences` are
    `join_fences(u_p)`, built here when not given."""
    if u_p.device.type == "cpu":
        return join_member_plain(u_p, cnt_p, sik_p, karr, iks, key_pad)
    if u_p.device.type != "cuda":
        raise ValueError(f"join_member: unsupported device {u_p.device}")
    if fences is None:
        fences = join_fences(u_p)
    _check(u_p, cnt_p, sik_p, karr, iks, fences)
    N, H = karr.shape
    kb = u_p.shape[0]
    G = sik_p.shape[0]
    fires = torch.empty((N,), dtype=torch.bool, device=u_p.device)
    if N == 0:
        return fires
    if _lib is None:
        build()
    stream = torch.cuda.current_stream(u_p.device).cuda_stream
    rc = _lib.join_member(u_p.data_ptr(), cnt_p.data_ptr(),
                          sik_p.data_ptr(), karr.data_ptr(), iks.data_ptr(),
                          fences.data_ptr(), int(N), int(H), int(kb), int(G),
                          int(fences.shape[0]), int(key_pad),
                          fires.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"join_member kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(join_member)
    return fires


join_member.launches = 0


def join_member_plain(u_p: torch.Tensor, cnt_p: torch.Tensor,
                      sik_p: torch.Tensor, karr: torch.Tensor,
                      iks: torch.Tensor, key_pad: int) -> torch.Tensor:
    """The JAX program in plain PyTorch: a left searchsorted, the clip,
    gathers, and `any` over the identity groups and over H."""
    pos = torch.searchsorted(u_p, karr).clamp(max=u_p.shape[0] - 1)
    found = (u_p[pos] == karr) & (karr != key_pad)
    # identical under SOME identity group blocks the fire; sik_p is
    # [G, Kb], iks is [N, G]
    ident_any = (sik_p[:, pos] == iks.T[:, :, None]).any(dim=0)
    fire = found & ((cnt_p[pos] >= 2) | ~ident_any)
    return fire.any(dim=1)
