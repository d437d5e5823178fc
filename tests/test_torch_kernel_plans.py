"""The index arithmetic of K5 (csrc/rows_update.cu), K4
(csrc/join_member.cu), K3 (csrc/regex_scan.cu) and K6
(csrc/shard_counts.cu), on the CPU.

Both kernels run only on the card, but what they compute from is made in
Python here: K5's unit plan and staged buffer (`kernels/rows_update.py`
`unit_plan`, `pack`) and K4's fences (`kernels/join_member.py`
`join_fences`). Each test walks that plan the way the kernel's threads
do, written out in Python below, and holds the result exactly against the
plain version: K5's bytes against `rows_update_plain` (and so against the
JAX package's `.at[].set`, tests/test_torch_rows_update.py), K4's
insertion points against `torch.searchsorted(..., side="left")` with the
clip, and K4's fires against `join_member_plain` on the join test's cases
(which tests/test_torch_join.py holds against the JAX program). K3's
blocks stage their group's tables and their strings' byte span as
`walk_blocks` does, against `regex_scan_plain` and `re.search` (which
tests/test_torch_regex.py holds against the JAX package's scan_device).
K6's blocks (`walk_k6`: the staged tile, the warp's 32x32 bit transpose
by shuffle rounds, and the 16-byte chunks of each row's destination at
any byte offset, into a poisoned byte buffer that counts writes) against
`shard_counts_plain` (which tests/test_torch_kernels.py holds against
the JAX package's audit step).
"""

import re
import zlib

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch.ir import join as tjoin
from gatekeeper_tpu_torch.ir.carry import to_tensor, tree_from_numpy
from gatekeeper_tpu_torch.kernels import join_member as k4
from gatekeeper_tpu_torch.kernels import regex_scan as k3
from gatekeeper_tpu_torch.kernels import rows_update as k5
from gatekeeper_tpu_torch.kernels import shard_counts as k6
from gatekeeper_tpu_torch.ops import regex_nfa

from .test_torch_join import K4_CASES, k4_case
from .torch_kernel_cases import (
    H100_SMS,
    HARD_PATTERNS,
    K3_BIG_PATTERNS,
    K5_DTYPES,
    K5_MS,
    K5_N,
    K5_SHAPES,
    big_vocab,
    hard_vocab,
    k4_synthetic,
    k5_case,
    k5_random,
)

INT32_MAX = np.iinfo(np.int32).max


# ------------------------------------------------------------------ K5


def walk_units(buf: np.ndarray, meta: tuple, dsts: list) -> int:
    """csrc/rows_update.cu's threads over a packed buffer, in Python: for
    each unit u, the leaf by the kernel's branchless search over the
    prefix, then (row, chunk) by division, then w bytes copied from the
    staged rows into the leaf at its descriptor's address. Writes into
    the CPU tensors `dsts` (whose addresses the descriptors hold), and
    checks every address against the leaf's bytes and the unit width's
    alignment. Returns the number of units walked."""
    L, table_bytes, desc_off, pos_off, U = meta
    assert table_bytes % 16 == 0 and desc_off % 8 == 0
    assert pos_off == table_bytes and len(buf) % 16 == 0
    prefix = buf[:4 * (L + 1)].view(np.uint32).astype(np.int64)
    desc = buf[desc_off:desc_off + k5._DESC.itemsize * L].view(k5._DESC)
    pos = buf[pos_off:].view(np.int32)
    assert prefix[0] == 0 and prefix[L] == U
    leaf_bytes = [d.view(-1).view(torch.uint8).numpy() for d in dsts]
    for u in range(U):
        l, n = 0, L
        while n > 1:
            half = n >> 1
            l = l + half if prefix[l + half] <= u else l
            n -= half
        d = desc[l]
        w, c = int(d["w"]), int(d["c"])
        assert int(d["dst"]) == dsts[l].data_ptr()
        local = u - int(prefix[l])
        i, k = divmod(local, c)
        src = int(d["src"]) + local * w
        off = (int(pos[i]) * c + k) * w
        assert src % w == 0 and (int(d["dst"]) + off) % w == 0
        assert 0 <= off and off + w <= leaf_bytes[l].size
        assert src + w <= len(buf)
        leaf_bytes[l][off:off + w] = buf[src:src + w]
    return U


def _patch_both(dsts: list, pos: np.ndarray, rows: list) -> None:
    """Patch `dsts` through pack + walk_units, and copies of them through
    rows_update_plain; equal byte for byte."""
    want = [d.clone() for d in dsts]
    rows = [k5._host_rows(r) for r in rows]
    k5._check(dsts, pos, rows)
    buf, meta = k5.pack(dsts, pos, rows, pin=False)
    assert walk_units(buf.numpy(), meta, dsts) == meta[4]
    k5.rows_update_plain(want, torch.from_numpy(pos),
                         [torch.from_numpy(r) for r in rows])
    for d, t in zip(dsts, want):
        assert d.view(-1).view(torch.uint8).numpy().tobytes() == \
            t.view(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("m", K5_MS)
@pytest.mark.parametrize("shape", K5_SHAPES)
@pytest.mark.parametrize("dtype", K5_DTYPES)
def test_k5_unit_walk_equals_plain(dtype, shape, m):
    dst, pos, new = k5_case(dtype, shape, m,
                            zlib.crc32(repr((dtype, shape, m)).encode()))
    _patch_both([to_tensor(dst, "cpu")], pos, [new])


def _odd_leaves(rng, n: int) -> list:
    """Leaves of row sizes 3, 5, 12 and 20 bytes, 1..64-byte rows of each
    dtype, and a 16-byte-row leaf whose base is only 4-byte aligned."""
    out = [torch.from_numpy(k5_random(rng, (n,) + s, d)) for d, s in (
        ("int8", (3,)), ("int8", (5,)), ("int32", (3,)), ("int32", (5,)),
        ("int8", (1,)), ("int8", (2,)), ("float32", (2,)), ("int32", (4,)),
        ("float32", (4, 4)), ("int8", (7, 3)))]
    whole = torch.from_numpy(k5_random(rng, (n * 4 + 1,), "int32"))
    assert whole.data_ptr() % 16 == 0
    out.append(whole[1:].view(n, 4))  # base 4 bytes past a 16-byte one
    return out


def test_k5_unit_plan_widths_and_prefix():
    rng = np.random.default_rng(3)
    dsts = _odd_leaves(rng, K5_N)
    base = np.array([d.data_ptr() for d in dsts], dtype=np.uint64)
    row_bytes = np.array([d[0].numel() * d.element_size() for d in dsts],
                         dtype=np.uint64)
    assert sorted(set(row_bytes.tolist())) == [1, 2, 3, 5, 8, 12, 16, 20,
                                               21, 64]
    w, c, prefix = k5.unit_plan(base, row_bytes, 7)
    for k in range(len(dsts)):
        wk = int(w[k])
        assert wk in (1, 2, 4, 8, 16)
        assert int(row_bytes[k]) % wk == 0 and int(base[k]) % wk == 0
        # the widest: twice the width would not divide both, or is 32
        assert wk == 16 or int(row_bytes[k]) % (2 * wk) or \
            int(base[k]) % (2 * wk)
        assert int(c[k]) * wk == int(row_bytes[k])
    assert w[-1] == 4 and row_bytes[-1] == 16  # the 4-byte-aligned leaf
    assert w.tolist()[:4] == [1, 1, 4, 4] and w[-3] == 16
    assert prefix.tolist() == [0] + np.cumsum(7 * c).tolist()


@pytest.mark.parametrize("m", [1, 5, "3p", K5_N])
def test_k5_unit_walk_odd_rows_and_alignment(m):
    rng = np.random.default_rng(11)
    dsts = _odd_leaves(rng, K5_N)
    if m == "3p":  # a repeated position with identical rows
        pos = np.array([4, 30, 9, 9], dtype=np.int32)
        rows = [k5_random(rng, (3,) + tuple(d.shape[1:]),
                          str(d.numpy().dtype))[[0, 1, 2, 2]]
                for d in dsts]
    else:
        pos = rng.permutation(K5_N)[:m].astype(np.int32)
        rows = [k5_random(rng, (m,) + tuple(d.shape[1:]),
                          str(d.numpy().dtype)) for d in dsts]
    _patch_both(dsts, pos, rows)


def test_k5_unit_walk_many_leaves_of_mixed_widths():
    """A few hundred leaves, empty rows among them, as one launch takes
    them; the leaf search crosses every prefix boundary."""
    rng = np.random.default_rng(17)
    kinds = [("int8", (1,)), ("int32", (1, 1)), ("float32", (2,)),
             ("int8", (3,)), ("int32", (0,)), ("int32", (4,)),
             ("int8", (2,)), ("float32", (5,))]
    dsts = [torch.from_numpy(k5_random(rng, (23,) + s, d))
            for d, s in (kinds[int(x)] for x in rng.integers(0, 8, 300))]
    pos = rng.permutation(23)[:9].astype(np.int32)
    rows = [k5_random(rng, (9,) + tuple(d.shape[1:]), str(d.numpy().dtype))
            for d in dsts]
    _patch_both(dsts, pos, rows)


def test_k5_leaf_limit():
    """MAX_LEAVES leaves plan and pack; one more is refused, by name."""
    dsts = [torch.zeros(4, dtype=torch.int8) for _ in range(k5.MAX_LEAVES)]
    pos = np.array([2], dtype=np.int32)
    rows = [np.full(1, k % 100, dtype=np.int8) for k in range(len(dsts))]
    buf, meta = k5.pack(dsts, pos, rows, pin=False)
    assert meta[1] <= 48 * 1024  # the table in shared memory
    k5.rows_update(dsts, pos, rows)
    assert [int(d[2]) for d in dsts] == [k % 100 for k in range(len(dsts))]
    with pytest.raises(ValueError, match="MAX_LEAVES"):
        k5.rows_update(dsts + dsts[:1], pos, rows + rows[:1])


# ------------------------------------------------------------------ K4


def lower_bound_fenced(u_p: torch.Tensor, fences: torch.Tensor,
                       keys: torch.Tensor) -> tuple:
    """csrc/join_member.cu's `lower_bound`, for every key at once: the
    branchless search over the fences, then the halving down to one line
    (the segment, at most 32 keys, as the launcher picks the kernel) and
    the count below the key there. Returns (the unclipped left insertion
    point, whether u_p holds the key there)."""
    kb, nf = u_p.shape[0], fences.shape[0]
    seg = kb // nf
    width = min(seg, 32)
    u, f, key = u_p.long(), fences.long(), keys.long()
    b = torch.zeros_like(key)
    half = nf >> 1
    while half:
        b = torch.where(f[b + half - 1] < key, b + half, b)
        half >>= 1
    j = b + (f[b] < key).long()
    if seg == 1:
        pos = j
        found = (j < nf) & (f[j.clamp(max=nf - 1)] == key)
    else:
        base = (j - 1).clamp(min=0) * seg
        n = seg
        while n > width:
            n >>= 1
            base = torch.where(u[base + n] < key, base + n, base)
        assert width >= 4 and bool((base % width == 0).all())
        line = u[base[:, None] + torch.arange(width)]
        below = (line < key[:, None]).sum(1)
        pos = base + below
        found = (line == key[:, None]).any(1) | (
            (below == width) & (pos < kb)
            & (u[pos.clamp(max=kb - 1)] == key))
    zero = j == 0
    pos = torch.where(zero, 0, pos)
    found = torch.where(zero, f[0] == key, found)
    return pos, found


def join_member_fenced(u_p, cnt_p, sik_p, karr, iks, key_pad, fences):
    """K4's whole function over lower_bound_fenced, as the kernel's
    threads compute it (a row's keys after its first firing key change
    nothing, so `any` over H stands for the kernel's early stop)."""
    N, H = karr.shape
    pos, found = lower_bound_fenced(u_p, fences, karr.reshape(-1))
    pos = pos.clamp(max=u_p.shape[0] - 1).reshape(N, H)
    found = found.reshape(N, H) & (karr != key_pad)
    ident = (sik_p[:, pos] == iks.T[:, :, None]).any(dim=0)
    return (found & ((cnt_p[pos] >= 2) | ~ident)).any(dim=1)


def _table(kb: int, seed: int) -> torch.Tensor:
    """u_p of Kb keys: n_u sorted unique even ids in [10, 10 + 8 Kb), the
    rest INT32_MAX padding (none when n_u = Kb)."""
    rng = np.random.default_rng(seed)
    n_u = kb if seed % 2 else int(rng.integers(kb // 2 + 1, kb + 1))
    u = np.sort(rng.choice(np.arange(10, 10 + 8 * kb, 2), n_u,
                           replace=False))
    u_p = tjoin.pad_inventory(u, np.ones(n_u, np.int32),
                              np.zeros((1, n_u), np.int64))[0]
    assert u_p.shape == (kb,)
    return torch.from_numpy(u_p)


def _probe_keys(u_p: torch.Tensor, fences: torch.Tensor, seed: int):
    """Keys below every entry, above every real one, equal to each fence
    and to random entries, between entries, inside the INT32_MAX padding,
    KEY_PAD and the int32 extremes."""
    rng = np.random.default_rng(seed)
    u = u_p.numpy().astype(np.int64)
    f = fences.numpy().astype(np.int64)
    real = u[u != INT32_MAX]
    picks = rng.choice(real, min(len(real), 4000))
    keys = np.concatenate([
        [0, 9, 10, real[0], real[-1], real[-1] + 1, real[-1] + 2,
         INT32_MAX, INT32_MAX - 1, tjoin.KEY_PAD, np.iinfo(np.int32).min],
        f, f + 1, f - 1, picks, picks + 1, picks - 1])
    return torch.from_numpy(keys.clip(np.iinfo(np.int32).min,
                                      INT32_MAX).astype(np.int32))


# every power-of-two Kb from 1 to 32,768, and two past LINE x MAX_FENCES
# for every LINE (segments longer than a line, halved down to 32 keys)
KB_EXPONENTS = list(range(16)) + [18, 20]


@pytest.mark.parametrize("line", k4.LINES)
@pytest.mark.parametrize("e", KB_EXPONENTS)
def test_k4_two_level_search_equals_searchsorted(monkeypatch, e, line):
    monkeypatch.setattr(k4, "LINE", line)
    kb = 1 << e
    for seed in (e, e + 1):
        u_p = _table(kb, seed)
        fences = k4.join_fences(u_p)
        nf = k4.fence_count(kb)
        assert fences.shape == (nf,) and fences.is_contiguous()
        assert torch.equal(fences, u_p[::kb // nf])
        assert kb // nf == (1 if kb <= line else
                            max(line, kb // k4.MAX_FENCES))
        keys = _probe_keys(u_p, fences, seed)
        pos, found = lower_bound_fenced(u_p, fences, keys)
        want = torch.searchsorted(u_p, keys)  # side="left"
        assert torch.equal(pos, want)
        clip = want.clamp(max=kb - 1)
        assert torch.equal(found, u_p[clip] == keys)
        assert bool(found.any())


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_fenced_function_equals_plain(case):
    arrs = tree_from_numpy(k4_case(*case), "cpu")
    fences = k4.join_fences(arrs[0])
    want = k4.join_member_plain(*arrs, tjoin.KEY_PAD)
    got = join_member_fenced(*arrs, tjoin.KEY_PAD, fences)
    assert torch.equal(got, want) and want.any() and not want.all()


@pytest.mark.parametrize("case", [(0, 4096, 2, 3001, 3),
                                  (1, 3000, 2, 777, 2),
                                  (2, 1, 1, 300, 1),
                                  (3, 16667, 1, 5000, 1)])
def test_k4_fenced_function_equals_plain_synthetic(case):
    """k4_synthetic's tables (chip_smoke.py's and the card tests'), at
    Kb = 4,096 and 32,768 past one line, and Kb = 1."""
    arrs = tree_from_numpy(k4_synthetic(*case), "cpu")
    fences = k4.join_fences(arrs[0])
    want = k4.join_member_plain(*arrs, tjoin.KEY_PAD)
    got = join_member_fenced(*arrs, tjoin.KEY_PAD, fences)
    assert torch.equal(got, want) and want.any()


@pytest.mark.parametrize("bad", ["kb_not_pow2", "fence_count",
                                 "fence_dtype", "line"])
def test_k4_check_rejects_what_the_kernel_cannot_take(monkeypatch, bad):
    u_p, cnt_p, sik_p, karr, iks = tree_from_numpy(
        k4_case(0, 13, 1, 37, 1), "cpu")
    fences = k4.join_fences(u_p)
    k4._check(u_p, cnt_p, sik_p, karr, iks, fences)
    if bad == "kb_not_pow2":
        u_p, cnt_p, sik_p = u_p[:15], cnt_p[:15], sik_p[:, :15].contiguous()
        fences = u_p
    elif bad == "fence_count":
        fences = u_p[::2].contiguous()
    elif bad == "fence_dtype":
        fences = fences.long()
    else:
        monkeypatch.setattr(k4, "LINE", 2)  # no kernel ends in 2 keys
    with pytest.raises(ValueError):
        k4._check(u_p, cnt_p, sik_p, karr, iks, fences)


# ------------------------------------------------------------------ K3


class _Staged:
    """Bytes a block reads: a view of shared memory [lo, hi) or of a
    global array, with every read checked against its bounds."""

    def __init__(self, arr: np.ndarray, lo: int, hi: int):
        self.arr, self.lo, self.hi = arr, lo, hi

    def __getitem__(self, i: int) -> int:
        assert self.lo <= self.lo + i < self.hi, (i, self.lo, self.hi)
        return int(self.arr[self.lo + i])

    def u16(self, i: int) -> int:
        return self[i] | self[i + 1] << 8


def walk_blocks(buf, offsets, blob, pdesc, gdesc, table_smem) -> tuple:
    """csrc/regex_scan.cu's blocks in Python: for each (string block,
    group), stage the group's tables (when they fit table_smem) and the
    block's byte span cut at 16-byte lines into a poisoned shared memory
    with 16-byte copies (a span over SPAN_CAP is the kernel's trap: an
    AssertionError here); then each thread walks its string against the
    group's patterns, two at a time and 4 bytes a round (their classes
    loaded first), stopping at the end, the sink or the dead state.
    Returns (out[P, V], counts of staged and global tables and of staged
    spans, spans seen)."""
    V, P = len(offsets) - 1, len(pdesc)
    out = np.full((P, V), 2, dtype=np.uint8)  # 2: never written
    seen = {"tables": 0, "global_tables": 0, "spans": 0,
            "span_sizes": set()}
    assert buf.size % 16 == 0 and table_smem % 16 == 0
    for g in range(len(gdesc)):
        p0, npat, toff, tlen = (int(x) for x in gdesc[g])
        tabs_staged = tlen <= table_smem
        for x in range((V + k3.THREADS - 1) // k3.THREADS):
            smem = np.full(table_smem + k3.SPAN_CAP, 0xA5, dtype=np.uint8)
            v0, v1 = x * k3.THREADS, min((x + 1) * k3.THREADS, V)
            base = int(offsets[v0]) & ~15
            span = ((int(offsets[v1]) + 15) & ~15) - base
            seen["span_sizes"].add(span)
            assert span <= k3.SPAN_CAP, "trap: a string over MAX_LEN"
            if tabs_staged:
                assert toff % 16 == 0 and tlen % 16 == 0
                for i in range(0, tlen, 16):
                    smem[i:i + 16] = blob[toff + i:toff + i + 16]
                tabs = _Staged(smem, 0, tlen)
                seen["tables"] += 1
            else:
                tabs = _Staged(blob, toff, toff + tlen)
                seen["global_tables"] += 1
            assert base + span <= buf.size
            for i in range(0, span, 16):
                at = table_smem + i
                smem[at:at + 16] = buf[base + i:base + i + 16]
            seen["spans"] += 1
            for v in range(v0, v1):
                b, n = int(offsets[v]), int(offsets[v + 1] - offsets[v])
                s = _Staged(smem, table_smem + b - base,
                            table_smem + b - base + n)
                for k in range(0, npat, 2):
                    walks = []
                    for p in range(p0 + k, min(p0 + k + 2, p0 + npat)):
                        off, ncls, S, start, sink, dead = (
                            int(c) for c in pdesc[p])
                        walks.append([p, off, ncls, S, start, sink, dead,
                                      n > 0 and start not in (sink, dead)])
                    # rounds of 4 bytes: classes first, then the steps
                    i = 0
                    while i < n and any(w[7] for w in walks):
                        cs = [s[i + j] if i + j < n else 0 for j in range(4)]
                        ks = [[tabs[w[1] + c] for c in cs] for w in walks]
                        for j in range(4):
                            if i + j >= n:
                                continue
                            for w, k in zip(walks, ks):
                                p, off, ncls, S, st, sink, dead, live = w
                                if live:
                                    assert st < S and k[j] < ncls
                                    st = tabs.u16(off + 256 + 2 * (
                                        st * ncls + k[j]))
                                    w[4], w[7] = st, st not in (sink, dead)
                        i += 4
                    for p, off, ncls, S, st, sink, dead, _live in walks:
                        acc = tabs[off + 256 + 2 * S * ncls + st]
                        out[p, v] = st == sink or acc != 0
    return out, seen


def _k3_inputs(dfas, buf, offsets, n_plan=None):
    blob, pdesc, gdesc, smem = regex_nfa.scan_tables(
        dfas, len(offsets) - 1 if n_plan is None else n_plan, H100_SMS)
    return buf, offsets, blob, pdesc, gdesc, smem


def _pack_strings(strings: list[str]) -> tuple:
    lens = np.array([len(s) for s in strings], dtype=np.int64)
    return regex_nfa._pack("".join(strings).encode(), lens)


@pytest.mark.parametrize("case", ["fit", "fit_grouped", "oversize",
                                  "span0", "span_full", "span_in_place"])
def test_k3_block_walk_equals_plain(case):
    """K3's blocks, walked in Python, give regex_scan_plain's answer and
    re.search's: groups that fit shared memory (the hard set), patterns
    whose tables alone exceed a group (read from global memory) and a
    group split by size, a block whose span is 0 bytes, a block of 256
    strings of 128 bytes (span 128 x 256 plus the line cuts); strings
    over 128 bytes, whose span exceeds SPAN_CAP, are refused: the
    block traps, and scan_device raises before the upload. fit_grouped plans the groups as for a million strings, so
    that each thread walks many patterns, two at a time."""
    pats, strings = HARD_PATTERNS, hard_vocab(5, 300)
    if case == "oversize":
        pats = HARD_PATTERNS[:4] + K3_BIG_PATTERNS + HARD_PATTERNS[4:8]
        strings = big_vocab(6, 300)
    elif case == "span0":
        strings = [""] * 256 + hard_vocab(7, 40)
    elif case == "span_full":
        strings = [""] * 255 + ["ab.c:"] + [
            ("ab" * 64, "a" * 128, "0123456789" * 13)[k % 3][:128]
            for k in range(256)] + ["end"]
    elif case == "span_in_place":
        strings = [("xy" * 70)[:129 + k % 3] for k in range(256)] + ["a"]
    dfas = [regex_nfa.try_compile_device(p) for p in pats]
    args = _k3_inputs(dfas, *_pack_strings(strings),
                      1 << 20 if case == "fit_grouped" else None)
    if case == "span_in_place":
        with pytest.raises(AssertionError, match="trap"):
            walk_blocks(*args)
        with pytest.raises(ValueError, match="over 128 bytes"):
            regex_nfa.scan_device(dfas, args[:2], "cpu")
        assert regex_nfa.scan_prep(strings) is None
        return
    got, seen = walk_blocks(*args)
    plain = k3.regex_scan_plain(*tree_from_numpy(args[:5], "cpu"), args[5])
    assert np.array_equal(got, plain.numpy().astype(np.uint8))
    want = np.array([[re.search(p, s) is not None for s in strings]
                     for p in pats])
    assert np.array_equal(got.astype(bool), want)
    assert want.any() and not want.all()
    if case == "fit":
        assert seen["tables"] and not seen["global_tables"]
        assert (args[4][:, 1] == 1).all()  # 300 strings: a pattern a group
    if case == "fit_grouped":
        assert len(args[4]) == 2 and args[4][:, 1].min() > 2
    if case == "oversize":
        assert seen["global_tables"] and seen["tables"]
        assert len(args[4]) >= 4  # hard, big alone, big, big + hard
    if case == "span0":
        assert 0 in seen["span_sizes"]
    if case == "span_full":
        assert max(seen["span_sizes"]) == 128 * 256 + 16


def test_k3_check_rejects_what_the_kernel_cannot_take():
    """The wrapper's checks: dtypes, shapes, 16-byte multiples and the
    shared-memory budget (CPU tensors pass them to the plain version, so
    _check is called directly)."""
    dfas = [regex_nfa.try_compile_device(p) for p in HARD_PATTERNS[:3]]
    good = list(tree_from_numpy(_k3_inputs(dfas, *_pack_strings(
        ["ab", "cd"]))[:5], "cpu"))
    k3._check(*good, 0)
    for i, bad in ((0, good[0][:-1]), (1, good[1].long()),
                   (3, good[3][:, :5]), (4, good[4].reshape(-1))):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            k3._check(*args, 0)
    for smem in (8, k3.GROUP_TABLE_BYTES + 16):
        with pytest.raises(ValueError):
            k3._check(*good, smem)


# ------------------------------------------------------------------ K6

_M32 = 0xFFFFFFFF
_K6_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def transpose32(xs: list) -> list:
    """csrc transpose32 over a warp: lane i holds row i's word; five
    rounds of __shfl_xor_sync; lane b ends with column b (bit i = row i)."""
    x = list(xs)
    for s, m in enumerate(_K6_MASKS):
        j = 16 >> s
        y = [x[lane ^ j] for lane in range(32)]
        x = [((x[l] & ~m & _M32) | ((y[l] & ~m & _M32) >> j)) if l & j
             else ((x[l] & m) | ((y[l] & m) << j)) & _M32
             for l in range(32)]
    return x


def _expand4(b: int) -> int:
    return ((b & 0xF) * 0x00204081) & 0x01010101


def walk_k6(words: np.ndarray, r_begin: int, r_end: int, c: int, F: int,
            ld: int, off: int, out: np.ndarray) -> tuple:
    """K6 as its blocks run it (csrc/shard_counts.cu), over uint32 words
    [R, W]: the destination is a byte buffer poisoned with 0xAA, row r's
    block starting at byte off + r * ld (any alignment), and a count of
    writes per byte. Adds the counts into out [C] (one atomic per nonzero
    column per block). Returns (buffer, writes per byte)."""
    R, W = words.shape
    C = out.shape[0]
    r_lo, r_hi = max(0, r_begin), min(R, r_end)
    cc = max(0, min(c, 32 * W))
    per, tiles = k6.tiling(R)
    size = off + R * ld + 32
    mem = np.full(size, 0xAA, np.uint8)
    writes = np.zeros(size, np.int64)
    # the buffer's first byte stands at a 16-byte-aligned address
    for bx in range(tiles):
        for by in range(-(-W // k6.WORD_TILE)):
            w0 = by * k6.WORD_TILE
            nw = min(k6.WORD_TILE, W - w0)
            col0, col1 = 32 * w0, min(F, 32 * w0 + 32 * nw)
            ncols = max(0, col1 - col0)
            nch = ncols // 16
            t0, t1 = bx * per, min(R, bx * per + per)
            cnt = {}
            for s0 in range(t0, t1, k6.SUB_ROWS):
                ns = min(k6.SUB_ROWS, t1 - s0)
                tile = np.zeros((ns, nw), np.int64)
                for r in range(ns):
                    row = s0 + r
                    if r_lo <= row < r_hi:
                        for w in range(nw):
                            lo = 32 * (w0 + w)
                            mask = _M32 if cc >= lo + 32 else (
                                0 if cc <= lo else (1 << (cc - lo)) - 1)
                            tile[r, w] = int(words[row, w0 + w]) & mask
                for wi in range(nw):  # warps take words
                    for g in range(0, ns, 32):
                        xs = [int(tile[g + l, wi]) if g + l < ns else 0
                              for l in range(32)]
                        if any(xs):
                            cols = transpose32(xs)
                            for b in range(32):
                                cnt[(wi, b)] = cnt.get((wi, b), 0) + \
                                    bin(cols[b]).count("1")
                # 1: the whole 16-byte chunks, r and k by the kernel's
                # float reciprocal
                inv = np.float32(1.0) / np.float32(nch) if nch else 0
                for i in range(ns * nch):
                    r = int((np.float32(i) + np.float32(0.5)) * inv)
                    k = i - r * nch
                    assert (r, k) == divmod(i, nch)
                    a = off + (s0 + r) * ld + col0
                    ru = (a + 15) & ~15
                    A = ru + 16 * k
                    if A + 16 > a + ncols:
                        continue
                    jl = A - a
                    wl, sh = jl >> 5, jl & 31
                    lo = int(tile[r, wl])
                    hi = int(tile[r, wl + 1]) if wl + 1 < nw else 0
                    bits = (((hi << 32) | lo) >> sh) & 0xFFFF
                    assert A % 16 == 0
                    vec = b"".join(
                        _expand4(bits >> (4 * q)).to_bytes(4, "little")
                        for q in range(4))
                    mem[A:A + 16] = np.frombuffer(vec, np.uint8)
                    writes[A:A + 16] += 1
                # 2: the bytes cut off at each end, two threads a row,
                # each in aligned stores of 8, 4, 2 or 1 bytes
                for i in range(ns * 2 if ncols > 0 else 0):
                    r = i >> 1
                    a = off + (s0 + r) * ld + col0
                    e = a + ncols
                    ru, rd = (a + 15) & ~15, e & ~15
                    B = max(rd, ru) if i & 1 else ru - 16
                    p, q = (B, e) if i & 1 else (a, min(ru, e))
                    if p >= q:
                        continue
                    jl = B - a
                    wl, sh = jl >> 5, jl & 31
                    lo = int(tile[r, wl]) if 0 <= wl < nw else 0
                    hi = int(tile[r, wl + 1]) if 0 <= wl + 1 < nw else 0
                    bits = (((hi << 32) | lo) >> sh) & 0xFFFF
                    chunk = b"".join(
                        _expand4(bits >> (4 * q_)).to_bytes(4, "little")
                        for q_ in range(4))
                    o, end = p - B, q - B
                    while o < end:
                        n = 1 if o & 1 else 2 if o & 2 else 4 if o & 4 \
                            else 8
                        while o + n > end:
                            n >>= 1
                        assert (B + o) % n == 0 and (o < 8) == (o + n <= 8)
                        mem[B + o:B + o + n] = np.frombuffer(
                            chunk[o:o + n], np.uint8)
                        writes[B + o:B + o + n] += 1
                        o += n
            for (wi, b), n in cnt.items():
                col = 32 * (w0 + wi) + b
                if col < min(cc, C) and n:
                    out[col] += n
    return mem, writes


# (rows, W, density, r_begin, r_end, c, F, ld extra, byte offset):
# unaligned offsets and row strides, F below 32W, r_end 0 and R, W past
# one block's 32 words, more rows than one tile
K6_WALK_CASES = [
    (64, 1, 0.3, 0, 64, 32, 32, 0, 0),
    (300, 2, 0.1, 17, 290, 45, 45, 7, 3),
    (257, 16, 0.05, 0, 200, 500, 500, 0, 0),
    (130, 16, 0.05, 0, 130, 250, 250, 250, 250),
    (40, 3, 0.5, 5, 40, 96, 96, 1, 15),
    (96, 2, 0.3, 0, 0, 50, 50, 13, 9),
    (161, 3, 0.2, 0, 161, 77, 70, 2, 1),
    (70, 40, 0.05, 0, 69, 1270, 1270, 9, 6),
]


@pytest.mark.parametrize("tiles", [None, 2])
@pytest.mark.parametrize("case", K6_WALK_CASES)
def test_k6_block_walk_equals_plain(monkeypatch, case, tiles):
    """walk_k6 writes every byte of each row's F destination bytes once
    and no byte outside them, equal to shard_counts_plain's block, and
    adds its counts; with `tiles` the row tiles are capped (MAX_TILES),
    so that a block walks more than one staged sub-tile."""
    rows, w, dens, rb, re_, c, F, extra, off = case
    if tiles is not None:
        monkeypatch.setattr(k6, "SUB_ROWS", 32)
        monkeypatch.setattr(k6, "MAX_TILES", tiles)
    ld = F + extra
    rng = np.random.default_rng(rows * w + c)
    bits = rng.random((rows, 32 * w)) < dens
    words = np.packbits(bits.reshape(rows, w, 32)[:, :, ::-1], axis=-1,
                        bitorder="big").view(">u4").reshape(rows, w)
    words = words.astype(np.uint32)
    C = max(c, 1)
    init = np.arange(C, dtype=np.int64) * 3 - 5
    out = init.copy()
    mem, writes = walk_k6(words, rb, re_, c, F, ld, off, out)
    want_f = torch.zeros((rows, F), dtype=torch.bool)
    want_c = k6.shard_counts_plain(torch.from_numpy(words.view(np.int32)), rb,
                                re_, c, want_f,
                                torch.from_numpy(init.astype(np.int32)))
    dest = np.zeros(writes.shape, bool)
    for r in range(rows):
        dest[off + r * ld:off + r * ld + F] = True
        got = mem[off + r * ld:off + r * ld + F]
        assert got.tolist() == want_f[r].numpy().astype(np.uint8).tolist()
    assert (writes[dest] == 1).all() and (writes[~dest] == 0).all()
    assert (mem[~dest] == 0xAA).all()
    assert out.tolist() == want_c.tolist()
    assert bits.any() == (dens > 0)


def test_k6_transpose_is_the_bit_transpose():
    rng = np.random.default_rng(6)
    xs = [int(x) for x in rng.integers(0, 1 << 32, 32, dtype=np.uint64)]
    cols = transpose32(xs)
    for b in range(32):
        for i in range(32):
            assert (cols[b] >> i) & 1 == (xs[i] >> b) & 1


def test_k6_tiling():
    for rows in (1, 127, 128, 32768, 67584, 67585, 131072, 1 << 20):
        per, tiles = k6.tiling(rows)
        assert per % k6.SUB_ROWS == 0 and tiles <= k6.MAX_TILES
        assert (tiles - 1) * per < rows <= tiles * per
    assert k6.tiling(32768) == (32, 1024)
