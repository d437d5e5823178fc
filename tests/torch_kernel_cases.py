"""Inputs shared by the port's card tests and chip_smoke.py: K3's hard
pattern set and vocabulary, K4's synthetic join tables with every
sentinel in play, and K5's leaves and row patches (tests/
test_torch_rows_update.py holds them against the JAX package on the
CPU). Imports numpy and the port only (no jax), so the card can import
it. Not a test module (pytest does not collect it)."""

from __future__ import annotations

import numpy as np

from gatekeeper_tpu_torch.ir import join as tjoin

# the regex test suite's patterns: classes, alternation, ^/$, .*, +/?
HARD_PATTERNS = [
    "^[0-9]+$", "^(extensions|networking.k8s.io)$", "^[a-z]+.corp.example$",
    "^prod$|^dev$", "^us-", "^[a-z0-9-]+$", "^cc-[0-9]+$", "^[ab]$", "",
    "a", "a*", "a+b?", "(ab)+c", "a|", "(a|b)*c$", "^$", "x^a|b", "a$b|c",
    "[^a-z]", "[-a]", "\\d+\\.\\d+", "\\w+@\\w+", "((a|b)(c|d))+",
    ".*middle.*", "end$", "^start", "[A-Fa-f0-9]+$",
]
EDGE_LENGTHS = (0, 1, 15, 16, 17, 127, 128)

# the SMs of an H100 SXM, for the K3 group plans tested on the CPU
H100_SMS = 132

# K3 patterns whose compressed tables exceed what one block stages for a
# group (kernels/regex_scan.py GROUP_TABLE_BYTES, 8 KB): 11,947 bytes (a
# group alone, read from global memory), then 5,653 and 7,481 bytes, too
# large to share a group
K3_BIG_PATTERNS = [
    "a[^b][^c][^d][^e][^f][^g][^h]|0[^1][^2][^3]",
    "a[^b][^c][^d][^e][^f][^g][^h][^i]",
    "a[^b][^c][^d][^e][^f][^g][^h]|x[^y][^z]",
]


def hard_vocab(seed: int, n: int) -> list[str]:
    """n ASCII strings over the patterns' alphabet: the edge lengths
    first, then random lengths 0..40."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdeprodvxyz-_./0123456789AF @", np.uint8)
    lengths = list(EDGE_LENGTHS) + list(
        rng.integers(0, 41, n - len(EDGE_LENGTHS)))
    return [bytes(rng.choice(alphabet, size=int(k))).decode()
            for k in lengths]


def big_vocab(seed: int, n: int) -> list[str]:
    """n ASCII strings over K3_BIG_PATTERNS' alphabet, the edge lengths
    first, then random lengths 0..40."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghi0123xyz", np.uint8)
    lengths = list(EDGE_LENGTHS) + list(
        rng.integers(0, 41, n - len(EDGE_LENGTHS)))
    return [bytes(rng.choice(alphabet, size=int(k))).decode()
            for k in lengths]


def k4_synthetic(seed: int, n_u: int, G: int, N: int, hmax: int) -> tuple:
    """Padded join tables and reviews (u_p, cnt_p, sik_p, karr, iks) with
    every sentinel in play: keys absent, equal to the first and last real
    entry, KEY_PAD; single and shared holders; identities equal to the
    holder's, other, and IK_REV_MISSING / IK_INV_MISSING."""
    rng = np.random.default_rng(seed)
    u = np.sort(rng.choice(np.arange(10, 10 + 4 * n_u, 2), n_u,
                           replace=False))
    cnt = rng.choice([1, 1, 2, 3], n_u).astype(np.int32)
    sik = rng.integers(100, 140, (G, n_u))
    sik[rng.random((G, n_u)) < 0.2] = tjoin.IK_INV_MISSING
    sik[:, cnt >= 2] = tjoin.IK_MULTI
    pool = np.concatenate([u, u + 1, [u[0], u[-1], 0, u[-1] + 7]])
    keys = [sorted({int(x) for x in rng.choice(
        pool, int(rng.integers(0, hmax + 1)))}) for _ in range(N)]
    iks = rng.integers(100, 140, (N, G))
    for r, ks in enumerate(keys):
        if ks and rng.random() < 0.4:
            j = int(np.searchsorted(u, ks[0]))
            if j < n_u:
                iks[r] = sik[:, j]  # the review's own stored copy
    iks[rng.random((N, G)) < 0.2] = tjoin.IK_REV_MISSING
    return tjoin.pad_inventory(u, cnt, sik) + tjoin.pad_reviews(
        keys, iks, max(1, max(len(k) for k in keys)))


# K5: leaves of N rows, every dtype a feature leaf has (uint32 crosses as
# its int32 view), float32 with NaN payloads and both signs of zero
K5_N = 37
K5_SHAPES = [(K5_N,), (K5_N, 4), (K5_N, 3, 5)]
K5_DTYPES = ["int8", "int32", "float32", "uint32"]
# m: one row, 3 rows padded to 4 by repeating the last index and its row
# (the JAX package's power-of-two padding), and every row permuted
K5_MS = [1, "3p", K5_N]
SPECIAL_F32 = np.array([0x7FC00001, 0xFFC12345, 0x7F800001, 0x00000000,
                        0x80000000, 0x7F800000, 0xFF800000],
                       dtype=np.uint32)


def k5_random(rng, shape, dtype: str) -> np.ndarray:
    """Random values of `dtype`; float32 from random bits with a quarter
    of them replaced by SPECIAL_F32's patterns."""
    if dtype == "float32":
        a = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
            np.uint32)
        flat = a.reshape(-1)
        k = max(1, flat.size // 4)
        flat[rng.integers(0, flat.size, size=k)] = rng.choice(SPECIAL_F32,
                                                              size=k)
        return a.view(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, size=shape,
                        dtype=np.int64).astype(dtype)


def k5_case(dtype: str, shape: tuple, m, seed: int) -> tuple:
    """(leaf, pos int32, new rows) for one case of K5_MS."""
    rng = np.random.default_rng(seed)
    dst = k5_random(rng, shape, dtype)
    if m == "3p":
        pos = rng.choice(K5_N, size=3, replace=False)
        pos, pick = np.append(pos, pos[-1]), [0, 1, 2, 2]
    else:
        pos, pick = rng.permutation(K5_N)[:m], list(range(m))
    new = k5_random(rng, (len(set(pick)),) + shape[1:], dtype)[pick]
    return dst, pos.astype(np.int32), new


# K1 at tile scale (256 rows a tile; rows past 262,144 take two passes a
# thread): (rows, W, density, r_begin, r_end, row0, c, pcap). At least 3
# tiles each; counts above pcap, a count of 0, row ranges that cut tiles,
# slab offsets and c not a multiple of 32.
K1_TILE_CASES = [
    (3 * 256 + 17, 1, 0.05, 0, 3 * 256 + 17, 0, 32, 1 << 14),
    (3000, 16, 0.002, 0, 3000, 40960, 500, 1 << 14),
    (3000, 16, 0.002, 300, 2711, 12345, 511, 64),     # count > pcap
    (2049, 3, 0.0, 0, 2049, 0, 70, 256),              # count 0
    (5000, 4, 0.01, 255, 4097, 7, 100, 1 << 12),
    (300_000, 1, 1e-3, 17, 299_990, 0, 19, 1 << 10),  # 2 passes, > pcap
    (1030, 5, 0.2, 0, 1030, 1 << 20, 157, 1 << 16),   # W not 4k: scalar
]
