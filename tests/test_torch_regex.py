"""The port's regex DFA path (ops/regex_nfa.py, K3) against the JAX package.

Same patterns and strings through both packages: the compiled NFA/DFA
tables must be bit-equal, the compressed tables K3 reads must give the
same next state as the JAX package's stacked table, the packed strings
must reproduce its padded byte matrix row for row, the K3 plain version
must equal the JAX package's `scan_device` (run by jax on the CPU) and
`re.search`, and MatchTables' batched regex rows must equal the JAX
package's and the host path's. Tolerance: exact equality (booleans,
bytes and integer state ids).
"""

import re

import numpy as np
import pytest
import torch

from gatekeeper_tpu.ops import regex_nfa as jrx
from gatekeeper_tpu.ops import strtab as jst
from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
from gatekeeper_tpu_torch.kernels.regex_scan import (
    GROUP_TABLE_BYTES,
    regex_scan,
    regex_scan_plain,
)
from gatekeeper_tpu_torch.ops import regex_nfa as trx
from gatekeeper_tpu_torch.ops import strtab as tst

from .test_regex_nfa import ADVERSARIAL_PATTERNS, CORPUS_PATTERNS, STRINGS
from .test_torch_frontend import TARGET, fixture_objects, library_drivers
from .torch_kernel_cases import (
    EDGE_LENGTHS,
    H100_SMS,
    HARD_PATTERNS,
    K3_BIG_PATTERNS,
    big_vocab,
    hard_vocab,
)

PATTERNS = CORPUS_PATTERNS + ADVERSARIAL_PATTERNS
# the alphabet the random vocabulary draws from: the patterns' literals,
# class members and separators, printable ASCII without newline
ALPHABET = np.frombuffer(b"abcdeprodvxyz-_./:0123456789ABF @|^$", np.uint8)


def library_regex_rows() -> list[tuple[str, str]]:
    """Every re_match/glob row the shipped library registers over the
    corpus (parameter and template-constant patterns)."""
    from gatekeeper_tpu.target import K8sValidationTarget

    _jd, td = library_drivers()
    reviews = [K8sValidationTarget()._object_to_review(o)
               for o in fixture_objects(200)]
    cons = td._constraints(TARGET)
    for kind in sorted(td._programs):
        kc = [c for c in cons if c["kind"] == kind]
        td._prepare_eval(td.compiled_for(kind), kind, reviews, kc, None)
    return [p for p in td.match_tables._patterns
            if p[0] in ("re_match", "glob")]


def library_patterns() -> list[str]:
    return [tst.MatchTables.glob_regex(p) if op == "glob" else p
            for op, p in library_regex_rows()]


def jax_stack(dfas) -> tuple:
    """The JAX package's scan_device stacks its DFAs so: (table[P, S_max,
    256], accept_end[P, S_max], start[P], matched_id[P]), zero-padded."""
    P = len(dfas)
    s_max = max(d.table.shape[0] for d in dfas)
    table = np.zeros((P, s_max, 256), dtype=np.int32)
    accept_end = np.zeros((P, s_max), dtype=bool)
    for i, d in enumerate(dfas):
        table[i, : d.table.shape[0]] = d.table
        accept_end[i, : d.table.shape[0]] = d.accept_end
    return table, accept_end, np.array([d.start for d in dfas]), \
        np.array([d.matched for d in dfas])


def padded(buf: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Packed strings back to the padded [V, MAX_LEN] byte matrix: each
    string cut at its offsets, NUL-padded."""
    out = np.zeros((len(offsets) - 1, trx.MAX_LEN), dtype=np.uint8)
    for v in range(len(offsets) - 1):
        row = buf[offsets[v]:offsets[v + 1]]
        out[v, :len(row)] = row
    return out


def k3_plain(dfas, strings) -> np.ndarray:
    """K3's plain version on scan_prep's packed strings and scan_tables'
    compressed tables, as scan_device hands them to the kernel."""
    buf, offsets, _special = trx.scan_prep(strings)
    blob, pdesc, gdesc, smem = trx.scan_tables(dfas, len(strings), H100_SMS)
    got = regex_scan(*tree_from_numpy((buf, offsets, blob, pdesc, gdesc),
                                      "cpu"), smem)
    assert got.dtype == torch.bool and got.shape == (len(dfas),
                                                     len(strings))
    return got.numpy()


def random_vocab(seed: int, n: int) -> list[str]:
    """n ASCII strings: random lengths 0..40, every edge length, and
    pattern-shaped words spliced in so that matches are not rare."""
    rng = np.random.default_rng(seed)
    words = ["prod", "dev", "us-", "cc-", "extensions", ".corp.example",
             "networking.k8s.io", "middle", "end", "start", "ab", "1.5"]
    out = []
    for i in range(n):
        k = EDGE_LENGTHS[i] if i < len(EDGE_LENGTHS) else \
            int(rng.integers(0, 41))
        s = bytes(rng.choice(ALPHABET, size=k)).decode()
        if i >= len(EDGE_LENGTHS) and rng.random() < 0.5:
            w = words[int(rng.integers(len(words)))]
            at = int(rng.integers(0, len(s) + 1))
            s = (s[:at] + w + s[at:])[:128]
        out.append(s)
    return out


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dfa_tables_equal(pattern):
    jn, tn = jrx.compile_pattern(pattern), trx.compile_pattern(pattern)
    assert np.array_equal(tn.table, jn.table)
    assert (tn.n_core, tn.start0, tn.float_start) == \
        (jn.n_core, jn.start0, jn.float_start)
    jd, td = jrx.compile_dfa(jn), trx.compile_dfa(tn)
    assert td.table.dtype == jd.table.dtype == np.int32
    assert np.array_equal(td.table, jd.table)
    assert np.array_equal(td.accept_end, jd.accept_end)
    assert (td.start, td.matched) == (jd.start, jd.matched)


def test_library_dfa_tables_equal():
    pats = library_patterns()
    assert pats  # the library has regex rows
    for p in pats:
        jd, td = jrx.try_compile_device(p), trx.try_compile_device(p)
        assert (jd is None) == (td is None), p
        if jd is not None:
            assert np.array_equal(td.table, jd.table), p
            assert np.array_equal(td.accept_end, jd.accept_end), p
            assert (td.start, td.matched) == (jd.start, jd.matched), p


@pytest.mark.parametrize("pattern", ["a{3}", "(?i)abc", "(?P<x>a)", "a\\b",
                                     "é+"])
def test_unsupported_patterns_agree(pattern):
    with pytest.raises(trx.Unsupported):
        trx.compile_pattern(pattern)
    assert trx.try_compile_device(pattern) is None
    assert jrx.scan_vocab([pattern], ["aaa"]) is None


def test_k3_plain_equals_jax_scan_and_re():
    """K3's plain version on the packed strings and compressed tables
    equals the JAX package's scan_device and re.search on a random
    vocabulary (edge lengths included, P*V not a multiple of 256)."""
    pats = PATTERNS + library_patterns()
    # STRINGS less its \x01 string, which the caller patches
    strings = random_vocab(0, 1001) + [t for t in STRINGS if "\x01" not in t]
    bmat = jrx.bytes_matrix(strings)
    jdfas = [jrx.compile_dfa(jrx.compile_pattern(p)) for p in pats]
    tdfas = [trx.compile_dfa(trx.compile_pattern(p)) for p in pats]
    want_jax = jrx.scan_device(jdfas, bmat)
    assert np.array_equal(k3_plain(tdfas, strings), want_jax)
    packed = trx.scan_prep(strings)[:2]
    assert np.array_equal(trx.scan_device(tdfas, packed, "cpu"), want_jax)
    want_re = np.array([[re.search(p, s) is not None for s in strings]
                        for p in pats])
    assert np.array_equal(want_jax, want_re)
    assert want_re.any() and not want_re.all()


@pytest.mark.parametrize("length", EDGE_LENGTHS)
def test_k3_plain_edge_lengths(length):
    """One string length at a time, so L is that length's own bucket."""
    pats = ["^a+$", "b$", "^$", "(ab)+c", ".*z", "a"]
    strings = ["a" * length, "b" * length, ("ab" * 64)[:length],
               ("ab" * 64)[:max(length - 1, 0)] + "c"[:length],
               "x" * max(length - 1, 0) + "z"[:length]]
    tdfas = [trx.compile_dfa(trx.compile_pattern(p)) for p in pats]
    jdfas = [jrx.compile_dfa(jrx.compile_pattern(p)) for p in pats]
    got = k3_plain(tdfas, strings)
    assert np.array_equal(got, jrx.scan_device(jdfas,
                                               jrx.bytes_matrix(strings)))
    want = np.array([[re.search(p, s) is not None for s in strings]
                     for p in pats])
    assert np.array_equal(got, want)


def test_scan_vocab_paths_agree():
    """The port's scan path (scan_prep, then scan_device, the blanked
    strings patched by re.search as MatchTables does) equals the JAX
    package's scan_vocab through its host and its device path, and
    vetoes the windows that scan_vocab vetoes."""
    pats = CORPUS_PATTERNS
    dfas = [trx.try_compile_device(p) for p in pats]
    buf, offsets, special = trx.scan_prep(STRINGS)
    assert [STRINGS[k] for k in special] == ["\x01n123"]
    got = trx.scan_device(dfas, (buf, offsets), "cpu")
    for k in special:
        got[:, k] = [re.search(p, STRINGS[k]) is not None for p in pats]
    want = jrx.scan_vocab(pats, STRINGS, force_device=False)
    assert np.array_equal(got, want)
    assert np.array_equal(jrx.scan_vocab(pats, STRINGS, force_device=True),
                          want)
    for pat, s in (("^.$", "\u00e9"), ("^a+$", "a" * 300)):
        assert jrx.scan_vocab([pat], [s]) is None
        assert trx.scan_prep([s]) is None
    # a newline vetoes scan_vocab; MatchTables blanks it and patches it
    assert jrx.scan_vocab(["a.b"], ["a\nb"]) is None
    assert trx.scan_prep(["a\nb"])[2].tolist() == [0]


def test_match_tables_batched_rows_equal(monkeypatch):
    """MatchTables' batched DFA rows (DEVICE_CROSSOVER 1 on both sides)
    equal the JAX package's batched rows and the port's host rows:
    the pad entry, the canon-num marker (\\x01), NUL and newline strings
    patched by re.search, glob rows, and an unsupported pattern's row."""
    monkeypatch.setattr(jrx, "DEVICE_CROSSOVER", 1)
    monkeypatch.setattr(trx, "DEVICE_CROSSOVER", 1)
    scans = []
    real_scan = trx.scan_device
    monkeypatch.setattr(trx, "scan_device",
                        lambda *a: scans.append(a) or real_scan(*a))
    extra = ["a\nb", "end\n", "x\x00y", "ns-1", "ns-22"]
    pats = CORPUS_PATTERNS + ["a{3}", "end$", "a.b"]
    globs = ["registry.corp.example/*", "*.corp.example", "ns-*"]

    def build(mod, st, mt):
        for s in STRINGS + extra + random_vocab(1, 300):
            st.intern(s or "x")
        st.intern(mod.canon_num(123))
        for p in pats:
            mt.row("re_match", p)
        for g in globs:
            mt.row("glob", g)
        out = [mt.materialize()]
        # a second window: rows extend over newly interned strings
        for s in random_vocab(2, 50):
            st.intern(s[:100] + "!")
        out.append(mt.materialize())
        # a third, whose oversize string vetoes the batch (host rows)
        st.intern("y" * 200)
        out.append(mt.materialize())
        return np.concatenate(out, axis=1)

    jst_ = jst.StringTable()
    want = build(jst, jst_, jst.MatchTables(jst_))
    tst_ = tst.StringTable()
    got = build(tst, tst_, tst.MatchTables(tst_, "cpu"))
    assert len(scans) == 2  # both windows took the batched DFA scan
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    # and the host path (batch vetoed) builds the same rows
    monkeypatch.setattr(trx, "try_compile_device", lambda p: None)
    hst = tst.StringTable()
    host = build(tst, hst, tst.MatchTables(hst, "cpu"))
    assert len(scans) == 2
    assert np.array_equal(host, want)
    assert not want[:, 0].any()  # the pad entry never matches


def messy_strings(seed: int, n: int) -> list[str]:
    """Strings the scan must blank or veto: NUL, \\x01, newline,
    non-ASCII and oversize, among plain ones."""
    rng = np.random.default_rng(seed)
    odd = ["\x00", "\x01", "\n", "é", "ü" * 70, "z" * 129, "y" * 128, ""]
    out = []
    for i in range(n):
        s = bytes(rng.choice(ALPHABET, size=int(rng.integers(0, 30)))
                  ).decode()
        if rng.random() < 0.2:
            at = int(rng.integers(0, len(s) + 1))
            s = s[:at] + odd[int(rng.integers(len(odd)))] + s[at:]
        out.append(s)
    return out


@pytest.mark.parametrize("seed", range(6))
def test_byte_helpers_equal_jax(seed):
    """The vectorized byte matrix and scan_prep (blank, veto, build) give
    what the JAX package's per-string helpers give."""
    strings = messy_strings(seed, 200)
    clean_only = [s for s in strings if jrx.strings_scannable([s])]
    ascii_only = [s for s in strings if s.isascii() and len(s) <= 128]
    assert len(ascii_only) > len(clean_only)  # NUL / newline strings
    for batch in (strings, clean_only, ascii_only, strings[:1], []):
        special = [k for k, s in enumerate(batch)
                   if "\x00" in s or "\x01" in s or "\n" in s]
        clean = ["" if k in special else s for k, s in enumerate(batch)]
        prep = trx.scan_prep(batch)
        if not jrx.strings_scannable(clean):
            assert prep is None
            continue
        buf, offsets, got_special = prep
        assert got_special.tolist() == special
        # row for row the JAX package's matrix; special rows length 0
        assert np.array_equal(padded(buf, offsets), jrx.bytes_matrix(clean))
        assert (np.diff(offsets)[special] == 0).all()
        assert offsets[-1] == sum(map(len, clean))


def test_scan_prep_clean_ascii_window():
    """A window of plain ASCII strings (no NUL, \x01 or newline) takes
    one pass: no special rows, vetoed only by an oversize string."""
    ok = ["", "a", "y" * 128, "ns-1"]
    buf, offsets, special = trx.scan_prep(ok)
    assert special.tolist() == []
    assert np.array_equal(padded(buf, offsets), jrx.bytes_matrix(ok))
    assert offsets.tolist() == [0, 0, 1, 129, 133]
    assert trx.scan_prep(ok + ["z" * 129]) is None
    assert not jrx.strings_scannable(ok + ["z" * 129])
    # the buffer: the bytes back to back, zero-padded to 16-byte lines
    for strings, size in ((["ab", "c"], 16), (["x" * 17], 32), ([], 16),
                          ([""], 16), (["y" * 128], 128)):
        buf, offsets, _ = trx.scan_prep(strings)
        assert buf.dtype == np.uint8 and buf.shape == (size,)
        assert offsets.dtype == np.int32
        assert bytes(buf[:offsets[-1]]) == "".join(strings).encode()
        assert not buf[offsets[-1]:].any()


def _library_and_hard_patterns() -> list[str]:
    return library_patterns() + HARD_PATTERNS + K3_BIG_PATTERNS


@pytest.mark.parametrize("which", ["library", "hard", "big"])
def test_compressed_tables_equal_stacked_table(which):
    """compress_dfa's classes and uint16 states give the JAX package's
    stacked table's next state for every (state, byte 1..255), and so do
    the bytes K3 reads (table_part); the dead id is the one state that
    every byte leaves in place and that neither matches nor accepts."""
    pats = {"library": library_patterns, "hard": lambda: HARD_PATTERNS,
            "big": lambda: K3_BIG_PATTERNS}[which]()
    pats = [p for p in pats if trx.try_compile_device(p) is not None]
    assert pats
    tdfas = [trx.try_compile_device(p) for p in pats]
    table, accept_end, start, matched = jax_stack(
        [jrx.try_compile_device(p) for p in pats])
    blob, pdesc, gdesc, _smem = trx.scan_tables(tdfas, 1 << 20, H100_SMS)
    group = np.repeat(np.arange(len(gdesc)), gdesc[:, 1])
    for p, d in enumerate(tdfas):
        cls, nxt, dead = trx.compress_dfa(d)
        S, n_cls = nxt.shape
        assert nxt.dtype == np.uint16 and S == d.table.shape[0] <= 512
        assert cls.dtype == np.uint8 and n_cls == len(set(cls[1:]))
        got = nxt[:, cls[1:]]
        assert np.array_equal(got, table[p, :S, 1:])
        # the same through the blob's bytes, as the kernel reads them
        at = gdesc[group[p], 2] + pdesc[p, 0]
        assert at % 16 == 0
        assert tuple(pdesc[p, 1:]) == (n_cls, S, start[p], matched[p], dead)
        assert np.array_equal(blob[at:at + 256], cls)
        part_nxt = blob[at + 256:at + 256 + 2 * S * n_cls].view("<u2")
        assert np.array_equal(part_nxt.reshape(S, n_cls), nxt)
        assert np.array_equal(blob[at + 256 + 2 * S * n_cls:][:S],
                              accept_end[p, :S])
        ids = np.arange(S)
        loops = (table[p, :S, 1:] == ids[:, None]).all(axis=1) & \
            ~accept_end[p, :S] & (ids != matched[p])
        assert dead == (int(np.flatnonzero(loops)[0]) if loops.any()
                        else -1)
    if which == "hard":
        # ^[0-9]+$: start, digits, and the dead state 2 (two classes)
        cls, nxt, dead = trx.compress_dfa(tdfas[0])
        assert nxt.shape == (4, 2) and dead == 2


def test_group_plan_fits_shared_memory():
    """scan_tables' groups: consecutive patterns, every part 16-byte
    aligned, a group at most GROUP_TABLE_BYTES unless it is one pattern
    (then read from global memory), table_smem the largest staged one."""
    pats = HARD_PATTERNS[:3] + K3_BIG_PATTERNS + HARD_PATTERNS[3:]
    dfas = [trx.try_compile_device(p) for p in pats]
    # strings enough that the grid needs no more groups
    blob, pdesc, gdesc, smem = trx.scan_tables(dfas, 1 << 20, H100_SMS)
    assert gdesc[0, 0] == 0 and gdesc[-1, 0] + gdesc[-1, 1] == len(pats)
    assert (gdesc[1:, 0] == gdesc[:-1, 0] + gdesc[:-1, 1]).all()
    assert (gdesc[1:, 2] == gdesc[:-1, 2] + gdesc[:-1, 3]).all()
    assert blob.size == gdesc[-1, 2] + gdesc[-1, 3]
    assert (gdesc[:, 2] % 16 == 0).all() and (gdesc[:, 3] % 16 == 0).all()
    big = gdesc[:, 3] > GROUP_TABLE_BYTES
    assert (gdesc[big, 1] == 1).all() and big.sum() == 1
    assert smem == gdesc[~big, 3].max() and smem % 16 == 0
    # the big patterns could not share a group with each other
    firsts = [int(np.searchsorted(gdesc[:, 0], 3 + k, side="right")) - 1
              for k in range(3)]
    assert len(set(firsts)) == 3


@pytest.mark.parametrize("n_strings, per_group", [
    (0, 1), (1001, 1), (70_000, 4), (149_999, 2), (1 << 20, 9)])
def test_group_plan_keeps_the_grid_full(n_strings, per_group):
    """With few strings a group holds fewer patterns, so that the grid
    keeps MIN_BLOCKS_PER_SM blocks on each of an H100's 132 SMs: at
    most P x blocks / (MIN_BLOCKS_PER_SM x 132) patterns a
    group (the main path's 2 x 149,999 shares one group)."""
    from gatekeeper_tpu_torch.kernels.regex_scan import (
        MIN_BLOCKS_PER_SM, THREADS)

    pats = HARD_PATTERNS[:2] if per_group == 2 else HARD_PATTERNS[:9]
    dfas = [trx.try_compile_device(p) for p in pats]
    gdesc = trx.scan_tables(dfas, n_strings, H100_SMS)[2]
    assert gdesc[:, 1].max() == per_group
    blocks = -(-n_strings // THREADS)
    assert per_group == min(len(pats),
                            max(1, len(pats) * blocks
                                // (MIN_BLOCKS_PER_SM * H100_SMS)))


@pytest.mark.parametrize("case", ["hard", "all-special", "empty", "one",
                                  "big"])
def test_k3_plain_equals_jax_scan_on_edges(case):
    """K3's plain version against the JAX package's scan_device and
    re.search: the hard set over EDGE_LENGTHS, a window of special
    strings only (all length 0, patched by the caller), V = 0, P = 1,
    and the patterns too large for one group's shared memory."""
    pats, strings = HARD_PATTERNS, hard_vocab(2, 300)
    if case == "all-special":
        strings = ["\x00", "a\nb", "\x01n12", "x\x00"]
    elif case == "empty":
        strings = []
    elif case == "one":
        pats = ["^[a-z]+.corp.example$"]
        strings = hard_vocab(3, 40) + ["ab.corp.example", "a.corp.example"]
    elif case == "big":
        pats = K3_BIG_PATTERNS + HARD_PATTERNS[:5]
        strings = big_vocab(4, 400)
    tdfas = [trx.try_compile_device(p) for p in pats]
    jdfas = [jrx.try_compile_device(p) for p in pats]
    buf, offsets, special = trx.scan_prep(strings)
    clean = ["" if k in set(special.tolist()) else s
             for k, s in enumerate(strings)]
    got = k3_plain(tdfas, strings)
    if strings:
        assert np.array_equal(got, jrx.scan_device(
            jdfas, jrx.bytes_matrix(clean)))
    want = np.array([[re.search(p, s) is not None for s in clean]
                     for p in pats], dtype=bool).reshape(len(pats), -1)
    assert np.array_equal(got, want)
    if case == "all-special":
        assert special.tolist() == [0, 1, 2, 3] and offsets[-1] == 0
    if case in ("hard", "big"):
        assert want.any() and not want.all()
