"""The port's regex DFA path (ops/regex_nfa.py, K3) against the JAX package.

Same patterns and strings through both packages: the compiled NFA/DFA
tables must be bit-equal, the K3 plain version must equal the JAX
package's `scan_device` (run by jax on the CPU) and `re.search`, and
MatchTables' batched regex rows must equal the JAX package's and the
host path's. Tolerance: exact equality (booleans and integer state ids).
"""

import re

import numpy as np
import pytest
import torch

from gatekeeper_tpu.ops import regex_nfa as jrx
from gatekeeper_tpu.ops import strtab as jst
from gatekeeper_tpu_torch.ir.carry import tree_from_numpy
from gatekeeper_tpu_torch.kernels.regex_scan import (
    regex_scan,
    regex_scan_plain,
)
from gatekeeper_tpu_torch.ops import regex_nfa as trx
from gatekeeper_tpu_torch.ops import strtab as tst

from .test_regex_nfa import ADVERSARIAL_PATTERNS, CORPUS_PATTERNS, STRINGS
from .test_torch_frontend import TARGET, fixture_objects, library_drivers
from .torch_kernel_cases import EDGE_LENGTHS

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
    """K3's plain version on the padded DFA stack equals the JAX
    package's scan_device and re.search on a random vocabulary (edge
    lengths included, P*V not a multiple of 256)."""
    pats = PATTERNS + library_patterns()
    strings = random_vocab(0, 1001) + STRINGS[:-1]  # last has \x01
    bmat = trx.bytes_matrix(strings)
    assert np.array_equal(bmat, jrx.bytes_matrix(strings))
    jdfas = [jrx.compile_dfa(jrx.compile_pattern(p)) for p in pats]
    tdfas = [trx.compile_dfa(trx.compile_pattern(p)) for p in pats]
    want_jax = jrx.scan_device(jdfas, bmat)
    stacked = trx.stack_dfas(tdfas) + (trx.trim_bytes(bmat),)
    assert stacked[-1].shape[1] == 128  # the 128-byte string sets L
    got = regex_scan(*tree_from_numpy(stacked, "cpu"))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want_jax)
    assert np.array_equal(trx.scan_device(tdfas, bmat, "cpu"), want_jax)
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
    bmat = trx.bytes_matrix(strings)
    tdfas = [trx.compile_dfa(trx.compile_pattern(p)) for p in pats]
    jdfas = [jrx.compile_dfa(jrx.compile_pattern(p)) for p in pats]
    got = regex_scan_plain(*tree_from_numpy(
        trx.stack_dfas(tdfas) + (trx.trim_bytes(bmat),), "cpu"))
    assert np.array_equal(got.numpy(), jrx.scan_device(jdfas, bmat))
    want = np.array([[re.search(p, s) is not None for s in strings]
                     for p in pats])
    assert np.array_equal(got.numpy(), want)


def test_scan_vocab_paths_agree():
    """The port's scan path (scan_prep, then scan_device, the blanked
    strings patched by re.search as MatchTables does) equals the JAX
    package's scan_vocab through its host and its device path, and
    vetoes the windows that scan_vocab vetoes."""
    pats = CORPUS_PATTERNS
    dfas = [trx.try_compile_device(p) for p in pats]
    bmat, special = trx.scan_prep(STRINGS)
    assert [STRINGS[k] for k in special] == ["\x01n123"]
    got = trx.scan_device(dfas, bmat, "cpu")
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
    assert trx.scan_prep(["a\nb"])[1].tolist() == [0]


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
        assert np.array_equal(trx.bytes_matrix(batch),
                              jrx.bytes_matrix(batch))
        special = [k for k, s in enumerate(batch)
                   if "\x00" in s or "\x01" in s or "\n" in s]
        clean = ["" if k in special else s for k, s in enumerate(batch)]
        prep = trx.scan_prep(batch)
        if not jrx.strings_scannable(clean):
            assert prep is None
            continue
        bmat, got_special = prep
        assert got_special.tolist() == special
        assert np.array_equal(bmat, jrx.bytes_matrix(clean))


def test_scan_prep_clean_ascii_window():
    """A window of plain ASCII strings (no NUL, \x01 or newline) takes
    one pass: no special rows, vetoed only by an oversize string."""
    ok = ["", "a", "y" * 128, "ns-1"]
    bmat, special = trx.scan_prep(ok)
    assert special.tolist() == []
    assert np.array_equal(bmat, jrx.bytes_matrix(ok))
    assert trx.scan_prep(ok + ["z" * 129]) is None
    assert not jrx.strings_scannable(ok + ["z" * 129])
    # trim_bytes: the bucketed longest string, as the JAX scan trims
    for strings, L in ((["ab", "c"], 16), (["x" * 17], 32), ([""], 16),
                       (["y" * 128], 128)):
        assert trx.trim_bytes(trx.bytes_matrix(strings)).shape == \
            (len(strings), L)
