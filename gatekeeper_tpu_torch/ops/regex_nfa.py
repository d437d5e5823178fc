"""Device regex: byte-NFA -> DFA scan over the packed vocab.

Match-table rows for `re_match` are normally built host-side, one
`re.search` per (pattern, vocab string) — O(vocab × patterns) Python work
that lands exactly where BASELINE config #3 hurts (high-cardinality
vocabularies under the regex-heavy pod-security-policy set). This module
compiles a practical regex subset to a ≤30-core-state Thompson NFA, then
subset-constructs it into a DFA with an absorbing match sink, so the
device step is one table gather per byte per (pattern, string):

    state'[p, v] = table[p, state[p, v], byte[v, t]]

— embarrassingly parallel over patterns × vocab, so the whole pattern
set scans in one kernel launch (K3, kernels/regex_scan.py) over the
vocab's packed bytes, with each table compressed to byte classes
(compress_dfa) (replacing vendor/.../opa/topdown/regex.go's per-eval
re_match with precomputed tables, like every other string predicate).

Python-`re.search` parity (unanchored search, ^/$ anchors, classes,
quantifiers, alternation) is differentially tested in the test suite;
patterns outside the subset (or needing too many states) raise
Unsupported and keep the host path. MatchTables (ops/strtab.py) picks
device vs host by workload size (DEVICE_CROSSOVER) and calls scan_prep,
then scan_device."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..kernels.regex_scan import pack_tables, regex_scan, sm_count, table_part

MAX_STATES = 30  # CORE states (those with byte moves) per uint32 mask;
# bits 30/31 carry the accept / accept-at-end flags of a state SET, so a
# mask is a closed eps-set projected onto core states + its accept info
ACCEPT_BIT = np.uint32(1 << 30)
ACCEPT_END_BIT = np.uint32(1 << 31)
CORE_MASK = np.uint32((1 << 30) - 1)
MAX_LEN = 128  # must match StringTable.bytes_tensor default

# minimum (new strings x regex rows) before the device path (scan_prep's
# packed strings, the compressed tables, upload, one K3 launch, download)
# beats the host re.search loop: the device path's time x the host's
# evaluations per second, measured by chip_smoke.py's measure_crossover on
# an NVIDIA H100 80GB HBM3 (power limit 700 W) at the general library's
# 100,000-object window, 2 rows x 149,999 strings: host 0.0715 s (4.20M
# evaluations/s), device path 0.0121 s, break-even 50,978 evaluations,
# rounded up to a multiple of 50,000. The host sets it: an earlier run of
# the same path on another machine measured 149,962 (host 5.17M/s, device
# path 0.0290 s, of which scan_prep 0.0221 s). Config 4's window (7 rows x
# 44 strings, break-even 2,648) and the 10,000-object window (29,998
# evaluations, break-even 8,813) stay on the host. See PERF.md.
DEVICE_CROSSOVER = 100_000


class Unsupported(Exception):
    pass


# ------------------------------------------------------------ pattern AST


@dataclass
class _Node:
    kind: str  # lit | any | class | cat | alt | star | plus | opt | caret | dollar | empty
    bytes_: Optional[bytes] = None  # allowed bytes for lit/class/any
    kids: tuple = ()


def _parse(pattern: str) -> _Node:
    """Recursive-descent parser for the supported subset."""
    pos = [0]
    p = pattern

    def peek() -> str:
        return p[pos[0]] if pos[0] < len(p) else ""

    def take() -> str:
        c = peek()
        pos[0] += 1
        return c

    def parse_alt() -> _Node:
        branches = [parse_cat()]
        while peek() == "|":
            take()
            branches.append(parse_cat())
        if len(branches) == 1:
            return branches[0]
        return _Node("alt", kids=tuple(branches))

    def parse_cat() -> _Node:
        items = []
        while peek() not in ("", "|", ")"):
            items.append(parse_repeat())
        if not items:
            return _Node("empty")
        if len(items) == 1:
            return items[0]
        return _Node("cat", kids=tuple(items))

    def parse_repeat() -> _Node:
        atom = parse_atom()
        while peek() in ("*", "+", "?"):
            op = take()
            if atom.kind in ("caret", "dollar"):
                raise Unsupported("quantified anchor")
            kind = {"*": "star", "+": "plus", "?": "opt"}[op]
            atom = _Node(kind, kids=(atom,))
        if peek() == "{":
            raise Unsupported("counted repetition")
        return atom

    def parse_atom() -> _Node:
        c = take()
        if c == "^":
            return _Node("caret")
        if c == "$":
            return _Node("dollar")
        if c == ".":
            return _Node("any", bytes_=bytes(range(1, 256)))
        if c == "(":
            if peek() == "?":
                raise Unsupported("group flags")
            inner = parse_alt()
            if take() != ")":
                raise Unsupported("unbalanced group")
            return inner
        if c == "[":
            return parse_class()
        if c == "\\":
            return _Node("lit", bytes_=escape_bytes(take()))
        if c in ")*+?":
            raise Unsupported(f"dangling {c!r}")
        b = c.encode("utf-8")
        if len(b) != 1:
            raise Unsupported("non-ascii literal")
        return _Node("lit", bytes_=b)

    def escape_bytes(c: str) -> bytes:
        if c == "":
            raise Unsupported("trailing backslash")
        if c == "d":
            return bytes(range(ord("0"), ord("9") + 1))
        if c == "w":
            return (bytes(range(ord("a"), ord("z") + 1)) +
                    bytes(range(ord("A"), ord("Z") + 1)) +
                    bytes(range(ord("0"), ord("9") + 1)) + b"_")
        if c == "s":
            return b" \t\r\n\f\v"
        if c in ".^$*+?()[]{}|\\/-":
            return c.encode()
        raise Unsupported(f"escape \\{c}")

    def parse_class() -> _Node:
        negate = peek() == "^"
        if negate:
            take()
        members = bytearray()
        first = True
        while True:
            c = take()
            if c == "":
                raise Unsupported("unterminated class")
            if c == "]" and not first:
                break
            first = False
            if c == "\\":
                members.extend(escape_bytes(take()))
                continue
            b = c.encode("utf-8")
            if len(b) != 1:
                raise Unsupported("non-ascii class member")
            if peek() == "-" and pos[0] + 1 < len(p) and p[pos[0] + 1] != "]":
                take()
                hi = take()
                hb = hi.encode("utf-8")
                if hi == "\\":
                    hb = escape_bytes(take())
                    if len(hb) != 1:
                        raise Unsupported("range over class escape")
                if len(hb) != 1 or hb[0] < b[0]:
                    raise Unsupported("bad class range")
                members.extend(range(b[0], hb[0] + 1))
            else:
                members.extend(b)
        allowed = set(members)
        if negate:
            allowed = set(range(1, 256)) - allowed
        if not allowed:
            raise Unsupported("empty class")
        return _Node("class", bytes_=bytes(sorted(allowed)))

    node = parse_alt()
    if pos[0] != len(p):
        raise Unsupported(f"unparsed tail {p[pos[0]:]!r}")
    return node


# -------------------------------------------------------- NFA construction


class _Builder:
    """Thompson construction. Edge kinds: eps, caret (eps valid only at
    position 0), dollar (eps valid only at end of string), byte sets."""

    def __init__(self):
        self.eps: list[list[int]] = []
        self.caret: list[list[int]] = []
        self.dollar: list[list[int]] = []
        self.moves: list[list[tuple[bytes, int]]] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.caret.append([])
        self.dollar.append([])
        self.moves.append([])
        return len(self.eps) - 1

    def build(self, node: _Node) -> tuple[int, int]:
        """-> (entry, exit) state pair for the fragment."""
        k = node.kind
        if k == "empty":
            s = self.new_state()
            return s, s
        if k in ("lit", "any", "class"):
            a, b = self.new_state(), self.new_state()
            self.moves[a].append((node.bytes_, b))
            return a, b
        if k == "caret":
            a, b = self.new_state(), self.new_state()
            self.caret[a].append(b)
            return a, b
        if k == "dollar":
            a, b = self.new_state(), self.new_state()
            self.dollar[a].append(b)
            return a, b
        if k == "cat":
            first, last = None, None
            for kid in node.kids:
                a, b = self.build(kid)
                if first is None:
                    first = a
                else:
                    self.eps[last].append(a)
                last = b
            return first, last
        if k == "alt":
            a, b = self.new_state(), self.new_state()
            for kid in node.kids:
                ka, kb = self.build(kid)
                self.eps[a].append(ka)
                self.eps[kb].append(b)
            return a, b
        if k in ("star", "plus", "opt"):
            ka, kb = self.build(node.kids[0])
            a, b = self.new_state(), self.new_state()
            self.eps[a].append(ka)
            if k != "plus":
                self.eps[a].append(b)
            self.eps[kb].append(b)
            if k != "opt":
                self.eps[kb].append(ka)
            return a, b
        raise Unsupported(f"node {k}")


@dataclass
class NfaProgram:
    """Bitmask NFA, ready for vectorized subset simulation.

    A mask encodes an eps-CLOSED state set projected onto core states
    (states with outgoing byte moves), plus two flag bits: ACCEPT_BIT
    (the set contains accept) and ACCEPT_END_BIT (the set reaches accept
    once $-edges open up at end of string).

    table[c, byte]  — mask reachable from core state c on byte
    start0          — start-set mask at position 0 (follows ^ edges)
    float_start     — start-set mask injected at every position (search)
    """

    n_core: int
    table: np.ndarray  # [S, 256] uint32
    start0: int
    float_start: int


def compile_pattern(pattern: str) -> NfaProgram:
    """pattern -> bitmask NFA with Python re.search semantics, or raises
    Unsupported (host fallback)."""
    node = _parse(pattern)
    b = _Builder()
    entry, exit_ = b.build(node)
    n = len(b.eps)

    core = [s for s in range(n) if b.moves[s]]
    if len(core) > MAX_STATES:
        raise Unsupported(f"{len(core)} core states > {MAX_STATES}")
    core_bit = {s: i for i, s in enumerate(core)}

    def closure(seed: set[int], caret: bool, dollar: bool) -> set[int]:
        out = set(seed)
        work = list(seed)
        while work:
            s = work.pop()
            nxts = list(b.eps[s])
            if caret:
                nxts += b.caret[s]
            if dollar:
                nxts += b.dollar[s]
            for t in nxts:
                if t not in out:
                    out.add(t)
                    work.append(t)
        return out

    def mask_of(seed: set[int], caret: bool = False) -> int:
        """Closed set -> core projection + accept flags."""
        closed = closure(seed, caret=caret, dollar=False)
        m = 0
        for s in closed:
            bit = core_bit.get(s)
            if bit is not None:
                m |= 1 << bit
        if exit_ in closed:
            m |= int(ACCEPT_BIT)
        if exit_ in closure(closed, caret=False, dollar=True):
            m |= int(ACCEPT_END_BIT)
        return m

    table = np.zeros((max(1, len(core)), 256), dtype=np.uint32)
    for s in core:
        for allowed, target in b.moves[s]:
            tmask = np.uint32(mask_of({target}))
            arr = np.frombuffer(allowed, dtype=np.uint8)
            table[core_bit[s], arr] |= tmask
    return NfaProgram(
        n_core=len(core),
        table=table,
        start0=mask_of({entry}, caret=True),
        float_start=mask_of({entry}, caret=False),
    )


# ----------------------------------------------- DFA (the device program)


@dataclass
class DfaProgram:
    """Subset-constructed DFA of the search-NFA, with an ABSORBING match
    sink (any set containing accept collapses into it), so the device
    step is ONE gather per byte and acceptance is a final-state check.
    accept_end[s] flags sets that accept once $-edges open at the
    string's end (the scan freezes each string's state at its last real
    byte, so the final state IS the end-of-string state)."""

    table: np.ndarray  # [S, 256] int32 next-state ids
    accept_end: np.ndarray  # [S] bool
    start: int
    matched: int


MAX_DFA_STATES = 512


def compile_dfa(prog: NfaProgram,
                max_states: int = MAX_DFA_STATES) -> DfaProgram:
    """NfaProgram -> DfaProgram, or Unsupported on state blowup."""
    CORE = int(CORE_MASK)
    ACC = int(ACCEPT_BIT)
    floatm = prog.float_start

    def step(mask: int, byte: int) -> int:
        nxt = 0
        st = mask & CORE
        while st:
            low = st & -st
            nxt |= int(prog.table[low.bit_length() - 1, byte])
            st ^= low
        return nxt | floatm

    ids: dict[int, int] = {}
    rows: list[np.ndarray] = []
    ends: list[bool] = []

    MATCHED = 0  # reserve id 0 for the absorbing sink
    rows.append(np.zeros(256, dtype=np.int32))  # self-loops
    ends.append(True)

    def intern_mask(mask: int) -> int:
        if mask & ACC:
            return MATCHED
        i = ids.get(mask)
        if i is None:
            if len(rows) >= max_states:
                raise Unsupported("DFA state blowup")
            i = len(rows)
            ids[mask] = i
            rows.append(np.zeros(256, dtype=np.int32))
            ends.append(bool(mask & int(ACCEPT_END_BIT)))
            work.append((i, mask))
        return i

    work: list[tuple[int, int]] = []
    start = intern_mask(prog.start0)
    while work:
        i, mask = work.pop()
        row = rows[i]
        for byte in range(1, 256):
            row[byte] = intern_mask(step(mask, byte))
    return DfaProgram(
        table=np.stack(rows),
        accept_end=np.asarray(ends, dtype=bool),
        start=start,
        matched=MATCHED,
    )


# ------------------------------------------------------------- device scan


def compress_dfa(d: DfaProgram) -> tuple:
    """-> (cls uint8[256], nxt uint16 [S, n_classes], dead): the DFA's
    table over byte classes. Bytes 1..255 whose columns are equal share a
    class (byte 0 never occurs in a scanned string; its class is 0).
    dead is the state that every byte 1..255 leaves in place and that is
    neither the sink nor accepting at the end (-1 when there is none):
    a walk that reaches it has its answer, False."""
    S = d.table.shape[0]
    cols = np.ascontiguousarray(d.table[:, 1:].T)  # [255, S]
    # equal columns as equal byte strings: one sort of 255 keys
    keys = cols.view(np.dtype((np.void, 4 * S))).reshape(-1)
    _keys, first, inv = np.unique(keys, return_index=True,
                                  return_inverse=True)
    cls = np.zeros(256, dtype=np.uint8)
    cls[1:] = inv.reshape(-1)
    ids = np.arange(S)
    dead = np.flatnonzero((d.table[:, 1:] == ids[:, None]).all(axis=1)
                          & ~d.accept_end & (ids != d.matched))
    return cls, cols[first].T.astype(np.uint16), \
        int(dead[0]) if dead.size else -1


def scan_tables(dfas: list[DfaProgram], n_strings: int,
                n_sms: int) -> tuple:
    """-> (blob, pdesc, gdesc, table_smem): the DFAs' compressed tables
    and their group plan for a scan of n_strings strings on a card of
    n_sms SMs, as K3 takes them (kernels/regex_scan.py)."""
    parts, heads = [], []
    for d in dfas:
        cls, nxt, dead = compress_dfa(d)
        parts.append(table_part(cls, nxt, d.accept_end))
        heads.append((nxt.shape[1], nxt.shape[0], d.start, d.matched, dead))
    return pack_tables(parts, heads, n_strings, n_sms)


def scan_device(dfas: list[DfaProgram], packed: tuple,
                device) -> np.ndarray:
    """-> matched[P, V] bool (host): every pattern against every string
    of `packed` (scan_prep's buf and offsets) in one K3 launch on
    `device`. Each string's walk ends at its last byte, so '$'
    acceptance reads off the final state. On a CPU device K3 takes its
    plain version. Raises ValueError for a string over MAX_LEN bytes,
    which the kernel does not take (scan_prep vetoes those)."""
    dev = torch.device(device)
    offsets = packed[1]
    if len(offsets) > 1 and int(np.diff(offsets).max()) > MAX_LEN:
        raise ValueError(f"scan_device: a string over {MAX_LEN} bytes")
    blob, pdesc, gdesc, table_smem = scan_tables(
        dfas, len(offsets) - 1, sm_count(dev))
    args = [torch.from_numpy(a).to(dev)
            for a in (*packed, blob, pdesc, gdesc)]
    return regex_scan(*args, table_smem).cpu().numpy()


def _pack(data: bytes, lens: np.ndarray) -> tuple:
    """-> (buf, offsets) for strings whose bytes are `data` back to back
    with these lengths: buf zero-padded to a multiple of 16 bytes (at
    least 16), offsets int32 [V+1]."""
    offsets = np.zeros(len(lens) + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    buf = np.zeros(max(16, (len(data) + 15) // 16 * 16), dtype=np.uint8)
    buf[:len(data)] = np.frombuffer(data, dtype=np.uint8)
    return buf, offsets


def try_compile_device(pattern: str) -> Optional[DfaProgram]:
    try:
        return compile_dfa(compile_pattern(pattern))
    except Unsupported:
        return None


def scan_prep(strings: list[str]):
    """-> (buf, offsets, special) for a batched scan of `strings`, or
    None. buf holds the strings back to back and offsets[V+1] where each
    starts (`_pack`); `special` lists, ascending, the strings holding NUL,
    \\x01 or a newline: they get length 0 and the caller patches them
    with re.search. None when another string cannot be scanned, which
    vetoes the batch: over MAX_LEN bytes, or not pure ASCII (byte-wise
    '.'/negated-class semantics diverge from re's per-char semantics past
    that). re gives '.' and '$' newline behavior the byte NFA does not
    model, hence the blanking. The same outcome as the JAX package's
    blank, then strings_scannable veto, then bytes_matrix, whose rows are
    these strings NUL-padded to MAX_LEN."""
    joined = "".join(strings)
    special: list[int] = []
    if not joined.isascii() or "\x00" in joined or "\x01" in joined \
            or "\n" in joined:
        special = [k for k, s in enumerate(strings)
                   if "\x00" in s or "\x01" in s or "\n" in s]
        skip = set(special)
        strings = ["" if k in skip else s for k, s in enumerate(strings)]
        if not all(map(str.isascii, strings)):
            return None
        joined = "".join(strings)
    # the common case (plain ASCII) takes a few passes over one string
    lens = np.fromiter(map(len, strings), dtype=np.int64,
                       count=len(strings))
    if lens.size and int(lens.max()) > MAX_LEN:
        return None
    return (*_pack(joined.encode("ascii"), lens),
            np.asarray(special, dtype=np.int64))
