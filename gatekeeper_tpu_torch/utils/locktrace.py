"""Lockset tracer: lock-order inversions, cycles, and held-across-
blocking events, recorded at runtime.

The static no-block checker (tools/gklint) proves blocking operations
aren't *reachable* from the no-block zones; this module watches what
threads actually *do* under the chaos and concurrency suites — the
runtime companion to the deadlock checker.

Armed via ``GATEKEEPER_TPU_LOCKTRACE=1`` (tests/conftest.py installs
it before any serving code constructs a lock): ``threading.Lock`` /
``threading.RLock`` are replaced with tracing wrappers that record,
per thread, the lock-acquisition-order graph keyed by each lock's
ALLOCATION SITE (file:line — all instances born on one line are one
node, so per-connection locks aggregate). On every acquisition taken
while other locks are held, the tracer adds held-site -> new-site
edges; an edge whose reverse path already exists is a lock-order
INVERSION (two threads can deadlock given the right interleaving —
the classic lockdep check). ``report()`` additionally runs a cycle
search over the whole graph, catching A->B->C->A orders no single
inversion edge shows. ``time.sleep`` is wrapped so a sleep while
holding any traced lock records a held-across-blocking event.

Findings append to ``GATEKEEPER_TPU_LOCKTRACE_OUT`` as JSONL the
moment they are recorded (inversions are detected at acquire time,
BEFORE any deadlock can wedge the process — so a SIGKILLed run still
leaves its evidence on disk; concurrent test processes share one
file), with a final flush at exit for report-time cycle findings.
``python -m tools.gklint --locktrace-report FILE`` turns the dump
into a CI verdict: cycles/inversions fail, held-across-blocking is
reported but advisory (bounded sleeps under a lock are a code smell,
not a deadlock).
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Optional

ENV = "GATEKEEPER_TPU_LOCKTRACE"
OUT_ENV = "GATEKEEPER_TPU_LOCKTRACE_OUT"

_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock
_ORIG_SLEEP = time.sleep

_THIS_FILE = os.path.abspath(__file__)
_THREADING_FILE = os.path.abspath(threading.__file__)


def _alloc_site() -> str:
    """file:line of the frame that constructed the lock (first frame
    outside this module and threading.py)."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if os.path.abspath(fn) not in (_THIS_FILE, _THREADING_FILE):
            return f"{fn}:{f.f_lineno}"
        f = f.f_back
    return "<unknown>"


class LockTracer:
    """One tracing domain: the per-thread lockset, the site-order
    graph, and the findings list. Tests construct their own; the
    process-global one is installed by install()."""

    def __init__(self, out_path: Optional[str] = None):
        self._lock = _ORIG_LOCK()  # real lock: guards graph + findings
        self._tls = threading.local()
        # site -> set of sites acquired while it was held
        self.edges: dict[str, set] = {}
        self.findings: list[dict] = []
        self._seen: set = set()
        # incremental JSONL emission: findings append to out_path the
        # moment they are recorded, NOT only at exit — a deadlock that
        # WEDGES the process (SIGKILLed by the CI timeout, atexit
        # never runs) still leaves its inversion evidence on disk
        self.out_path = out_path
        self._emitted = 0

    def _flush_locked(self, path: Optional[str]) -> None:
        """Append findings not yet written (caller holds self._lock)."""
        if not path or self._emitted >= len(self.findings):
            return
        fresh = self.findings[self._emitted:]
        self._emitted = len(self.findings)
        try:
            with open(path, "a", encoding="utf-8") as f:
                for ent in fresh:
                    f.write(json.dumps(ent) + "\n")
        except OSError:
            pass  # tracing must never take the process down

    # ------------------------------------------------------- factories

    def lock(self):
        return _TracedLock(self, _ORIG_LOCK(), _alloc_site())

    def rlock(self):
        return _TracedRLock(self, _ORIG_RLOCK(), _alloc_site())

    # ------------------------------------------------------- recording

    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquired(self, site: str) -> None:
        held = self._held()
        new_edges = [(h, site) for h in held
                     if h != site]  # same-site nesting is one node
        held.append(site)
        if not new_edges:
            return
        with self._lock:
            for a, b in new_edges:
                peers = self.edges.setdefault(a, set())
                if b in peers:
                    continue
                peers.add(b)
                # reverse REACHABILITY at edge-add time: b ->* a means
                # two threads can now interleave into a deadlock
                if self._reachable(b, a):
                    key = ("inversion",) + tuple(sorted((a, b)))
                    if key not in self._seen:
                        self._seen.add(key)
                        self.findings.append({
                            "kind": "inversion",
                            "detail": f"lock order inverted: {a} -> "
                                      f"{b} observed while a {b} -> "
                                      f"{a} path already exists "
                                      f"(thread "
                                      f"{threading.current_thread().name})",
                            "sites": sorted((a, b)),
                        })
                        self._flush_locked(self.out_path)

    def _reachable(self, src: str, dst: str) -> bool:
        seen = set()
        stack = [src]
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self.edges.get(cur, ()))
        return False

    def _note_released(self, site: str) -> None:
        held = self._held()
        # release order may not be LIFO: remove the newest matching
        for i in range(len(held) - 1, -1, -1):
            if held[i] == site:
                del held[i]
                return

    def note_blocking(self, what: str, where: str = "") -> None:
        """A blocking call is happening on this thread NOW; records a
        held-across-blocking event when any traced lock is held."""
        held = list(self._held())
        if not held:
            return
        key = ("held", what, tuple(held), where)
        with self._lock:
            if key in self._seen:
                return
            self._seen.add(key)
            self.findings.append({
                "kind": "held_across_blocking",
                "detail": f"{what} called at {where or '<unknown>'} "
                          f"while holding {held} (thread "
                          f"{threading.current_thread().name})",
                "sites": held,
            })
            self._flush_locked(self.out_path)

    # --------------------------------------------------------- results

    def report(self) -> list[dict]:
        """All findings, plus a fresh cycle search over the full order
        graph (catches A->B->C->A that no single edge-add flagged as a
        2-party inversion)."""
        with self._lock:
            out = list(self.findings)
            cycles = self._find_cycles()
            for cyc in cycles:
                key = ("cycle", tuple(cyc))
                if key not in self._seen:
                    self._seen.add(key)
                    ent = {"kind": "cycle",
                           "detail": "lock-order cycle: "
                                     + " -> ".join(cyc + [cyc[0]]),
                           "sites": cyc}
                    self.findings.append(ent)
                    out.append(ent)
            return out

    def _find_cycles(self) -> list[list[str]]:
        cycles: list[list[str]] = []
        seen_cycles: set = set()
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in self.edges}

        def dfs(node: str, path: list[str]) -> None:
            color[node] = GRAY
            path.append(node)
            for nxt in sorted(self.edges.get(node, ())):
                if color.get(nxt, WHITE) == GRAY:
                    i = path.index(nxt)
                    cyc = path[i:]
                    # canonical rotation so one cycle reports once
                    k = cyc.index(min(cyc))
                    canon = tuple(cyc[k:] + cyc[:k])
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        cycles.append(list(canon))
                elif color.get(nxt, WHITE) == WHITE:
                    dfs(nxt, path)
            path.pop()
            color[node] = BLACK

        for node in sorted(self.edges):
            if color.get(node, WHITE) == WHITE:
                dfs(node, [])
        return cycles

    def dump(self, path: Optional[str] = None) -> None:
        findings = self.report()
        if not findings:
            return
        path = path or self.out_path
        if path:
            with self._lock:
                self._flush_locked(path)  # whatever is not yet on disk
        else:
            sys.stderr.write("=== gatekeeper_tpu locktrace findings "
                             "===\n" + "".join(
                                 json.dumps(f) + "\n"
                                 for f in findings))


class _TracedLock:
    """threading.Lock wrapper recording acquisition order by the
    lock's allocation site."""

    __slots__ = ("_tracer", "_real", "site")

    def __init__(self, tracer: LockTracer, real, site: str):
        self._tracer = tracer
        self._real = real
        self.site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._real.acquire(blocking, timeout)
        if got:
            self._tracer._note_acquired(self.site)
        return got

    def release(self):
        self._real.release()
        self._tracer._note_released(self.site)

    def locked(self):
        return self._real.locked()

    def __getattr__(self, name):
        # pass-through for private protocol attrs the stdlib pokes at
        # (e.g. concurrent.futures registers _at_fork_reinit with
        # os.register_at_fork). Attrs the real lock lacks raise
        # naturally, so Condition's Lock-vs-RLock feature probing
        # still distinguishes the two.
        if name == "_real":  # slot unset mid-construction: no recursion
            raise AttributeError(name)
        return getattr(self._real, name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class _TracedRLock(_TracedLock):
    """RLock wrapper. Also implements the private Condition protocol
    (_release_save / _acquire_restore / _is_owned) so Condition.wait's
    full-release keeps the per-thread lockset honest."""

    __slots__ = ()

    def _release_save(self):
        state = self._real._release_save()
        self._tracer._note_released(self.site)
        return state

    def _acquire_restore(self, state):
        self._real._acquire_restore(state)
        self._tracer._note_acquired(self.site)

    def _is_owned(self):
        return self._real._is_owned()


# ------------------------------------------------------ global install

_TRACER: Optional[LockTracer] = None
_installed = False
_ATEXIT_REGISTERED = False


def tracer() -> Optional[LockTracer]:
    return _TRACER


def armed() -> bool:
    return os.environ.get(ENV, "") not in ("", "0", "false")


def note_blocking(what: str) -> None:
    """Hook for blocking-call wrappers (the patched time.sleep)."""
    t = _TRACER
    if t is not None:
        f = sys._getframe(2)
        t.note_blocking(what, f"{f.f_code.co_filename}:{f.f_lineno}"
                        if f else "")


def install(force: bool = False) -> Optional[LockTracer]:
    """Patch threading.Lock/RLock (and time.sleep) with tracing
    wrappers. No-op unless GATEKEEPER_TPU_LOCKTRACE=1 (or force).
    Locks created BEFORE install stay untraced — call early."""
    global _TRACER, _installed
    if _installed:
        return _TRACER
    if not (force or armed()):
        return None
    t = LockTracer(out_path=os.environ.get(OUT_ENV) or None)
    _TRACER = t
    _installed = True

    def make_lock():
        return _TracedLock(t, _ORIG_LOCK(), _alloc_site())

    def make_rlock():
        return _TracedRLock(t, _ORIG_RLOCK(), _alloc_site())

    threading.Lock = make_lock
    threading.RLock = make_rlock

    def traced_sleep(secs):
        note_blocking("time.sleep")
        return _ORIG_SLEEP(secs)

    time.sleep = traced_sleep
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        # once per process: the hook resolves the CURRENT tracer at
        # exit, so an uninstall/re-install cycle (tests) neither
        # stacks duplicate hooks nor dumps through a dead tracer
        _ATEXIT_REGISTERED = True
        atexit.register(
            lambda: _TRACER.dump() if _TRACER is not None else None)
    return t


def uninstall() -> None:
    """Restore the patched factories (tests)."""
    global _TRACER, _installed
    threading.Lock = _ORIG_LOCK
    threading.RLock = _ORIG_RLOCK
    time.sleep = _ORIG_SLEEP
    _TRACER = None
    _installed = False
